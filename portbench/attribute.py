"""A traced run of one cell that keeps its trace, and reads from it, with
the program's recording of the window (`utils/profiling.py`), what the
result line does not carry:

  python3 -m portbench.attribute --workload <cell> --seed <n> --seconds <s>

Prints the run's result line, then one JSON line: the recording's means a
step (each span's host ms, each device phase's and backward segment's card
ms, the card ms between steps, the allocator's counts); the sums the phases
should match; from the trace, the launch queue by correlation id (each
kernel's start less its launch call's), the share of the window's launch
calls inside a program span, the idle gaps on the card labelled by what
the host was doing, and, after the run, the recorder's clock against the
trace's.  Exits 3 without a card, 1 where the harness's trace was not
caught.
"""

import argparse
import bisect
import json
import os
import statistics
import sys
from collections import defaultdict

COPY_SLACK_NS = 50_000  # a gap that ends this near an H2D copy's end waits on it


def trace_events(prof):
    """(kernels [(name, start, duration, correlation)], calls [(name, start,
    correlation)] of the CUDA API (`cuda*`, `cu*`), H2D copies from pinned
    memory, the batches' [(start, end)]) of a finished profiler, each
    sorted by start."""
    import torch

    from .yardstick.families import is_transfer

    kernels, calls, copies = [], [], []
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not is_transfer(name):
                kernels.append((name, start, e.duration_ns(),
                                e.correlation_id()))
            elif "HtoD" in name and "Pinned" in name:
                copies.append((start, start + e.duration_ns()))
        elif name.startswith("cu"):
            calls.append((name, start, e.correlation_id()))
    kernels.sort(key=lambda k: k[1])
    calls.sort(key=lambda c: c[1])
    copies.sort()
    return kernels, calls, copies


def launch_calls(kernels, calls):
    """{correlation: call} of the calls that launched `kernels`."""
    wanted = {k[3] for k in kernels}
    return {c[2]: c for c in calls if c[2] in wanted}


def launch_queue_ms(kernels, calls):
    """The median over the kernels of (kernel start - its launch call's
    start), ms; None without a matched launch."""
    by_corr = launch_calls(kernels, calls)
    lags = [k[1] - by_corr[k[3]][1] for k in kernels if k[3] in by_corr]
    return statistics.median(lags) / 1e6 if lags else None


def innermost(spans, times):
    """For each time, the name of the innermost of `spans` [(name, start,
    end)], nested (the trainer thread's), that holds it, else None.  The
    trainer's thread is the one to look on: the autograd engine's thread
    runs the backward while it waits in `step.backward`, and the pin
    threads launch nothing."""
    edges = sorted([(start, 1, name) for name, start, _ in spans]
                   + [(end, 0, name) for name, _, end in spans])
    out = [None] * len(times)
    stack, j = [], 0
    for t, i in sorted((t, i) for i, t in enumerate(times)):
        while j < len(edges) and edges[j][0] <= t:
            if edges[j][1]:
                stack.append(edges[j][2])
            elif stack:
                stack.pop()
            j += 1
        out[i] = stack[-1] if stack else None
    return out


def label_gaps(kernels, calls, spans, copies):
    """{label: idle ns} of the gaps between the card's kernels.  The kernel
    that ends a gap was launched during it (the host was late): the label
    is the innermost program span holding the launch ("host: <span>"); or
    before it (the card waited): "wait: batch copy" where an H2D copy ended
    within 50 us of the gap's end, else "wait: other".  The family of the
    kernel before the gap follows the label."""
    from .yardstick.families import family

    by_corr = launch_calls(kernels, calls)
    ends = sorted(e for _, e in copies)
    late = []  # (gap ns, kernel before, launch time)
    gaps = defaultdict(int)
    end, last = None, None
    for name, start, dur, corr in kernels:
        if end is not None and start > end:
            call = by_corr.get(corr)
            if call is not None and call[1] > end:
                late.append((start - end, last, call[1]))
            else:
                i = bisect.bisect_left(ends, start - COPY_SLACK_NS)
                near = i < len(ends) and ends[i] <= start + COPY_SLACK_NS
                label = "wait: batch copy" if near else "wait: other"
                gaps[f"{label}; after {family(last)}"] += start - end
        if end is None or start + dur > end:
            end, last = start + dur, name
    where = innermost(spans, [t for _, _, t in late])
    for (gap, before, _), span in zip(late, where):
        gaps[f"host: {span}; after {family(before)}"] += gap
    return dict(gaps)


def outside_spans(launched, spans):
    """(the share of `launched` [(kernel, launch call's start)] inside one
    of `spans`, {kernel: launches outside every span})."""
    outside = defaultdict(int)
    for (name, _), w in zip(launched, innermost(spans,
                                                [t for _, t in launched])):
        if w is None:
            outside[name] += 1
    return 1 - sum(outside.values()) / max(len(launched), 1), dict(outside)


def clock_offsets_us(n=200):
    """The trace's clock less the recorder's (`time.time_ns`), us, with
    nothing else running: `n` times, a reading and at once a
    `record_function` range, then a reading and a CUDA event's record.
    {"cpu_range": (median, least), "cuda_call": (median, least)}: the
    least bounds the offset from above, the Python between them included."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    stamps = []
    with profile(activities=activities) as prof:
        for i in range(n):
            t = time.time_ns()
            with record_function(f"clock.{i}"):
                pass
            t2 = time.time_ns()
            if cuda:
                torch.cuda.Event().record()
            stamps.append((t, t2))
    starts, records = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("clock."):
            starts[e.name()] = e.start_ns()
        elif e.name().startswith("cudaEventRecord"):
            records.append(e.start_ns())
    records.sort()
    out = {"cpu_range": [(starts[f"clock.{i}"] - t) / 1e3
                         for i, (t, _) in enumerate(stamps)]}
    if cuda and len(records) == n:
        out["cuda_call"] = [(r - t2) / 1e3
                            for r, (_, t2) in zip(records, stamps)]
    return {k: (statistics.median(v), min(v)) for k, v in out.items()}


def phase_sums(summary, step_interval_ms):
    """The device phases against the step they partition: (phases summed,
    the `step` phase, phases + the card ms between steps, the harness's
    mean step interval); ms a step."""
    dev = summary["device_ms"]
    phases = sum(v for k, v in dev.items() if k != "step"
                 and k != "step.backward")
    between = summary["between_steps_ms"] or 0.0
    return {"phases_ms": phases, "step_ms": dev.get("step"),
            "phases_and_between_ms": phases + between,
            "step_interval_ms": step_interval_ms}


def analyse(rec, prof, result, readings):
    """The JSON this tool prints, from the program's recording `rec`, the
    harness's finished profiler, its result and readings."""
    kernels, calls, copies = trace_events(prof)
    main = next(s.thread for s in rec.spans if s.name == "step")
    spans = [(s.name, s.start_ns, s.end_ns) for s in rec.spans
             if s.thread == main and s.end_ns is not None]
    summary = rec.summary()
    t0, t1 = min(s[1] for s in spans), max(s[2] for s in spans)
    by_corr = launch_calls(kernels, calls)
    launched = [(k[0], by_corr[k[3]][1]) for k in kernels
                if k[3] in by_corr and t0 <= by_corr[k[3]][1] <= t1]
    inside, outside = outside_spans(launched, spans)
    host = summary["host_ms"]
    halves = readings.get("step_ms_halves")
    gaps = label_gaps(kernels, calls, spans, copies)
    idle = sum(gaps.values())
    return {
        "metrics": {k: v["value"] for k, v in result["metrics"].items()},
        "summary": summary,
        "host_sum_ms": sum(host.get(n, 0.0) for n in (
            "step.forward", "step.loss", "step.backward", "step.optimizer")),
        "device_sums": phase_sums(
            summary, statistics.fmean(halves) if halves else None),
        "launch_queue_ms_by_correlation": launch_queue_ms(kernels, calls),
        "kernels": len(kernels), "launches_in_window": len(launched),
        "launch_calls_in_spans": inside,
        "launched_outside_spans": sorted(
            ([k[:80], n] for k, n in outside.items()),
            key=lambda kn: -kn[1])[:8],
        "clock_offset_us": clock_offsets_us(),
        "idle_gaps_s": sorted(([k, v / 1e9] for k, v in gaps.items()),
                              key=lambda kv: -kv[1]),
        "idle_labelled_share": sum(
            v for k, v in gaps.items()
            if not k.startswith("host: None")) / idle if idle else None,
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from . import harness

    if not torch.cuda.is_available():
        print("portbench.attribute: no CUDA device", file=sys.stderr)
        return 3
    kept = {}
    events = harness._kernel_events

    # the harness keeps no handle on its profiler: take it where the
    # harness reads the trace (`trace_events` and `label_gaps` belong in
    # `harness.py`'s `RunRecord` and `breakdown`, once the harness keeps
    # the trace's launch calls)
    def keep(prof):
        kept["prof"] = prof
        return events(prof)

    harness._kernel_events = keep
    result, readings = harness.run(args.workload, args.seed, args.seconds,
                                   True)
    if "prof" not in kept:
        print("portbench.attribute: the harness no longer reads its trace "
              "through _kernel_events", file=sys.stderr)
        return 1
    from multimodalaggressionrecognition_tpu_torch.utils import profiling

    print(json.dumps(result), flush=True)
    print(json.dumps(analyse(profiling.last_recording(), kept["prof"],
                             result, readings)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
