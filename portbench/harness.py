"""One run of one benchmark cell: a training job of the port, driven through
its own trainer, timed, traced on request, and checked against the plain
reference.

What a run does, in order:

1. set-up (`setup_s`, from process start to the window's first batch):
   the kernels are built (the first run in a checkout) or found; the
   weights and a pool of host batches in pinned memory are made from the
   seed; the trainer is built through the port's training entry by the
   model the configuration names (`models/<model>.py`) and loaded with the
   weights; it trains its first three steps, each through
   `Trainer.train_epoch` on distinct batches of the pool, from a dropout
   stream seeded by the run's seed: an epoch of one batch, whose
   optimizer state gives the first gradient, then an epoch of two, after
   which each parameter's change is read.  Those steps also compile and
   warm every shape the window uses;
2. the window: one `Trainer.train_epoch` over the pool in turn until
   `--seconds` have passed since its first batch; it closes when the epoch
   returns, after its one readback.  A CUDA event marks each step's start
   on the card and a host span times each `train_step` call; with
   `--trace 1`, `torch.profiler` records the card's kernels;
3. the output check: the program's state is freed, and the plain
   reference (`reference/`) trains the same three steps from the same
   weights, batches and draws.  Each step's loss, each leaf's first
   gradient (from Adam's first moment after one step) and each leaf's
   change after three steps are compared by the worst leaf, the first
   gradient also by the worst leaf of each of the model's groups
   (`GRAD_GROUPS`), with the limits of the cell (`limits/<cell>.json`).
"""

import gc
import importlib
import json
import math
import os
import shutil
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional



def _process_start() -> float:
    """The wall-clock time this process started (from /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


PROCESS_START = _process_start()

import torch  # noqa: E402

from . import inputs, models  # noqa: E402
from .yardstick import families  # noqa: E402
from .yardstick import launches as L  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "multimodalaggressionrecognition_tpu")
ADAM_B1 = 0.9
# a leaf whose reference gradient is under this share of the median leaf's
# is nought to rounding (a key's bias under softmax): Adam moves it by
# round-off alone, so its change is not compared
NOUGHT = 1e-3


class BenchmarkError(RuntimeError):
    """A run that cannot give a result."""


# ------------------------------------------------------------ the manifest
def load_cell(name: str):
    """(workload entry, configuration dict, job dict, limits dict or None,
    manifest) of cell `name`."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise BenchmarkError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    with open(os.path.join(ROOT, config["file"])) as f:
        cfg = json.load(f)
    if "model" not in cfg:
        raise BenchmarkError(f"{config['file']} names no model")
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        job = json.load(f)
    limits_path = os.path.join(HERE, "limits", name + ".json")
    limits = None
    if os.path.isfile(limits_path):
        with open(limits_path) as f:
            limits = json.load(f)
    return cell, cfg, job, limits, manifest


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


# ------------------------------------------------------------ the record
@dataclass
class RunRecord:
    """What the metric readers (`metrics/<name>.py`) read."""
    cell: str
    cfg: dict
    job: dict
    card: str
    setup_s: float = 0.0
    setup_marks: Dict[str, float] = field(default_factory=dict)
    steps: int = 0
    clips: int = 0
    window_s: float = 0.0
    peak_mem_bytes: int = 0
    resident_bytes: int = 0  # allocated when the window opens
    step_intervals_ms: List[float] = field(default_factory=list)
    host_spans_s: List[float] = field(default_factory=list)
    launches_per_step: Dict[str, float] = field(default_factory=dict)
    kernels: Optional[list] = None  # [(name, start_ns, duration_ns)]
    busy_s: Optional[float] = None
    flops_per_step: Optional[float] = None


class StepRecorder:
    """Wraps `trainer.train_step`: a CUDA event at each step's start, a
    host span around the call, and the step's loss."""

    def __init__(self, trainer, cuda: bool):
        self.inner = trainer.train_step
        self.cuda = cuda
        self.events, self.spans, self.losses = [], [], []
        trainer.train_step = self

    def reset(self):
        self.events, self.spans, self.losses = [], [], []

    def __call__(self, batch):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.events.append(event)
        t = time.perf_counter()
        out = self.inner(batch)
        self.spans.append(time.perf_counter() - t)
        self.losses.append(out["total_loss"].detach())
        return out


class PoolLoader:
    """The train loader: the pool's batches as numpy arrays over its pinned
    memory, in turn from `start`, `count` of them or, with `seconds`, until
    that long has passed since the first was yielded."""

    def __init__(self, pool, start: int = 0, count: Optional[int] = None,
                 seconds: Optional[float] = None):
        self.pool = [inputs.as_numpy(b) for b in pool]
        self.start, self.count, self.seconds = start, count, seconds
        self.opened = None

    def __iter__(self):
        i = 0
        while True:
            if self.count is not None and i >= self.count:
                return
            now = time.perf_counter()
            if i == 0:
                self.opened = now
            elif self.seconds is not None and now - self.opened >= self.seconds:
                return
            yield self.pool[(self.start + i) % len(self.pool)]
            i += 1


# ------------------------------------------------------------ the program
def first_gradient_norms(trainer, names):
    """Each leaf's first gradient as Adam got it, from its first moment
    after one step (m = (1 - b1) g); a leaf without state reads 0."""
    params = dict(trainer.state.model.named_parameters())
    state = trainer.state.optimizer.inner.state
    out = []
    for n in names:
        m = state.get(params[n], {}).get("exp_avg")
        out.append(0.0 if m is None else float(
            torch.linalg.vector_norm(m.double()) / (1 - ADAM_B1)))
    return out


def change_norms(current: Dict[str, torch.Tensor], initial, names):
    return [float(torch.linalg.vector_norm(
        current[n].detach().double() - initial[n].double())) for n in names]


# ------------------------------------------------------------ the check
def leaf_gaps(program, reference, keep=None):
    """Each kept leaf's |program - reference| / max(reference, median
    reference)."""
    ref_kept = [r for i, r in enumerate(reference) if keep is None or keep[i]]
    median = statistics.median(ref_kept) if ref_kept else 0.0
    gaps = []
    for i, (p, r) in enumerate(zip(program, reference)):
        if keep is not None and not keep[i]:
            continue
        scale = max(r, median)
        gap = abs(p - r) / scale if scale > 0 else (0.0 if p == 0 else math.inf)
        gaps.append(gap if math.isfinite(p) else math.inf)
    return gaps


def compare(program, reference, names, groups):
    """The output check's numbers, from the two sides' readings {losses,
    grad_norms, change_norms} of the leaves `names`: each step's loss by
    the worst step and the first step's alone; the first gradient's norm by
    the worst leaf, and by the worst leaf of each group of `groups` ({key:
    leaf-name prefix}) that trains; the change's norm by the worst leaf.  A
    leaf whose reference gradient is nought to rounding is left out of the
    change."""
    losses = [abs(p - r) / abs(r) if math.isfinite(p) else math.inf
              for p, r in zip(program["losses"], reference["losses"])]
    grads = reference["grad_norms"]
    median = statistics.median(grads) if grads else 0.0
    keep = [g >= NOUGHT * median for g in grads]
    grad = leaf_gaps(program["grad_norms"], grads)
    change = leaf_gaps(program["change_norms"], reference["change_norms"],
                       keep)
    out = {"loss_gap": max(losses), "loss1_gap": losses[0],
           "grad_gap": max(grad), "change_gap": max(change)}
    for key, prefix in groups.items():
        group = [g for n, g in zip(names, grad) if n.startswith(prefix)]
        if group:
            out[key] = max(group)
    return out


def reference_readings(model, cfg, job, modalities, seed, pool, device,
                       names, products=None, steps=3):
    """The reference's readings over the first `steps` steps: losses, each
    leaf's first gradient and each leaf's change after the last step."""
    weights = inputs.make_weights(model.parameter_spec(cfg, modalities), seed,
                                  device)
    ref = model.reference_trainer(weights, cfg, job, modalities, products)
    g = inputs.draws_generator(seed, device)
    losses, grad_norms = [], None
    for i in range(steps):
        batch = inputs.to_device(pool[i % len(pool)], device)
        masks = model.draw_masks(g, cfg, job, modalities, device)
        loss, grads = ref.step(batch, masks)
        losses.append(float(loss))
        if i == 0:
            grad_norms = [float(torch.linalg.vector_norm(grads[n].double()))
                          if n in grads else 0.0 for n in names]
        del batch, masks, grads
    changes = change_norms(ref.params, weights, names)
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": changes}


# ------------------------------------------------------------ the run
def run(workload: str, seed: int, seconds: float, trace: bool,
        device: Optional[str] = None, faults=(),
        overrides: Optional[dict] = None, reference_products=None):
    """One run; returns (the result the benchmark prints, the readings it
    prints before it: the check's numbers and both sides' readings, the
    launches per step, the window).  `device`
    None takes the card (and fails without one); tests pass "cpu" with
    small `overrides` of the configuration and the job, and `faults` that
    break the timed path underneath: "unchanged" (the optimizer step leaves
    the state as it was) or "half_batch" (half of each batch left out, the
    mean taken over the rest).  `reference_products` puts the reference,
    its products in that precision, in the program's place: the control."""
    cell, cfg, job, limits, manifest = load_cell(workload)
    overrides = overrides or {}
    cfg = {**cfg, **overrides.get("config", {})}
    job = {**job, **overrides.get("job", {})}
    model = models.load(cfg)
    modalities = model.modalities(cfg, job)
    heads = model.heads(cfg, job)
    device = torch.device(device or "cuda")
    cuda = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 as stated
    torch.backends.cudnn.allow_tf32 = False
    card = torch.cuda.get_device_name(device) if cuda else "cpu"

    from multimodalaggressionrecognition_tpu_torch.utils import kernels

    rec = RunRecord(cell=workload, cfg=cfg, job=job, card=card)
    rec.setup_marks["imports"] = time.time() - PROCESS_START
    if cuda:
        kernels.build_all()
    rec.setup_marks["kernels"] = time.time() - PROCESS_START
    run_root = tempfile.mkdtemp(prefix="portbench-")
    pool = inputs.make_pool(
        seed, job["pool_batches"], device,
        lambda g: model.make_batch(g, cfg, modalities, job["batch_size"],
                                   heads, device))
    rec.setup_marks["pool"] = time.time() - PROCESS_START
    cfg.update(model.pool_config(pool, heads))
    try:
        if reference_products is not None:
            names = model.trainable_names(cfg, job, modalities)
            program = reference_readings(model, cfg, job, modalities, seed,
                                         pool, device, names,
                                         products=reference_products)
            window = None
        else:
            program, names, window = _program_run(
                rec, model, cfg, job, modalities, seed, seconds, trace, pool,
                device, run_root, faults)
        if forbidden_modules():
            raise BenchmarkError("loaded after the window: "
                                 + ", ".join(forbidden_modules()))
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        reference = reference_readings(model, cfg, job, modalities, seed,
                                       pool, device, names,
                                       products=job["reference_products"])
    finally:
        shutil.rmtree(run_root, ignore_errors=True)
    numbers = compare(program, reference, names, model.GRAD_GROUPS)
    return _result(manifest, rec, cell, numbers, limits, window, trace,
                   program, reference)


def _program_run(rec, model, cfg, job, modalities, seed, seconds, trace,
                 pool, device, run_root, faults):
    from multimodalaggressionrecognition_tpu_torch.utils import kernels

    cuda = device.type == "cuda"
    spec = model.parameter_spec(cfg, modalities)
    weights = inputs.make_weights(spec, seed, device)
    trainer = model.build_trainer(cfg, job, modalities, weights, device,
                                  run_root)
    del weights
    rec.setup_marks["trainer"] = time.time() - PROCESS_START
    _plant(trainer, faults)
    names = [n for n, p in trainer.model.named_parameters() if p.requires_grad]
    recorder = StepRecorder(trainer, cuda)
    g = inputs.draws_generator(seed, device)
    steps = job["check_steps"]
    trainer.train_loader = PoolLoader(pool, start=0, count=1)
    trainer.train_epoch(g)
    grad_norms = first_gradient_norms(trainer, names)
    trainer.train_loader = PoolLoader(pool, start=1, count=steps - 1)
    trainer.train_epoch(g)
    initial = inputs.make_weights(spec, seed, device)
    changes = change_norms(dict(trainer.model.named_parameters()), initial,
                           names)
    del initial
    losses = [float(x) for x in recorder.losses]
    program = {"losses": losses, "grad_norms": grad_norms,
               "change_norms": changes}

    # the window
    recorder.reset()
    trainer.train_loader = PoolLoader(pool, start=steps, seconds=seconds)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        rec.resident_bytes = torch.cuda.memory_allocated(device)
    counts_before = dict(kernels.launch_counts)
    profiler = _profiler() if trace else None
    rec.setup_s = time.time() - PROCESS_START
    # the window closes at the epoch's readback; a traced one is timed
    # inside the trace, the profiler's start and stop (no kernel runs in
    # them) outside it, and waits for the card so that every kernel it
    # traced lies in it
    if profiler is not None:
        profiler.start()
    t0 = time.perf_counter()
    trainer.train_epoch(g)
    if profiler is not None and cuda:
        torch.cuda.synchronize(device)
    rec.window_s = time.perf_counter() - t0
    if profiler is not None:
        profiler.stop()
    rec.steps = len(recorder.spans)
    rec.clips = rec.steps * job["batch_size"]
    rec.host_spans_s = list(recorder.spans)
    if cuda:
        rec.peak_mem_bytes = torch.cuda.max_memory_allocated(device)
        ev = recorder.events
        rec.step_intervals_ms = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
    rec.launches_per_step = {
        k: (kernels.launch_counts[k] - counts_before.get(k, 0)) / max(rec.steps, 1)
        for k in kernels.launch_counts
        if kernels.launch_counts[k] != counts_before.get(k, 0)}
    window = {"losses": [float(x) for x in recorder.losses]}
    if profiler is not None:
        rec.kernels = _kernel_events(profiler)
        rec.busy_s = _union_s(rec.kernels)
        from .yardstick.flops import step_flops

        rec.flops_per_step = step_flops(cfg, job)
    del trainer, recorder
    return program, names, window


def _plant(trainer, faults):
    """Break the timed path underneath, for the tests of the check."""
    for fault in faults:
        if fault == "unchanged":
            trainer.init_state()
            trainer.state.optimizer.step = lambda: True
        elif fault == "half_batch":
            inner = trainer.train_step

            def half(batch, inner=inner):
                rows = batch["sample_mask"].shape[0] // 2
                return inner(inputs.tree_map(lambda t: t[:rows], batch))
            trainer.train_step = half
        else:
            raise ValueError(f"unknown fault {fault!r}")


def _profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def _kernel_events(prof):
    """[(name, start_ns, duration_ns)] of the card's kernels in the trace,
    sorted by start."""
    out = [(e.name(), e.start_ns(), e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA
           and not families.is_transfer(e.name())]
    out.sort(key=lambda k: k[1])
    return out


def _union_s(kernels):
    """Seconds in which at least one kernel ran."""
    busy, end = 0, None
    for _, start, dur in kernels:
        stop = start + dur
        if end is None or start >= end:
            busy += dur
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy / 1e9


def _short(name: str) -> str:
    """A kernel's name without the namespaces and qualifiers that every
    library kernel shares."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::",
                  "at::cuda::", "std::"):
        name = name.replace(noise, "")
    return name[:96]


def breakdown(kernels, family=families.family):
    """The kernels that took most time, and the longest idle stretches on
    the card, summed by the kernel that ended each (labelled with its
    `family`)."""
    from collections import defaultdict

    by_name = defaultdict(int)
    for name, _, dur in kernels:
        by_name[_short(name)] += dur
    gaps = defaultdict(int)
    end, last = None, "window start"
    for name, start, dur in kernels:
        if end is not None and start > end:
            gaps[f"after {family(last)}: {_short(last)}"] += start - end
        if end is None or start + dur > end:
            end, last = start + dur, name
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v / 1e9] for k, v in top],
            "idle_gaps": [[k, v / 1e9] for k, v in idle]}


# ------------------------------------------------------------ the result
def metric_names(manifest, cell: str, section: str):
    """The cell's metrics of `section` ("end_to_end" or "per_layer")."""
    return [m for m in manifest[section]
            if "workloads" not in m or cell in m["workloads"]]


def read_metric(name: str, rec: RunRecord):
    module = importlib.import_module(f"portbench.metrics.{name}")
    return module.read(rec)


def _result(manifest, rec, cell, numbers, limits, window, trace, program,
            reference):
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metric_names(manifest, cell["name"], section):
        value = read_metric(m["name"], rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # the numbers the cell's limits compare (the others are printed with
    # the readings): each beside its limit
    correct = limits is not None
    checks = {}
    for key in (limits or {}).get("compared", []):
        value, limit = numbers[key], limits["limits"][key]
        checks[key] = {"value": value, "limit": limit}
        correct = correct and math.isfinite(value) and value <= limit
    failed = 0
    if window is not None:
        failed = sum(1 for x in window["losses"] if not math.isfinite(x))
    correct = correct and failed == 0
    device = {"platform": "gpu" if rec.card != "cpu" else "cpu",
              "kind": rec.card,
              "count": 1,
              "memory_peak_bytes": rec.peak_mem_bytes}
    if trace:
        device["busy_s"] = rec.busy_s
        device["window_s"] = rec.window_s
    out = {"correct": correct, "attempted": rec.steps, "failed": failed,
           "metrics": metrics, "device": device}
    if trace and rec.kernels is not None:
        out["breakdown"] = breakdown(rec.kernels, models.family_of(rec.cfg))
    out["checks"] = checks
    readings = {"numbers": numbers, "program": program,
                "reference": reference,
                "launches_per_step": rec.launches_per_step,
                "expected_launches_per_step": L.expected_counts(rec.cfg,
                                                                rec.job),
                "steps": rec.steps, "window_s": rec.window_s,
                "setup_s": rec.setup_s, "setup_marks_s": rec.setup_marks,
                "step_ms_halves": _halves(rec.step_intervals_ms),
                "kernel_span_s": _span_s(rec.kernels)}
    return out, readings


def _halves(intervals):
    """The mean step interval over each half of the window."""
    h = len(intervals) // 2
    return [statistics.fmean(intervals[:h]), statistics.fmean(intervals[h:])] \
        if h else None


def _span_s(kernels):
    """Seconds from the first traced kernel's start to the last one's end."""
    if not kernels:
        return None
    return (max(s + d for _, s, d in kernels) - kernels[0][1]) / 1e9
