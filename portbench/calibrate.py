"""The readings a cell's limits are set from, at the cell's own size, on the
card, in one process: the program's check numbers over many seeds (a
window of one step each), the control's (the reference, its products one
precision lower, in the program's place) and two faults' over a few: half
of each batch left out, and a step that leaves the state unchanged.  The
benchmark's own runs never run this.

  python3 -m portbench.calibrate --workload <cell> --seeds 12 \
      --control-seeds 3 --fault-seeds 3 --out <file.json>
"""

import argparse
import gc
import json
import math
import sys

import torch

from . import harness, models


def readings(workload, seed, **kw):
    """The check's numbers, and each leaf's norms on both sides."""
    _, got = harness.run(workload, seed, 0.0, False, **kw)
    gc.collect()
    torch.cuda.empty_cache()
    return got["numbers"], {"program": got["program"],
                            "reference": got["reference"]}


# where a limit sits between its readings: this share of the way from the
# lower to the upper on a log scale, so more room lies above the lower
LIMIT_AT = 0.6


def limits_from(cal, keys=None):
    """{"limits", "readings"} from a calibration file's readings, of each
    of `keys` (by default every number the check gave: the whole model's
    and its model's `GRAD_GROUPS`): the lower reading is the largest of the
    program's seeds; the upper the smallest of the control's and of each
    fault's that reads ten times the lower or more (a state left unchanged:
    three times)."""
    out = {"limits": {}, "readings": {}}
    for key in keys or next(iter(cal["program"].values())):
        if not all(key in r for r in cal["program"].values()):
            continue
        lower = max(r[key] for r in cal["program"].values())
        candidates = {"control": min(r[key] for r in cal["control"].values())}
        half = min(r[key] for r in cal["half_batch"].values())
        if half >= 10 * lower:
            candidates["half_batch"] = half
        unchanged = min(r[key] for r in cal["unchanged"].values())
        if unchanged >= 3 * lower:
            candidates["unchanged"] = unchanged
        ok = {k: v for k, v in candidates.items() if v >= 3 * lower}
        upper_by = min(ok, key=ok.get) if ok else None
        upper = ok[upper_by] if ok else None
        limit = None if upper is None else math.exp(
            math.log(lower) + LIMIT_AT * (math.log(upper) - math.log(lower)))
        out["limits"][key] = limit
        out["readings"][key] = {"lower": lower, "upper": upper,
                                "upper_from": upper_by,
                                "candidates": candidates}
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--fault-seeds", type=int, default=3)
    parser.add_argument("--first-seed", type=int, default=2_000_000_011)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    _, cfg, job, _, _ = harness.load_cell(args.workload)
    model = models.load(cfg)
    seeds = [args.first_seed + 7_919 * i for i in range(args.seeds)]
    out = {"workload": args.workload,
           "card": torch.cuda.get_device_name(0), "program": {},
           "control": {}, "half_batch": {}, "unchanged": {},
           "control_products": job["control_products"],
           "names": model.trainable_names(cfg, job,
                                          model.modalities(cfg, job)),
           "leaves": {}}

    def save():
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)

    def record(kind, s, **kw):
        out[kind][s], out["leaves"].setdefault(kind, {})[s] = readings(
            args.workload, s, **kw)
        print(kind, s, out[kind][s], flush=True)
        save()

    for s in seeds:
        record("program", s)
    for s in seeds[:args.control_seeds]:
        record("control", s, reference_products=job["control_products"])
    for fault in ("half_batch", "unchanged"):
        for s in seeds[:args.fault_seeds]:
            record(fault, s, faults=(fault,))
    return 0


if __name__ == "__main__":
    sys.exit(main())
