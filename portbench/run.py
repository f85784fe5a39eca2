"""The benchmark's command: one run of one cell.

  python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

Prints, before its last line, the launches of the port's kernels per step
by kernel and dtype and the check's readings; as the last lines on
standard error each number compared beside its limit; and as the last line
on standard output one JSON object (`correct`, `attempted`, `failed`,
`metrics`, `device`, with `--trace 1` `breakdown`, and last `checks`).
Without a card, or with fewer than the cell asks for, it prints no result
and exits 3; a run that loads JAX or the JAX package exits 4."""

import argparse
import json
import os
import sys

from . import harness


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    cell = harness.load_cell(args.workload)[0]

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, readings = harness.run(args.workload, args.seed, args.seconds,
                                   bool(args.trace))
    loaded = harness.forbidden_modules()
    if loaded:
        print("portbench: JAX or the JAX package was loaded: "
              + ", ".join(loaded), file=sys.stderr)
        return 4
    print("launches per step: " + json.dumps(readings["launches_per_step"],
                                             sort_keys=True), flush=True)
    print("readings: " + json.dumps(readings), flush=True)
    for key, c in result["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
