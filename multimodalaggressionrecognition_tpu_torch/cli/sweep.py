"""Hyperparameter sweep: a grid of runs + a ranked summary table
(the JAX package's cli/sweep.py).

One command expands a cartesian grid over any config fields, runs each
point through the chosen train entry into its own stable run directory
(`--run_name <slug>`: an interrupted sweep resumes, finished points are
skipped by their completion marker), and ranks the finished points by
their best test metric (show_results' selection rule).

  python -m multimodalaggressionrecognition_tpu_torch.cli.sweep \
      --entry train_text_transformer \
      --grid learning_rate=1e-3,3e-4 --grid num_layers=1,2 \
      -- --dataset_root data/avabos --epoch_num 20 --saving_dir runs/sweep

Everything after `--` is passed verbatim to every run.  Writes
<saving_dir>/sweep_summary.csv and prints the ranked table.  A point whose
run was preempted (SIGTERM: its trainer left a `checkpoint_preempt` and
returned) stops the sweep unmarked, so a relaunch resumes that point.
"""

import argparse
import importlib
import itertools
import json
import os

from .common import flag_value
from .show_results import best_rows

_ENTRIES = ("train_text_transformer", "train_audio_rnn", "train_video_rnn",
            "train_audio_transformer", "train_video_transformer",
            "train_audio_text", "train3dcnn", "train_multimodal")


def parse_grid(specs):
    """['lr=a,b', 'bs=1,2'] -> ordered {key: [values]} (strings; the entry
    CLI's own parser handles typing)."""
    grid = {}
    for spec in specs:
        if "=" not in spec:
            raise SystemExit(f"--grid expects key=v1,v2,... (got {spec!r})")
        key, _, values = spec.partition("=")
        vals = [v for v in values.split(",") if v]
        if not vals:
            raise SystemExit(f"--grid {key}: no values")
        grid[key.strip()] = vals
    return grid


def grid_points(grid):
    """Cartesian product -> [(slug, {key: value})], slug is the run_name."""
    keys = list(grid)
    points = []
    for combo in itertools.product(*(grid[k] for k in keys)):
        kv = dict(zip(keys, combo))
        slug = "_".join(f"{k}-{v}" for k, v in kv.items()) or "single"
        points.append((slug.replace("/", "-"), kv))
    return points


_DONE_MARKER = "sweep_done.json"


def _finished(run_dir):
    """A point is done iff the sweep's completion marker exists (the
    epoch count alone cannot tell a stopped run from an interrupted one)."""
    return os.path.isfile(os.path.join(run_dir, _DONE_MARKER))


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--entry", required=True, choices=_ENTRIES,
                   help="which train CLI to sweep")
    p.add_argument("--grid", action="append", default=[],
                   metavar="KEY=V1,V2", help="repeatable grid axis")
    p.add_argument("--metric", default="UAR",
                   help="ranking metric (best test-split value per run)")
    p.add_argument("args", nargs=argparse.REMAINDER,
                   help="-- then args passed to every run")
    ns = p.parse_args(argv)
    passthrough = [a for a in ns.args if a != "--"]

    entry = importlib.import_module(f".{ns.entry}", package=__package__)
    saving_dir = flag_value(passthrough, "saving_dir", "runs")
    points = grid_points(parse_grid(ns.grid))

    preempted = False
    for slug, kv in points:
        run_dir = os.path.join(saving_dir, slug)
        if _finished(run_dir):
            print(json.dumps({"sweep": slug, "status": "already done"}),
                  flush=True)
            continue
        print(json.dumps({"sweep": slug, "point": kv}), flush=True)
        args = list(passthrough) + ["--run_name", slug]
        for k, v in kv.items():
            args += [f"--{k}", v]
        entry.main(args)
        if os.path.exists(os.path.join(run_dir, "checkpoint_preempt")):
            # a preempted run is not done: no marker (a relaunched sweep
            # resumes it through --run_name), and no next point
            print(json.dumps({"sweep": slug, "status": "preempted"}),
                  flush=True)
            preempted = True
            break
        with open(os.path.join(run_dir, _DONE_MARKER), "w") as f:
            json.dump({"point": kv}, f)

    table = best_rows(saving_dir, metric=ns.metric, split="test")
    # rank only this sweep's finished points: saving_dir may hold other
    # runs, and an unfinished run's best-so-far is not a result
    slugs = {slug for slug, _ in points
             if _finished(os.path.join(saving_dir, slug))}
    if preempted and not slugs:
        print(json.dumps({"sweep_summary": None, "status": "preempted"}),
              flush=True)
        return None
    if not table.empty:
        table = table[table["run"].isin(slugs)]
    if table.empty:
        print("no results")
        return table
    table = table.sort_values(ns.metric, ascending=False)
    out = os.path.join(saving_dir, "sweep_summary.csv")
    table.to_csv(out, index=False)
    print(table.to_string(index=False))
    print(json.dumps({"sweep_summary": out}), flush=True)
    return table


if __name__ == "__main__":
    main()
