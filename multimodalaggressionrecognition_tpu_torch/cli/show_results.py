"""Training-log analysis (the JAX package's cli/show_results.py).

Scans run directories for per-head CSV logs, reports the best epoch per run
and head by a chosen metric (default UAR, the reference's model-selection
rule), and prints a summary table.

  python -m multimodalaggressionrecognition_tpu_torch.cli.show_results \
      --saving_dir runs
"""

import argparse
import glob
import os

import numpy as np
import pandas as pd


def best_rows(saving_dir: str, metric: str = "UAR", split: str = "test"):
    rows = []
    for log_path in sorted(glob.glob(
            os.path.join(saving_dir, "*", f"*_{split}_log.csv"))):
        run = os.path.basename(os.path.dirname(log_path))
        head = os.path.basename(log_path).replace(f"_{split}_log.csv", "")
        df = pd.read_csv(log_path)
        if metric not in df.columns or df.empty:
            continue
        i = int(np.argmax(df[metric].to_numpy()))
        rows.append({
            "run": run, "head": head, "best_epoch": int(df["epoch"].iloc[i]),
            metric: float(df[metric].iloc[i]),
            "loss": float(df["loss"].iloc[i]),
            "accuracy": float(df["accuracy"].iloc[i]),
        })
    return pd.DataFrame(rows)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--saving_dir", default="runs")
    p.add_argument("--metric", default="UAR")
    p.add_argument("--split", default="test")
    args = p.parse_args(argv)
    table = best_rows(args.saving_dir, args.metric, args.split)
    if table.empty:
        print("no logs found")
    else:
        print(table.to_string(index=False))
    return table


if __name__ == "__main__":
    main()
