"""`dryrun_multichip(n)`: the twin of the JAX package's multi-chip dry run
(`__graft_entry__.dryrun_multichip`).

It spawns n gloo ranks on the CPU, each its own interpreter, rendezvousing
through a `file://` store in a temporary directory, and runs ONE full
training step of the audio,text flagship at hidden 64 (forward with
dropout on, the masked two-head loss, backward, the gradient all-reduce,
Adam) over a (n / tp data) x (tp model) mesh, tp = 2 when n >= 4 and even.
Rank 0 then runs the identical step on one process and requires the loss
within 1e-5 and the post-update parameter norm within 1e-4 relative: the
dp x tp step must be the one-process step.

  python -m multimodalaggressionrecognition_tpu_torch.parallel.dryrun 4
"""

import argparse
import os
import subprocess
import sys
import tempfile

HIDDEN, AUDIO_LEN, TEXT_LEN = 64, 16000, 12
_MODULE = "multimodalaggressionrecognition_tpu_torch.parallel.dryrun"


def _flagship():
    from ..cli.train_multimodal import MultimodalConfig, build_model
    from ..models.layers import seeded_init_

    cfg = MultimodalConfig(hidden_size=HIDDEN, audio_samples=AUDIO_LEN,
                           text_tokens=TEXT_LEN, fusion_heads=8)
    return seeded_init_(build_model(cfg, ("audio", "text")), 0)


def _batch(b: int):
    import numpy as np

    rng = np.random.default_rng(0)
    ones = np.ones((b,), np.float32)
    return {
        "modalities": {
            "audio": {"data": rng.standard_normal((b, AUDIO_LEN)).astype(
                np.float32) * 0.1, "present": ones},
            "text": {"data": rng.standard_normal((b, TEXT_LEN, HIDDEN)).astype(
                np.float32), "present": ones}},
        "labels": {"phys": np.zeros((b,), np.int64),
                   "verb": (np.arange(b) % 2).astype(np.int64)},
        "label_mask": {"phys": np.zeros((b,), np.float32),
                       "verb": ones},
        "sample_mask": ones,
    }


def _step(batch, mesh):
    """(loss, parameter norm) after one train step on `batch` (this rank's
    rows when `mesh` is given)."""
    import torch

    from ..models.stochastic import set_generator
    from ..train.state import OptimizerConfig, create_train_state
    from ..train.steps import LossSpec, train_step
    from ..data.pipeline import _tree_map

    state = create_train_state(_flagship(), OptimizerConfig(1e-3), "cpu",
                               mesh=mesh)
    set_generator(state.model, torch.Generator().manual_seed(0))
    specs = {"phys": LossSpec("focal", class_weights=(0.5, 0.5)),
             "verb": LossSpec("ce")}
    metrics = train_step(state, _tree_map(torch.from_numpy, batch), specs,
                         num_classes=2)
    params = list(state.model.parameters())
    with torch.no_grad():
        if mesh is not None and mesh.tp > 1:
            from .sharding_rules import clip_norm_squares

            sq = clip_norm_squares(params, params, mesh)
        else:
            sq = sum(p.double().square().sum() for p in params)
    return float(metrics["total_loss"]), float(sq) ** 0.5


def _rank_main(rank: int, world: int, init_method: str):
    import torch

    torch.set_num_threads(1)
    from .mesh import initialize_distributed, make_mesh, shard_batch

    initialize_distributed(num_processes=world, process_id=rank,
                           init_method=init_method, backend="gloo")
    tp = 2 if world >= 4 and world % 2 == 0 else 1
    mesh = make_mesh(model_parallelism=tp, device="cpu")
    batch = _batch(2 * world)
    loss, pnorm = _step(shard_batch(batch, mesh), mesh)
    if rank == 0:
        ref_loss, ref_pnorm = _step(batch, None)
        assert abs(loss - ref_loss) < 1e-5, (loss, ref_loss)
        assert abs(pnorm - ref_pnorm) < 1e-4 * max(1.0, ref_pnorm), (
            pnorm, ref_pnorm)
        print(f"dryrun_multichip({world}): ok, dp {mesh.dp} x tp {tp}, "
              f"loss={loss:.6f} (1-rank loss={ref_loss:.6f}, "
              f"|d|={abs(loss - ref_loss):.2e}; param_norm {pnorm:.6f} vs "
              f"1-rank {ref_pnorm:.6f})", flush=True)
    import torch.distributed as dist

    dist.destroy_process_group()


def dryrun_multichip(n_devices: int, timeout: float = 600) -> str:
    """Run the dry run over `n_devices` gloo ranks on the CPU; returns rank
    0's report, raises if any rank fails."""
    package_parent = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (package_parent, env.get("PYTHONPATH")) if p)
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        procs = [subprocess.Popen(
            [sys.executable, "-m", _MODULE, "--rank", str(r), "--world",
             str(n_devices), "--init_method", init],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(n_devices)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    failed = [(r, p.returncode, out[-3000:])
              for r, (p, out) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    if failed:
        raise RuntimeError(f"dryrun_multichip({n_devices}): ranks failed: "
                           f"{failed}")
    print(outs[0], end="", flush=True)
    return outs[0]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", nargs="?", type=int, default=4)
    p.add_argument("--rank", type=int)
    p.add_argument("--world", type=int)
    p.add_argument("--init_method")
    args = p.parse_args(argv)
    if args.rank is None:
        dryrun_multichip(args.n)
    else:
        _rank_main(args.rank, args.world, args.init_method)


if __name__ == "__main__":
    main()
