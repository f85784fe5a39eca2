"""Multi-rank CPU runs of the PyTorch port, for the
tests/test_torch_parallel*.py tests: `launch` starts the ranks, and run as
a script this module is one rank (it imports torch and the port, never
JAX):

    python tests/_torch_parallel_child.py MODE RANK WORLD DIR

Every rank joins a gloo group through a `file://` store in DIR, reads its
inputs from DIR (written by the parent test) and writes what the parent
holds against JAX or against one rank to DIR.  One launch runs a whole
MODE (several cases in turn, each on its own mesh) to keep the process
start-ups few.
"""

import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

from multimodalaggressionrecognition_tpu_torch.data.pipeline import _tree_map
from multimodalaggressionrecognition_tpu_torch.parallel.mesh import (
    all_reduce_, initialize_distributed, make_mesh, shard_batch)

RANK, WORLD, DIR = 0, 1, "."
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch(mode: str, world: int, workdir, timeout: float = 300):
    """Run `mode` on `world` ranks (one interpreter each, one thread each);
    raises with a failed rank's output."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(r), str(world),
         str(workdir)], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{mode} rank {r} exited {p.returncode}:\n"
                                 f"{out[-6000:]}")
    return outs


def path(name):
    return os.path.join(DIR, name)


def load(name):
    return torch.load(path(name), weights_only=False)


def save_main(obj, name):
    if RANK == 0:
        torch.save(obj, path(name))


def tensors(batch):
    return _tree_map(lambda a: torch.from_numpy(np.ascontiguousarray(a)),
                     batch)


def gather_rows(local, mesh):
    """The global batch's rows of `local` (this data index's rows) on every
    rank: zero-padded rows summed over the data group."""
    full = local.new_zeros((local.shape[0] * mesh.dp, *local.shape[1:]))
    n = local.shape[0]
    full[mesh.dp_rank * n:(mesh.dp_rank + 1) * n] = local.detach()
    return all_reduce_(full, mesh.dp_group)


# ------------------------------------------------------------------ steps
def cnn1d_sgd(mesh):
    """test_dp_correctness's CNN1D step: SGD(1.0) on the global loss, the
    gradients summed over the data group by the optimizer's reduce."""
    from multimodalaggressionrecognition_tpu_torch.models.cnn1d import CNN1D
    from multimodalaggressionrecognition_tpu_torch.train.state import (
        Optimizer, OptimizerConfig)
    from multimodalaggressionrecognition_tpu_torch.train.steps import (
        LossSpec, SingleHeadAdapter, head_losses_and_metrics, total_loss)
    from multimodalaggressionrecognition_tpu_torch.parallel.sharding_rules import (
        place_params)

    model = SingleHeadAdapter(CNN1D(2, dropout=0.0, classifier_dropout=0.0),
                              "audio", "main")
    model.load_state_dict(load("cnn1d_weights.pt"))
    place_params(model, mesh)
    batch = tensors(shard_batch(load("cnn1d_batch.pt"), mesh))
    model.train()
    total, metrics = head_losses_and_metrics(
        model(batch["modalities"]), batch, {"main": LossSpec("ce")}, 2,
        mesh.dp_group)
    total.backward()
    params = list(model.parameters())
    Optimizer(params, OptimizerConfig(), mesh).reduce_gradients(
        [p.grad for p in params])
    with torch.no_grad():
        for p in params:
            p -= p.grad
    cm = all_reduce_(metrics["main"]["confusion"].clone(), mesh.dp_group)
    save_main({"loss": float(total_loss(metrics)), "confusion": cm,
               "state_dict": model.state_dict()}, "cnn1d_out.pt")


def flagship_step(batch, mesh):
    """(loss, {name: gradient summed over the ranks, then parameter and
    BatchNorm statistic after the step}) of one Adam train step of the
    hidden-64 flagship with dropout on, on this rank's rows."""
    from multimodalaggressionrecognition_tpu_torch.models.stochastic import (
        set_generator)
    from multimodalaggressionrecognition_tpu_torch.parallel.dryrun import (
        _flagship)
    from multimodalaggressionrecognition_tpu_torch.parallel.sharding_rules import (
        gather_state)
    from multimodalaggressionrecognition_tpu_torch.train.state import (
        OptimizerConfig, create_train_state)
    from multimodalaggressionrecognition_tpu_torch.train.steps import (
        LossSpec, train_step)

    state = create_train_state(_flagship(), OptimizerConfig(1e-3), "cpu",
                               mesh=mesh)
    set_generator(state.model, torch.Generator().manual_seed(3))
    specs = {"phys": LossSpec("focal", class_weights=(0.3, 0.7)),
             "verb": LossSpec("ce")}
    local = batch if mesh is None else shard_batch(batch, mesh)
    metrics = train_step(state, tensors(local), specs, 2)
    sd = state.model.state_dict()
    sd.update({f"{n}.grad": p.grad for n, p in state.model.named_parameters()
               if p.grad is not None})
    if mesh is not None and mesh.tp > 1:
        sd = gather_state({"state_dict": sd}, state)["state_dict"]
    return float(metrics["total_loss"]), sd


def steps():
    """The CNN1D SGD step against JAX; the flagship with dropout on, and
    with one rank's phys rows all masked, against one rank of the port."""
    mesh = make_mesh(1, "cpu")
    cnn1d_sgd(mesh)
    for name in ("dropout", "masked"):
        batch = load(f"{name}_batch.pt")
        loss, sd = flagship_step(batch, mesh)
        if RANK == 0:
            ref_loss, ref_sd = flagship_step(batch, None)
            save_main({"loss": loss, "state_dict": sd, "ref_loss": ref_loss,
                       "ref_state_dict": ref_sd}, f"{name}_out.pt")


# ------------------------------------------------------------------ tensor parallel
def tp():
    """The TransformerEncoder of test_tensor_parallel.py: forward and the
    gradients of sum(out ** 2); the small Wav2Vec2Model forward; the
    gathered state against the unsharded one."""
    from multimodalaggressionrecognition_tpu_torch.models.layers import (
        TransformerEncoder)
    from multimodalaggressionrecognition_tpu_torch.models.wav2vec import (
        Wav2Vec2Config, Wav2Vec2Model)
    from multimodalaggressionrecognition_tpu_torch.parallel.sharding_rules import (
        clip_norm_squares, gather_state, gather_tensor, model_splits,
        place_state_for_tp)
    from multimodalaggressionrecognition_tpu_torch.train.state import (
        OptimizerConfig, create_train_state)

    mesh = make_mesh(2, "cpu")
    model = TransformerEncoder(d_model=64, nhead=4, num_layers=2,
                               dim_feedforward=128)
    model.load_state_dict(load("encoder_weights.pt"))
    state = create_train_state(model, OptimizerConfig(), "cpu", mesh=mesh)
    model.eval()
    x = torch.from_numpy(shard_batch(load("encoder_x.pt"), mesh))
    out = model(x)
    (out ** 2).sum().backward()
    params = list(model.parameters())
    state.optimizer.reduce_gradients([p.grad for p in params])
    splits = model_splits(model)
    grads = {n: (gather_tensor(p.grad, splits[n], mesh) if n in splits
                 else p.grad) for n, p in model.named_parameters()}
    norm_sq = clip_norm_squares([p.grad for p in params], params, mesh)
    payload = {"state_dict": model.state_dict(),
               "optimizer": state.optimizer.state_dict()}
    full = gather_state(payload, state)
    back = place_state_for_tp(full, state)
    assert all(torch.equal(back["state_dict"][k], v)
               for k, v in payload["state_dict"].items())

    w2v = Wav2Vec2Model(Wav2Vec2Config(
        conv_layers=((32, 10, 5), (32, 3, 2)), embed_dim=32, num_layers=2,
        num_heads=4, ff_dim=64, pos_conv_kernel=16, pos_conv_groups=4))
    w2v.load_state_dict(load("w2v_weights.pt"))
    create_train_state(w2v, OptimizerConfig(), "cpu", mesh=mesh)
    w2v.eval()
    with torch.no_grad():
        w2v_out = w2v(torch.from_numpy(shard_batch(load("w2v_x.pt"), mesh)))
    save_main({"out": gather_rows(out, mesh), "grads": grads,
               "norm_sq": float(norm_sq),
               "state_dict": full["state_dict"],
               "splits": {n: (s.dim, s.blocks) for n, s in splits.items()},
               "w2v_splits": sorted(model_splits(w2v)),
               "w2v_out": gather_rows(w2v_out, mesh)},
              f"tp_out_{WORLD}.pt")


def hubert_tower(dropout):
    """test_tp_cli.py's Tower: HuBERT-large truncated to 2 layers, then a
    2-way head on the mean over time."""
    import dataclasses

    from torch import nn

    from multimodalaggressionrecognition_tpu_torch.models.wav2vec import (
        HUBERT_LARGE, Wav2Vec2Model)

    cfg = dataclasses.replace(HUBERT_LARGE, num_layers=2, dropout=dropout)

    class Tower(nn.Module):
        def __init__(self):
            super().__init__()
            self.hubert = Wav2Vec2Model(cfg)
            self.cls = nn.Linear(cfg.embed_dim, 2)

        def forward(self, modalities):
            feats = self.hubert(modalities["audio"]["data"])
            return {"main": self.cls(feats.mean(dim=1))}

    return Tower()


def hubert_steps(batches, mesh, dropout):
    """(losses, parameter norm) of two Adam(1e-4) CE steps of the tower
    from the saved weights, on this rank's rows when `mesh` is given."""
    from multimodalaggressionrecognition_tpu_torch.models.stochastic import (
        set_generator)
    from multimodalaggressionrecognition_tpu_torch.parallel.sharding_rules import (
        clip_norm_squares)
    from multimodalaggressionrecognition_tpu_torch.train.state import (
        OptimizerConfig, create_train_state)
    from multimodalaggressionrecognition_tpu_torch.train.steps import (
        LossSpec, train_step)

    model = hubert_tower(dropout)
    model.load_state_dict(load("hubert_weights.pt"))
    state = create_train_state(model, OptimizerConfig(1e-4), "cpu", mesh=mesh)
    set_generator(state.model, torch.Generator().manual_seed(0))
    losses = []
    for batch in batches:
        local = batch if mesh is None else shard_batch(batch, mesh)
        metrics = train_step(state, tensors(local), {"main": LossSpec("ce")},
                             2)
        losses.append(float(metrics["total_loss"]))
    params = list(state.model.parameters())
    with torch.no_grad():
        if mesh is None:
            sq = sum(p.double().square().sum() for p in params)
        else:
            sq = clip_norm_squares(params, params, mesh)
    return losses, float(sq) ** 0.5


def tp_hubert():
    """test_tp_cli.py's HuBERT-large tp 2 train step (dropout 0.1, the
    tower's own) against one rank; rank 0 also runs the one-rank steps with
    dropout 0.0, which the parent holds against JAX."""
    batches = load("hubert_batches.pt")
    losses, norm = hubert_steps(batches, make_mesh(2, "cpu"), 0.1)
    out = {"tp": (losses, norm)}
    if RANK == 0:
        out["one"] = hubert_steps(batches, None, 0.1)
        out["plain"] = hubert_steps(batches, None, 0.0)
    save_main(out, "hubert_out.pt")


# ------------------------------------------------------------------ CLIs
def cli():
    """train_text_transformer under --data_parallel and --model_parallelism
    2, a --model_parallelism 2 run interrupted after epoch 0 and resumed,
    and evaluate --data_parallel."""
    from multimodalaggressionrecognition_tpu_torch.cli import (
        evaluate, train_text_transformer)

    base = ["--dataset_root", path("avabos"), "--batch_size", "4",
            "--num_layers", "1", "--log_console", "false", "--device", "cpu",
            "--num_threads", "1"]
    train_text_transformer.main(base + [
        "--epoch_num", "2", "--saving_dir", path("dp"), "--data_parallel"])
    train_text_transformer.main(base + [
        "--epoch_num", "2", "--saving_dir", path("tp"),
        "--model_parallelism", "2"])
    for epochs in ("1", "2"):  # the second call resumes at epoch 1
        train_text_transformer.main(base + [
            "--epoch_num", epochs, "--run_name", "split",
            "--saving_dir", path("resume"), "--model_parallelism", "2"])
    results = evaluate.main(load("evaluate_args.pt") + ["--data_parallel"])
    save_main(results, "evaluate_out.pt")


# ------------------------------------------------------------------ trainer
def trainer():
    """The multi-rank Trainer over ProcessLocalBatches for 2 epochs;
    preemption requested on rank 1 only at its third poll, then resumed."""
    from multimodalaggressionrecognition_tpu_torch.utils.preemption import (
        PreemptionGuard)

    mesh = make_mesh(1, "cpu")
    run_training(path("mp_run"), mesh)

    class CountingGuard(PreemptionGuard):
        polls = 0

        def should_stop(self):
            CountingGuard.polls += 1
            if RANK == 1 and CountingGuard.polls == 3:
                self.request()
            return super().should_stop()

    stopped = run_training(path("preempt_run"), mesh,
                           guard=CountingGuard(consensus_interval=1))
    steps_each = [torch.zeros(1) for _ in range(WORLD)]
    dist.all_gather(steps_each, torch.tensor([float(stopped.state.step)]))
    meta = torch.load(path("preempt_run/checkpoint_preempt"),
                      weights_only=False)["meta"]
    save_main({"steps": [float(s) for s in steps_each], "meta": meta},
              "preempt.pt")
    run_training(path("preempt_run"), mesh, resume=True)


def build_batches(n_batches=4, batch=8, feat=16):
    """test_multiproc_trainer's deterministic single-head global batches."""
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(n_batches):
        x = rng.standard_normal((batch, feat)).astype(np.float32)
        y = rng.integers(0, 2, size=(batch,)).astype(np.int64)
        batches.append({
            "modalities": {"feat": {"data": x,
                                    "present": np.ones(batch, np.float32)}},
            "labels": {"main": y},
            "label_mask": {"main": np.ones(batch, np.float32)},
            "sample_mask": np.ones(batch, np.float32),
        })
    return batches


def run_training(run_dir, mesh=None, guard=None, resume=False):
    """2 epochs of the Trainer on an MLP over build_batches (the same
    batches for train and test), on one process or this rank's rows."""
    from torch import nn

    from multimodalaggressionrecognition_tpu_torch.models.layers import (
        seeded_init_)
    from multimodalaggressionrecognition_tpu_torch.train.loop import Trainer
    from multimodalaggressionrecognition_tpu_torch.train.state import (
        OptimizerConfig)
    from multimodalaggressionrecognition_tpu_torch.train.steps import (
        LossSpec, SingleHeadAdapter)

    model = seeded_init_(SingleHeadAdapter(nn.Sequential(
        nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 2)), "feat"), 0)
    batches = build_batches()
    trainer = Trainer(model, {"main": LossSpec("ce")}, OptimizerConfig(0.01),
                      batches, batches, num_classes=2, saving_dir=run_dir,
                      model_name="mp", device="cpu", run_dir=run_dir,
                      log_console=False, seed=0, mesh=mesh)
    if guard is not None:
        trainer.preemption_guard = guard
    if resume:
        trainer.resume_latest()
    trainer.fit(2)
    return trainer


if __name__ == "__main__":
    torch.set_num_threads(1)
    MODE, RANK, WORLD, DIR = (sys.argv[1], int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    initialize_distributed(num_processes=WORLD, process_id=RANK,
                           init_method=f"file://{path('rendezvous')}",
                           backend="gloo")
    {"steps": steps, "tp": tp, "tp_hubert": tp_hubert, "cli": cli,
     "trainer": trainer}[MODE]()
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {RANK}: {MODE} ok", flush=True)
