"""The port's training knobs against the JAX package's
(tests/test_train_features.py): LR schedules with warmup, AdamW, global-norm
clipping, gradient accumulation, the parameter EMA, early stopping, and
their checkpoints.

Each JAX test's own check holds in the port at that test's tolerance:
atol 1e-7 for AdamW's decoupled decay (`:62`, against the formula and
against JAX's update), rtol 1e-6 for accumulation against Adam on the mean
gradient and for the EMA recursion (`:82-83, :136, :346`).  Besides, each
knob runs N steps of the JAX package's optimizer chain
(`cli.common.make_optimizer`) or train step and of the port's on the same
weights and gradients, and the parameters are held to JAX's at rtol 1e-5,
atol 1e-6 (XJAX): torch's Adam and optax's round their f32 arithmetic in
another order, a few ulp a step.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodalaggressionrecognition_tpu.cli.common import (
    TrainConfig as JaxTrainConfig)
from multimodalaggressionrecognition_tpu.cli.common import (
    make_optimizer as jax_make_optimizer)
from multimodalaggressionrecognition_tpu.models.layers import TorchLinear
from multimodalaggressionrecognition_tpu.train import LossSpec as JaxLossSpec
from multimodalaggressionrecognition_tpu.train.state import (
    create_train_state as jax_train_state)
from multimodalaggressionrecognition_tpu.train.steps import (
    make_train_step as jax_make_train_step)
from multimodalaggressionrecognition_tpu_torch.cli.common import (
    TrainConfig, make_optimizer, parse_config)
from multimodalaggressionrecognition_tpu_torch.io import checkpoint as ckpt_io
from multimodalaggressionrecognition_tpu_torch.io.from_jax import (
    load_jax_variables)
from multimodalaggressionrecognition_tpu_torch.ops.losses import (
    cross_entropy)
from multimodalaggressionrecognition_tpu_torch.train.loop import Trainer
from multimodalaggressionrecognition_tpu_torch.train.state import (
    Optimizer, OptimizerConfig, create_train_state)
from multimodalaggressionrecognition_tpu_torch.train.steps import (
    LossSpec, eval_step, train_step)


XJAX = dict(rtol=1e-5, atol=1e-6)  # N steps, port against JAX


def _tree(seed=0, shape=(4, 4)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _run(cfg_kwargs, grads, params0=None):
    """(port params, JAX params) after one update per gradient in `grads`
    (each a (4, 4) array), from the same start, through the port's chain
    and the JAX package's make_optimizer."""
    params0 = _tree() if params0 is None else params0
    tx = jax_make_optimizer(JaxTrainConfig(**cfg_kwargs))
    jp = {"w": jnp.asarray(params0)}
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update({"w": jnp.asarray(g)}, state, jp)
        jp = optax.apply_updates(jp, updates)
    p = torch.nn.Parameter(torch.from_numpy(params0.copy()))
    opt = Optimizer([p], make_optimizer(TrainConfig(**cfg_kwargs)))
    for g in grads:
        p.grad = torch.from_numpy(g.copy())
        opt.step()
    return p.detach().numpy(), np.asarray(jp["w"]), opt


@pytest.mark.parametrize("kwargs", [
    dict(lr_schedule="cosine", lr_decay_steps=7),
    dict(lr_schedule="exponential", lr_decay_steps=3, lr_decay_rate=0.5),
    dict(warmup_steps=4),
    dict(lr_schedule="cosine", lr_decay_steps=5, warmup_steps=3)],
    ids=["cosine", "exponential", "warmup", "warmup-cosine"])
def test_schedules_match_optax(kwargs):
    """The rate of the update after `count` updates, and ten updates'
    parameters, against optax's schedules in the JAX chain."""
    import optax as ox

    cfg = OptimizerConfig(learning_rate=1e-2, **kwargs)
    lr = 1e-2
    if cfg.lr_schedule == "cosine":
        tail = ox.cosine_decay_schedule(lr, cfg.lr_decay_steps)
    elif cfg.lr_schedule == "exponential":
        tail = ox.exponential_decay(lr, cfg.lr_decay_steps,
                                    cfg.lr_decay_rate)
    else:
        tail = ox.constant_schedule(lr)
    sched = tail if not cfg.warmup_steps else ox.join_schedules(
        [ox.linear_schedule(0.0, lr, cfg.warmup_steps), tail],
        [cfg.warmup_steps])
    for count in range(12):
        np.testing.assert_allclose(cfg.schedule(count), float(sched(count)),
                                   rtol=1e-5, atol=1e-9)
    grads = [_tree(seed=s) for s in range(1, 11)]
    got, want, _ = _run(dict(learning_rate=1e-2, **kwargs), grads)
    np.testing.assert_allclose(got, want, **XJAX)


def test_warmup_starts_at_zero_lr():
    ones = np.ones((4, 4), np.float32)
    got, want, opt = _run(dict(learning_rate=1e-2, warmup_steps=100), [ones])
    np.testing.assert_array_equal(got, _tree())  # rate 0: nothing moves
    np.testing.assert_allclose(got, want, rtol=1e-5)
    plain, _, _ = _run(dict(learning_rate=1e-2), [ones])
    assert np.abs(plain - _tree()).max() > 0
    assert opt.updates == 1


def test_grad_clipping_changes_updates():
    grads = [np.full((4, 4), 1e3, np.float32), np.ones((4, 4), np.float32)]
    clipped, want, _ = _run(dict(learning_rate=1e-2, grad_clip_norm=1.0),
                            grads)
    plain, _, _ = _run(dict(learning_rate=1e-2), grads)
    np.testing.assert_allclose(clipped, want, **XJAX)
    # Adam is scale-invariant for constant grads; the big -> small change
    # makes the clipped second moments diverge from the unclipped ones
    assert not np.allclose(clipped, plain)


def test_clip_is_optax_formula_without_epsilon():
    from multimodalaggressionrecognition_tpu_torch.train.state import (
        clip_by_global_norm_)

    g = [torch.full((3,), 2.0), torch.full((1,), 2.0)]  # norm 4
    norm = clip_by_global_norm_(g, 1.0)
    assert norm.item() == 4.0
    want = optax.clip_by_global_norm(1.0).update(
        [jnp.full((3,), 2.0), jnp.full((1,), 2.0)], None)[0]
    for a, b in zip(g, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    small = [torch.full((2,), 0.1)]
    clip_by_global_norm_(small, 1.0)
    np.testing.assert_array_equal(small[0].numpy(),
                                  np.full(2, 0.1, np.float32))


def test_weight_decay_is_adamw():
    params = _tree()
    got, want, _ = _run(dict(learning_rate=1e-2, weight_decay=0.1),
                        [np.zeros((4, 4), np.float32)])
    # zero grads: AdamW still shrinks params toward 0 (decoupled decay)
    np.testing.assert_allclose(got - params, -1e-2 * 0.1 * params, atol=1e-7)
    np.testing.assert_allclose(got, want, atol=1e-7)
    grads = [_tree(seed=s) for s in range(1, 4)]
    got, want, _ = _run(dict(learning_rate=1e-2, weight_decay=0.1), grads)
    np.testing.assert_allclose(got, want, **XJAX)


def test_grad_accumulation_matches_mean_gradient():
    g1, g2 = _tree(seed=1), _tree(seed=2)
    p = torch.nn.Parameter(torch.from_numpy(_tree()))
    opt = Optimizer([p], OptimizerConfig(learning_rate=1e-2,
                                         grad_accum_steps=2))
    p.grad = torch.from_numpy(g1.copy())
    assert not opt.step()  # no update mid-accumulation
    np.testing.assert_array_equal(p.detach().numpy(), _tree())
    p.grad = torch.from_numpy(g2.copy())
    assert opt.step()
    ref, _, _ = _run(dict(learning_rate=1e-2), [(g1 + g2) / 2])
    np.testing.assert_allclose(p.detach().numpy(), ref, rtol=1e-6)
    grads = [_tree(seed=s) for s in range(1, 7)]
    got, want, _ = _run(dict(learning_rate=1e-2, grad_accum_steps=3), grads)
    np.testing.assert_allclose(got, want, **XJAX)


# ---------------------------------------------------------------------- EMA

class _JaxTiny(fnn.Module):
    @fnn.compact
    def __call__(self, modalities, train=False):
        return {"main": TorchLinear(2)(modalities["x"]["data"])}


class _Tiny(torch.nn.Module):
    """The JAX test's TorchLinear(2) model in the batch protocol."""

    def __init__(self):
        super().__init__()
        self.TorchLinear_0 = torch.nn.Linear(8, 2)

    def forward(self, modalities):
        return {"main": self.TorchLinear_0(modalities["x"]["data"])}


def _batch(b=4, seed=0):
    rng = np.random.default_rng(seed)
    return {"modalities": {"x": {"data": rng.standard_normal(
                (b, 8)).astype(np.float32)}},
            "labels": {"main": (np.arange(b) % 2).astype(np.int32)},
            "label_mask": {"main": np.ones((b,), np.float32)},
            "sample_mask": np.ones((b,), np.float32)}


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, its numpy variables, batch)."""
    model, b = _JaxTiny(), _batch()
    variables = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0),
                                                    b["modalities"]))
    return model, variables, b


def _port_state(variables, opt=OptimizerConfig(learning_rate=0.1),
                ema_decay=0.0):
    return create_train_state(load_jax_variables(_Tiny(), variables), opt,
                              "cpu", ema_decay=ema_decay)


SPECS = {"main": LossSpec("ce")}
KERNEL = "TorchLinear_0.weight"


def _kernel(tree):
    """A JAX TorchLinear_0 kernel as the port's weight (transposed)."""
    return np.asarray(tree["TorchLinear_0"]["kernel"]).T


def test_ema_tracks_recursion_and_eval_uses_it(tiny):
    model, variables, b = tiny
    decay = 0.8
    jstate = jax_train_state(model, b["modalities"], optax.adam(1e-1),
                             ema_decay=decay)
    jstate = jstate.replace(params=variables["params"],
                            ema_params=variables["params"])
    jstep = jax_make_train_step(model, {"main": JaxLossSpec("ce")}, 2,
                                donate=False)
    state = _port_state(variables, OptimizerConfig(learning_rate=1e-1), decay)
    tb = _torch(b)
    np.testing.assert_array_equal(state.ema[KERNEL].numpy(),
                                  state.model.TorchLinear_0.weight.detach())
    manual = state.ema[KERNEL].clone()
    for i in range(3):
        train_step(state, tb, SPECS, 2)
        jstate, _ = jstep(jstate, b, jax.random.PRNGKey(i))
        manual = decay * manual + (1 - decay) * \
            state.model.TorchLinear_0.weight.detach()
    np.testing.assert_allclose(state.ema[KERNEL].numpy(), manual.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(state.ema[KERNEL].numpy(),
                               _kernel(jstate.ema_params), **XJAX)
    live = state.model.TorchLinear_0.weight.detach()
    assert not np.allclose(state.ema[KERNEL].numpy(), live.numpy())

    # eval runs on the EMA shadow, not the live params
    got = eval_step(state, tb, SPECS, 2)["main"]["loss"].item()
    x, y = tb["modalities"]["x"]["data"], tb["labels"]["main"]
    mask = tb["label_mask"]["main"]
    shadow = x @ state.ema[KERNEL].T + state.ema["TorchLinear_0.bias"]
    want = cross_entropy(shadow, y, mask).item()
    live_loss = cross_entropy(state.model.TorchLinear_0(x), y, mask).item()
    assert got == pytest.approx(want, rel=1e-5)
    assert want != pytest.approx(live_loss, rel=1e-5)


def test_ema_checkpoint_roundtrip(tiny, tmp_path):
    _, variables, b = tiny
    state = _port_state(variables, OptimizerConfig(learning_rate=1e-1), 0.9)
    train_step(state, _torch(b), SPECS, 2)
    ckpt_io.save_state(str(tmp_path / "ck"), state, meta={"epoch": 0})

    fresh = _port_state(variables, OptimizerConfig(learning_rate=1e-1), 0.9)
    ckpt_io.restore_state(str(tmp_path / "ck"), fresh)
    np.testing.assert_array_equal(fresh.ema[KERNEL], state.ema[KERNEL])

    # an EMA checkpoint loads into a plain template (the predict/evaluate
    # path) and serves the shadow through eval_params
    plain = _port_state(variables, OptimizerConfig(learning_rate=1e-1))
    ckpt_io.restore_state(str(tmp_path / "ck"), plain)
    np.testing.assert_array_equal(plain.eval_params()[KERNEL],
                                  state.ema[KERNEL])

    # a plain checkpoint loads into an EMA template (resume with
    # --ema_decay newly on): the shadow is seeded from the restored params
    plain_ck = _port_state(variables, OptimizerConfig(learning_rate=1e-1))
    train_step(plain_ck, _torch(b), SPECS, 2)
    ckpt_io.save_state(str(tmp_path / "plain_ck"), plain_ck)
    t_ema = _port_state(variables, OptimizerConfig(learning_rate=1e-1), 0.9)
    ckpt_io.restore_state(str(tmp_path / "plain_ck"), t_ema)
    np.testing.assert_array_equal(t_ema.ema[KERNEL],
                                  t_ema.model.TorchLinear_0.weight.detach())


def test_ema_with_donation_no_alias(tiny):
    """The shadow is a copy of the parameters, never an alias: an update
    moves the parameter and not the shadow by the same amount."""
    _, variables, b = tiny
    state = _port_state(variables, OptimizerConfig(learning_rate=1e-1), 0.9)
    weight = state.model.TorchLinear_0.weight
    assert state.ema[KERNEL].data_ptr() != weight.data_ptr()
    train_step(state, _torch(b), SPECS, 2)
    metrics = train_step(state, _torch(b), SPECS, 2)
    assert np.isfinite(metrics["total_loss"].item())
    assert not torch.equal(state.ema[KERNEL], weight.detach())


# -------------------------------------------------------------- early stop

def test_early_stopping_breaks_fit(tiny, tmp_path):
    _, variables, _ = tiny
    batches = [_batch(seed=s) for s in range(2)]
    # lr=0: epoch 0 sets the first best, nothing ever improves again
    t = Trainer(load_jax_variables(_Tiny(), variables), SPECS,
                OptimizerConfig(learning_rate=0.0), batches, batches,
                num_classes=2, saving_dir=str(tmp_path), model_name="es",
                device="cpu", checkpoint_criterion="loss", log_console=False,
                early_stop_patience=2)
    t.fit(10)
    assert len(t.logs["main_test"]) == 3  # epoch 0 best + 2 flat -> stop


def test_default_optimizer_state_structure_is_plain_adam():
    """The defaults are torch's Adam with optax.adam's hyperparameters: no
    weight decay, no accumulation state, no schedule."""
    p = torch.nn.Parameter(torch.zeros(3))
    cfg = make_optimizer(TrainConfig())
    assert cfg == OptimizerConfig()
    opt = Optimizer([p], cfg)
    assert type(opt.inner) is torch.optim.Adam
    group = opt.inner.param_groups[0]
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    assert group["weight_decay"] == 0
    assert sorted(opt.state_dict()) == ["adam", "updates"]
    assert all(cfg.schedule(c) == 1e-3 for c in (0, 1, 10 ** 6))


def test_schedule_checkpoint_restores_into_plain_adam_template(tiny,
                                                               tmp_path):
    """A run saved with a schedule, AdamW and accumulation resumes into a
    plain-Adam trainer: the model and the moments load, the plain config's
    own hyperparameters stay; an optimizer state that fits no slot is left
    fresh with a note."""
    _, variables, b = tiny
    sched = OptimizerConfig(lr_schedule="cosine", warmup_steps=5,
                            weight_decay=0.1, grad_accum_steps=2)
    s = _port_state(variables, sched)
    for _ in range(4):
        train_step(s, _torch(b), SPECS, 2)
    ckpt_io.save_state(str(tmp_path / "ck"), s, meta={"epoch": 3})

    plain = _port_state(variables, OptimizerConfig(learning_rate=1e-3))
    meta, _ = ckpt_io.restore_state(str(tmp_path / "ck"), plain)
    np.testing.assert_array_equal(plain.model.TorchLinear_0.weight.detach(),
                                  s.model.TorchLinear_0.weight.detach())
    assert meta["epoch"] == 3 and "optimizer_state" not in meta
    assert plain.optimizer.updates == 2
    group = plain.optimizer.inner.param_groups[0]
    assert group["weight_decay"] == 0 and plain.optimizer.acc is None
    inner = s.optimizer.inner.state_dict()["state"]
    for k, st in plain.optimizer.inner.state_dict()["state"].items():
        np.testing.assert_array_equal(st["exp_avg"], inner[k]["exp_avg"])

    class Wider(_Tiny):  # another parameter set: no slot fits
        def __init__(self):
            super().__init__()
            self.extra = torch.nn.Parameter(torch.zeros(2))

    other = create_train_state(Wider(), OptimizerConfig(learning_rate=1e-3),
                               "cpu")
    other.model.load_state_dict(
        {**s.model.state_dict(), "extra": torch.zeros(2)})
    ckpt = torch.load(str(tmp_path / "ck"), weights_only=True)
    ckpt["state_dict"]["extra"] = torch.zeros(2)
    torch.save(ckpt, str(tmp_path / "ck2"))
    meta, _ = ckpt_io.restore_state(str(tmp_path / "ck2"), other)
    assert "reinitialized" in meta["optimizer_state"]


def test_restore_variables_serves_ema(tiny, tmp_path):
    _, variables, b = tiny
    s = _port_state(variables, OptimizerConfig(learning_rate=1e-1), 0.9)
    train_step(s, _torch(b), SPECS, 2)
    ckpt_io.save_state(str(tmp_path / "ck"), s)
    sd, _ = ckpt_io.restore_variables(str(tmp_path / "ck"))
    np.testing.assert_array_equal(sd[KERNEL], s.ema[KERNEL])
    assert not torch.equal(sd[KERNEL], s.model.TorchLinear_0.weight.detach())


def test_resume_without_ema_flag_keeps_shadow(tiny, tmp_path):
    """Resuming an EMA run into a state that forgot --ema_decay keeps the
    restored shadow and its saved decay."""
    _, variables, b = tiny
    s = _port_state(variables, OptimizerConfig(learning_rate=1e-1), 0.9)
    train_step(s, _torch(b), SPECS, 2)
    ckpt_io.save_state(str(tmp_path / "ck"), s)
    forgot = _port_state(variables, OptimizerConfig(learning_rate=1e-1))
    ckpt_io.restore_state(str(tmp_path / "ck"), forgot)
    assert forgot.ema_decay == pytest.approx(0.9)
    train_step(forgot, _torch(b), SPECS, 2)
    # the shadow still lags (decay 0.0 would have snapped to the params)
    assert not np.allclose(forgot.ema[KERNEL],
                           forgot.model.TorchLinear_0.weight.detach())


def test_ema_with_grad_accumulation_decays_once_per_update(tiny):
    """With accumulation k the shadow decays once per optimizer update,
    not once per micro-step; held to the JAX train step's shadow."""
    model, variables, b = tiny
    k, decay = 2, 0.8
    tx = jax_make_optimizer(JaxTrainConfig(learning_rate=1e-1,
                                           grad_accum_steps=k))
    jstate = jax_train_state(model, b["modalities"], tx, ema_decay=decay,
                             ema_update_every=k)
    jstate = jstate.replace(params=variables["params"],
                            ema_params=variables["params"])
    jstep = jax_make_train_step(model, {"main": JaxLossSpec("ce")}, 2,
                                donate=False)
    s = _port_state(variables, OptimizerConfig(learning_rate=1e-1,
                                               grad_accum_steps=k), decay)
    tb = _torch(b)
    ema0 = s.ema[KERNEL].clone()
    train_step(s, tb, SPECS, 2)  # micro-step 1: no update
    np.testing.assert_array_equal(s.ema[KERNEL], ema0)
    train_step(s, tb, SPECS, 2)  # micro-step 2: update
    expect = decay * ema0 + (1 - decay) * s.model.TorchLinear_0.weight.detach()
    np.testing.assert_allclose(s.ema[KERNEL].numpy(), expect.numpy(),
                               rtol=1e-6)
    for i in range(4):
        jstate, _ = jstep(jstate, b, jax.random.PRNGKey(i))
    for _ in range(2):
        train_step(s, tb, SPECS, 2)
    np.testing.assert_allclose(s.ema[KERNEL].numpy(),
                               _kernel(jstate.ema_params), **XJAX)


def test_accumulation_state_survives_a_checkpoint(tiny, tmp_path):
    """A checkpoint taken mid-accumulation resumes the running mean: the
    resumed run's parameters equal an uninterrupted one's."""
    _, variables, b = tiny
    cfg = OptimizerConfig(learning_rate=1e-1, grad_accum_steps=3)
    batches = [_torch(_batch(seed=s)) for s in range(5)]
    ref = _port_state(variables, cfg)
    for tb in batches:
        train_step(ref, tb, SPECS, 2)
    s = _port_state(variables, cfg)
    for tb in batches[:2]:
        train_step(s, tb, SPECS, 2)
    ckpt_io.save_state(str(tmp_path / "ck"), s)
    resumed = _port_state(variables, cfg)
    ckpt_io.restore_state(str(tmp_path / "ck"), resumed)
    assert resumed.optimizer.micro == 2
    for tb in batches[2:]:
        train_step(resumed, tb, SPECS, 2)
    np.testing.assert_array_equal(
        resumed.model.TorchLinear_0.weight.detach(),
        ref.model.TorchLinear_0.weight.detach())


# ------------------------------------------------------------------- CLIs

KNOBS = ["--lr_schedule", "cosine", "--lr_decay_steps", "50",
         "--lr_decay_rate", "0.9", "--warmup_steps", "2",
         "--grad_clip_norm", "1.0", "--weight_decay", "0.01",
         "--grad_accum_steps", "2", "--ema_decay", "0.99",
         "--early_stop_patience", "3", "--profile_dir", "prof",
         "--profile_epoch", "0", "--tensorboard_dir", "tb"]
ENTRIES = ["train_multimodal", "train_audio_transformer",
           "train_text_transformer", "train_video_transformer",
           "train_audio_text", "train_audio_rnn", "train_video_rnn",
           "train3dcnn"]


@pytest.mark.parametrize("entry", ENTRIES)
def test_every_train_entry_accepts_the_knobs(entry):
    """Each train entry's config parses every optimizer and run-operation
    flag into the chain make_optimizer builds."""
    import importlib

    cli = importlib.import_module(
        f"multimodalaggressionrecognition_tpu_torch.cli.{entry}")
    cls = next(v for k, v in vars(cli).items()
               if isinstance(v, type) and k.endswith("Config")
               and issubclass(v, TrainConfig) and v.__module__ == cli.__name__)
    cfg = parse_config(cls, KNOBS)
    assert make_optimizer(cfg) == OptimizerConfig(
        learning_rate=cfg.learning_rate, lr_schedule="cosine",
        lr_decay_steps=50, lr_decay_rate=0.9, warmup_steps=2,
        grad_clip_norm=1.0, weight_decay=0.01, grad_accum_steps=2)
    assert (cfg.ema_decay, cfg.early_stop_patience, cfg.profile_dir,
            cfg.profile_epoch, cfg.tensorboard_dir) == (0.99, 3, "prof", 0,
                                                        "tb")


def test_the_knobs_train_end_to_end(tmp_path):
    """cli.train_text_transformer with every knob on the CPU: it trains,
    logs, keeps the EMA in its checkpoints, writes the profiler's trace
    of the profiled epoch and the TensorBoard scalars."""
    import glob
    import os

    from multimodalaggressionrecognition_tpu_torch.cli import (
        train_text_transformer)

    root = str(tmp_path / "ds")
    args = ["--dataset_root", root, "--synthetic", "--epoch_num", "2",
            "--batch_size", "4", "--num_layers", "1",
            "--saving_dir", str(tmp_path / "runs"), "--device", "cpu",
            "--log_console", "false", "--num_threads", "1"] + KNOBS
    args[args.index("prof")] = str(tmp_path / "prof")
    args[args.index("tb")] = str(tmp_path / "tb")
    trainer = train_text_transformer.main(args)
    files = set(os.listdir(trainer.run_dir))
    assert {"main_train_log.csv", "main_test_log.csv", "checkpoint_current",
            "checkpoint_best_main", "config.json"} <= files
    ckpt = torch.load(os.path.join(trainer.run_dir, "checkpoint_current"),
                      weights_only=True)
    assert ckpt["ema"]["decay"] == pytest.approx(0.99)
    assert trainer.state.optimizer.updates == trainer.state.step // 2
    assert glob.glob(str(tmp_path / "prof" / "trace_*.json"))
    assert glob.glob(str(tmp_path / "tb" / "events.out.tfevents.*"))
    from multimodalaggressionrecognition_tpu_torch.cli.common import (
        load_run_config)

    assert load_run_config(trainer.run_dir)["ema_decay"] == 0.99


@pytest.mark.parametrize("entry", ["generate_features"])
def test_entries_without_bf16_still_refuse_it(entry, tmp_path):
    """Every train entry, extract_features and export_model take bfloat16;
    generate_features, which the JAX package always runs in f32 (it
    ignores the flag), refuses it and says why."""
    import importlib

    cli = importlib.import_module(
        f"multimodalaggressionrecognition_tpu_torch.cli.{entry}")
    argv = ["--compute_dtype", "bfloat16", "--device", "cpu", "--synthetic",
            "--dataset_root", str(tmp_path / "ds"), "--saving_dir",
            str(tmp_path / "runs"), "--audio_samples", "16000",
            "--text_tokens", "8", "--out_dir", str(tmp_path / "out")]
    with pytest.raises(SystemExit, match="always runs in float32"):
        cli.main(argv)
