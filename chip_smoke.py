#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (multimodalaggressionrecognition_tpu_torch).

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  1. device   - the card's name, `nvidia-smi` name and power limit, versions;
                TF32 off for matmuls and cuDNN, so every f32 comparison below
                means f32.
  2. build    - nvcc for sm_90a of every kernel source, all started together.
  3. kernels  - each kernel against its plain PyTorch version on the card:
                K1 (framed conv1d) at the JAX tests' shapes and the CNN1D
                stem's, atol/rtol 1e-4; K2 (window attention) at
                tests/test_pallas.py's shapes, 1e-5 as there, and at the four
                Swin3D-T stage shapes of the tri-modal b8 forward, masked and
                unmasked, 1e-4 (longer f32 sums); K3 (window-attention
                backward, dqkv and dbias) at tests/test_pallas.py's gradient
                shapes, 1e-4, and at the stage shapes, 1e-4 of the largest
                gradient.  At the main path's shape (K1: the stem at b32;
                K2, K3: stage 0's shifted block) also the kernel's, the plain
                version's and one library call's time (K3: SDPA's backward)
                and the least time the card could take; K2's and K3's time
                at every stage.
  4. slices   - each served model at full width with seeded random weights:
                audio,text (hidden 768, 80 000 samples, 48 tokens, 1 fusion
                layer, 8 heads, batch 32), then audio,text,video (+ the frozen
                Swin3D-T tower on 128 frames at 112 px in 8-frame windows,
                batch 8):
                (a) logits and tower features on the card against the same
                    model on the CPU, 1e-3 (tri-modal at batch 2);
                (b) the HTTP server (cli/serve.build_server) answering a short
                    JSON clip, an npz batch larger than the batch size and 4
                    concurrent npz clips, with the kernels' launch counts
                    reset just before and read just after: every kernel of the
                    path launched its count per served forward (K1 once, K2
                    12 times), no other kernel;
                (c) throughput of Predictor.predict at the served batch, the
                    forward's time by tower, its kernel time by family, and
                    MicroBatcher single-clip p50 latency.
  5. train    - the tri-modal model fine-tuned (Swin unfrozen, remat on):
                (a) loss and every gradient of the full-width model at b1
                    with 16 frames, eval mode, on the card against the CPU,
                    each within 1e-3 times that tensor's largest gradient;
                (b) cli.train_multimodal.main at full width, batch 8, 2
                    epochs on a synthetic set, launch counts reset just
                    before and read just after: finite logged losses, the
                    logs and checkpoints; then one step of each presence
                    pattern with its launches (video: K2 24, K3 12; audio:
                    K1 1; a verb batch: no K2, no K3);
                (c) the median b8 step time with remat on and off, the peak
                    memory, the step's kernel time by family.
Prints a `slice` JSON line per slice, a `train` JSON line, the `kernels`
JSON line, the card's name and power limit, and last
`{"ok": true, "device": {...}}`.  Without a CUDA device it exits non-zero
and prints no result.
"""

import copy
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from multimodalaggressionrecognition_tpu_torch.cli.serve import (ServeConfig,
                                                                 build_server)
from multimodalaggressionrecognition_tpu_torch.cli.train_multimodal import (
    MultimodalConfig, build_model)
from multimodalaggressionrecognition_tpu_torch.models.layers import (
    seeded_init_)
from multimodalaggressionrecognition_tpu_torch.models.nn1d import BatchNorm1d
from multimodalaggressionrecognition_tpu_torch.models.physverb import (
    IdentityExtractor)
from multimodalaggressionrecognition_tpu_torch.models.swin3d import (
    _attention_mask)
from multimodalaggressionrecognition_tpu_torch.ops.cuda.framed_conv import (
    framed_conv1d, framed_conv1d_reference, out_length)
from multimodalaggressionrecognition_tpu_torch.ops.cuda.window_attention import (
    attention_core_reference, fused_window_attention, window_attention_bwd,
    window_attention_bwd_reference)
from multimodalaggressionrecognition_tpu_torch.train.steps import (
    LossSpec, head_losses_and_metrics)
from multimodalaggressionrecognition_tpu_torch.utils import kernels

SEED = 0
DEVICE = "cuda"
TOL = dict(atol=1e-4, rtol=1e-4)
# full width of the flagship (cli/train_multimodal.py defaults) and of the
# tri-modal model (+ Swin3D-T on 128 frames at 112 px, 8-frame windows)
FLAGSHIP = dict(hidden_size=768, fusion_layers=1, fusion_heads=8,
                audio_samples=80000, text_tokens=48)
TRIMODAL = dict(FLAGSHIP, video_frames=128, video_size=112, video_window=8)
# (modalities, config, served batch, parity batch, launches per forward)
BATCH = 32  # the flagship's served batch: K1's main-path shape
SLICES = [("audio,text", FLAGSHIP, BATCH, BATCH, {"framed_conv1d": 1}),
          ("audio,text,video", TRIMODAL, 8, 2,
           {"framed_conv1d": 1, "window_attention": 12})]
# (name, B, L, F, hop, pad, C, epilogue): tests/test_pallas.py's shapes, a
# non-multiple F/hop, and the CNN1D stem as the served path calls it (its
# BatchNorm and ReLU folded into the epilogue)
K1_SHAPES = [("stem-2x8000", 2, 8000, 160, 40, 80, 64, False),
             ("stft-2x8000", 2, 8000, 512, 256, 0, 128, False),
             ("w2v-2x8000", 2, 8000, 10, 5, 0, 512, False),
             ("epilogue-1x4000", 1, 4000, 160, 40, 80, 64, True),
             ("f147-hop40", 2, 8000, 147, 40, 3, 24, False),
             ("stem-32x80000", BATCH, 80000, 160, 40, 80, 64, True)]
# K2: (W, N, heads, d, nW_img) of tests/test_pallas.py, random masks
K2_TEST_SHAPES = [(8, 24, 3, 8, 4), (6, 49, 3, 32, 3), (4, 12, 2, 16, 0)]
# K2 as the tri-modal b8 forward calls it: 128 windows of 8 frames, patch
# grid 4x28x28, window (8,7,7) clamped to 4 frames; (name, W, N, heads, d,
# nW_img, launches per forward).  Shifted blocks use the real mask of their
# padded grid (K2_GRIDS); stage 2 clamps h and w (no shift), stage 3 all axes.
K2_STAGES = [("stage0-shifted", 2048, 196, 3, 32, 16, 1),
             ("stage0", 2048, 196, 3, 32, 0, 1),
             ("stage1-shifted", 512, 196, 6, 32, 4, 1),
             ("stage1", 512, 196, 6, 32, 0, 1),
             ("stage2", 128, 196, 12, 32, 0, 6),
             ("stage3", 128, 64, 24, 32, 0, 2)]
K2_GRIDS = {16: (4, 28, 28), 4: (4, 14, 14)}
# K3: (W, N, heads, d, nW_img) of tests/test_pallas.py's gradient case,
# masked and not, and a clamped N=64 window; then K2_STAGES
K3_TEST_SHAPES = [(6, 24, 3, 8, 0), (6, 24, 3, 8, 3), (4, 64, 2, 16, 2)]


def peaks(name: str):
    """(f32 non-tensor FLOP/s, HBM bytes/s) from NVIDIA's data sheets."""
    if "PCIe" in name:
        return 51.2e12, 2.0e12
    if "NVL" in name:
        return 60.0e12, 3.9e12
    return 67.0e12, 3.35e12  # H100 SXM


def bound(card: str, flops: float, nbytes: float):
    """The least time the card could take: {bound_ms, bound_by, and both
    terms}."""
    peak_flops, peak_bw = peaks(card)
    ops_ms, bytes_ms = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "ops_ms": ops_ms, "bytes_ms": bytes_ms}


def log(*parts):
    print(*parts, flush=True)


def cuda_ms(fn, reps: int = 30, warm: int = 3) -> float:
    """Mean device time of fn() over `reps` back-to-back calls (CUDA events)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rotating(make, n: int = 4):
    """A fn() that cycles through n argument sets, so that the working set
    exceeds the 50 MB L2 and each call reads its inputs from HBM, as the
    served path (fresh clips every batch) does."""
    sets = [make(i) for i in range(n)]
    state = {"i": 0}

    def call(fn):
        def run():
            state["i"] = (state["i"] + 1) % n
            return fn(*sets[state["i"]])
        return run

    return call


def in_turns(fns, reps: int = 30):
    """{key: min ms} of each fn, timed in turns a, b, ..., ..., b, a."""
    order = list(fns) + list(fns)[::-1]
    times = {k: [] for k in fns}
    for key in order:
        times[key].append(cuda_ms(fns[key], reps=reps))
    return {k: min(v) for k, v in times.items()}


def k1_inputs(b, length, f, c, epilogue, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, length), generator=g)
    w = torch.randn((f, c), generator=g) * 0.05
    bias = torch.randn((c,), generator=g)
    scale = torch.rand((c,), generator=g) + 0.5 if epilogue else None
    shift = torch.randn((c,), generator=g) * 0.2 if epilogue else None
    return [t if t is None else t.to(DEVICE)
            for t in (x, w, bias, scale, shift)]


def k1_phase(card: str):
    """K1 against its plain version at every shape; times at the stem."""
    worst = 0.0
    for name, b, length, f, hop, pad, c, epi in K1_SHAPES:
        x, w, bias, scale, shift = k1_inputs(b, length, f, c, epi, seed=f)
        got = framed_conv1d(x, w, bias, f, hop, pad, scale, shift, relu=epi)
        torch.cuda.synchronize()
        ref = framed_conv1d_reference(x, w, bias, f, hop, pad, scale, shift,
                                      relu=epi)
        err = (got - ref).abs().max().item()
        torch.testing.assert_close(got, ref, **TOL)
        worst = max(worst, err)
        log(f"k1 {name}: B={b} L={length} F={f} hop={hop} pad={pad} C={c} "
            f"epilogue={epi} out={tuple(got.shape)} max_abs_err={err:.3e} ok")

    _, b, length, f, hop, pad, c, _ = K1_SHAPES[-1]
    t = out_length(length, f, hop, pad)

    def make(i):
        x, w, bi, sc, sh = k1_inputs(b, length, f, c, True, seed=100 + i)
        return x, w, bi, sc, sh, w.t().contiguous()[:, None, :]

    call = rotating(make)
    times = in_turns({
        "ms": call(lambda x, w, bi, sc, sh, _: framed_conv1d(
            x, w, bi, f, hop, pad, sc, sh, relu=True)),
        "plain_ms": call(lambda x, w, bi, sc, sh, _: framed_conv1d_reference(
            x, w, bi, f, hop, pad, sc, sh, relu=True)),
        # yardstick only (the port never calls it): cuDNN's conv with bias,
        # in the (B, C, T) layout, without the scale/shift/ReLU epilogue
        "library_ms": call(lambda x, w, bi, sc, sh, w_conv: F.conv1d(
            x[:, None, :], w_conv, bi, stride=hop, padding=pad))})
    flops = 2 * b * t * f * c
    nbytes = 4 * (b * length + f * c + 3 * c + b * t * c)
    bd = bound(card, flops, nbytes)
    log(f"k1 stem timing on {card}: kernel {times['ms']:.4f} ms, plain "
        f"{times['plain_ms']:.4f} ms, F.conv1d {times['library_ms']:.4f} ms, "
        f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}: "
        f"{flops / 1e9:.3f} GFLOP = {bd['ops_ms']:.4f} ms, "
        f"{nbytes / 1e6:.2f} MB = {bd['bytes_ms']:.4f} ms); kernel at "
        f"{bd['bound_ms'] / times['ms'] * 100:.1f}% of the bound")
    return {"max_abs_err": worst, **times, "bound_ms": bd["bound_ms"],
            "bound_by": bd["bound_by"]}


def k2_inputs(w, n, heads, d, nw, seed, stage_mask=False):
    """qkv, bias and mask on the card, drawn there from `seed`."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    c = heads * d
    qkv = torch.randn((w, n, 3 * c), generator=g, device=DEVICE)
    bias = torch.randn((heads, n, n), generator=g, device=DEVICE) * 0.1
    mask = None
    if nw and stage_mask:
        mask = torch.from_numpy(_attention_mask(
            *K2_GRIDS[nw], (4, 7, 7), (0, 3, 3))).to(DEVICE)
    elif nw:
        mask = torch.where(torch.rand((nw, n, n), generator=g,
                                      device=DEVICE) > 0.7, -100.0, 0.0)
    return qkv, bias, mask


def k2_work(w, n, heads, d, nw):
    """(operations, bytes) of one launch: two N x N x d products per window
    and head; qkv, bias and mask read once, the output written once."""
    c = heads * d
    return (4 * w * heads * n * n * d,
            4 * (w * n * 3 * c + heads * n * n + nw * n * n + w * n * c))


def sdpa_args(qkv, bias, mask, heads):
    """q, k, v and attn_mask for F.scaled_dot_product_attention: the same
    function, with windows sharing a mask slot batched as (W/nW, nW*heads,
    N, d).  Made once, outside the timing."""
    w, n, c3 = qkv.shape
    d = c3 // 3 // heads
    nw = 1 if mask is None else mask.shape[0]
    q, k, v = (t.reshape(w // nw, nw * heads, n, d)
               for t in qkv.view(w, n, 3, heads, d).permute(2, 0, 3, 1, 4))
    am = bias[None] if mask is None else (bias[None] + mask[:, None])
    return q, k, v, am.reshape(1, nw * heads, n, n)


def k2_phase(card: str):
    """K2 against its plain version at every shape; at stage 0's shifted
    block the kernel, plain and SDPA times; the kernel's time per stage."""
    worst = 0.0
    shapes = ([(f"test-{w}x{n}-d{d}", w, n, h, d, nw, 1e-5, False)
               for w, n, h, d, nw in K2_TEST_SHAPES]
              + [(name, w, n, h, d, nw, 1e-4, True)
                 for name, w, n, h, d, nw, _ in K2_STAGES])
    for name, w, n, heads, d, nw, tol, stage in shapes:
        qkv, bias, mask = k2_inputs(w, n, heads, d, nw, seed=n * 100 + d,
                                    stage_mask=stage)
        got = fused_window_attention(qkv, bias, mask, heads)
        torch.cuda.synchronize()
        ref = attention_core_reference(qkv, bias, mask, heads)
        err = (got - ref).abs().max().item()
        torch.testing.assert_close(got, ref, atol=tol, rtol=tol)
        worst = max(worst, err)
        log(f"k2 {name}: W={w} N={n} heads={heads} d={d} nW_img={nw} "
            f"out={tuple(got.shape)} max_abs_err={err:.3e} <= {tol:g} ok")

    from torch.nn.attention import SDPBackend, sdpa_kernel

    def sdpa(q, k, v, am):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=am)

    # every stage: the kernel; at the main path's shape (stage 0's shifted
    # block) also the plain version, and there and at stage 2 SDPA
    main, per_stage, fwd_ms, fwd_bound = {}, {}, 0.0, 0.0
    for name, w, n, heads, d, nw, launches in K2_STAGES:
        def make(i):
            return k2_inputs(w, n, heads, d, nw, seed=7 + i, stage_mask=True)

        call = rotating(make)
        fns = {"ms": call(
            lambda q, b, m: fused_window_attention(q, b, m, heads))}
        if name == "stage0-shifted":
            fns["plain_ms"] = call(
                lambda q, b, m: attention_core_reference(q, b, m, heads))
        if name in ("stage0-shifted", "stage2"):
            fns["library_ms"] = rotating(
                lambda i: sdpa_args(*make(i), heads))(sdpa)
        times = in_turns(fns)
        bd = bound(card, *k2_work(w, n, heads, d, nw))
        if name == "stage0-shifted":
            main = {**times, "bound_ms": bd["bound_ms"],
                    "bound_by": bd["bound_by"]}
        per_stage[name] = times["ms"]
        fwd_ms += launches * times["ms"]
        fwd_bound += launches * bd["bound_ms"]
        labels = {"ms": "kernel", "plain_ms": "plain", "library_ms": "SDPA"}
        log(f"k2 {name} x{launches} per forward on {card}: "
            + ", ".join(f"{labels[k]} {v:.4f} ms" for k, v in times.items())
            + f"; bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}: "
            f"operations {bd['ops_ms']:.4f} ms, bytes {bd['bytes_ms']:.4f} "
            f"ms); kernel at {bd['bound_ms'] / times['ms'] * 100:.1f}% of "
            "the bound")
    log(f"k2 per tri-modal b8 forward (12 launches): kernel {fwd_ms:.4f} ms, "
        f"bound {fwd_bound:.4f} ms ({fwd_bound / fwd_ms * 100:.1f}%)")

    # the yardstick computes the same function, and which kernel it takes
    name, w, n, heads, d, nw, _ = K2_STAGES[0]
    qkv, bias, mask = k2_inputs(w, n, heads, d, nw, seed=7, stage_mask=True)
    args = sdpa_args(qkv, bias, mask, heads)
    lib_out = (sdpa(*args).reshape(w, heads, n, d).transpose(1, 2)
               .reshape(w, n, heads * d))
    lib_err = (lib_out - attention_core_reference(qkv, bias, mask, heads)
               ).abs().max().item()
    try:
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            sdpa(*args)
        backend = "its memory-efficient kernel"
    except RuntimeError:
        backend = "another kernel than the memory-efficient one"
    log(f"k2 SDPA at {name}: {backend}, max |d| vs plain {lib_err:.3e}")
    return {"max_abs_err": worst, **main, "ms_by_stage": per_stage,
            "forward_ms": fwd_ms, "forward_bound_ms": fwd_bound}


def k3_work(w, n, heads, d, nw):
    """(operations, bytes) of one backward launch, by the JAX kernel's own
    count: five N x N x d products per window and head; qkv, g, bias and
    mask read once, dqkv and dbias written once."""
    c = heads * d
    return (10 * w * heads * n * n * d,
            4 * (2 * w * n * 3 * c + 2 * heads * n * n + nw * n * n
                 + w * n * c))


def k3_inputs(w, n, heads, d, nw, seed, stage_mask=False):
    qkv, bias, mask = k2_inputs(w, n, heads, d, nw, seed, stage_mask)
    g = torch.randn((w, n, heads * d), device=DEVICE,
                    generator=torch.Generator(device=DEVICE).manual_seed(
                        seed + 1))
    return qkv, bias, mask, g


def sdpa_backward(qkv, bias, mask, g, heads):
    """fn() running only the backward of F.scaled_dot_product_attention on
    the same function, gradients to q, k, v and the float bias + mask; the
    forward runs once, outside the timing."""
    q, k, v, am = (t.detach().requires_grad_()
                   for t in sdpa_args(qkv, bias, mask, heads))
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=am)
    w, n, c3 = qkv.shape
    d = c3 // 3 // heads
    go = g.reshape(w, n, heads, d).transpose(1, 2).reshape(out.shape)
    return lambda: torch.autograd.grad(out, (q, k, v, am), go,
                                       retain_graph=True)


def k3_phase(card: str):
    """K3 against its plain version (dqkv and dbias) at the gradient shapes
    of tests/test_pallas.py (1e-4) and the Swin3D-T stage shapes (1e-4 of
    the largest gradient); at stage 0's shifted block the kernel, plain and
    SDPA-backward times; the kernel's time per stage and per train step."""
    worst = 0.0
    shapes = ([(f"test-{w}x{n}-d{d}", w, n, h, d, nw, False)
               for w, n, h, d, nw in K3_TEST_SHAPES]
              + [(name, w, n, h, d, nw, True)
                 for name, w, n, h, d, nw, _ in K2_STAGES])
    for name, w, n, heads, d, nw, stage in shapes:
        qkv, bias, mask, g = k3_inputs(w, n, heads, d, nw, seed=n + d,
                                       stage_mask=stage)
        got = window_attention_bwd(qkv, bias, mask, g, heads)
        torch.cuda.synchronize()
        want = window_attention_bwd_reference(qkv, bias, mask, g, heads)
        errs = []
        for part, x, y in zip(("dqkv", "dbias"), got, want):
            tol = 1e-4 * (y.abs().max().item() if stage else 1.0)
            err = (x - y).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"k3 {name} {part}: max |d| {err:.3e} "
                                     f"> {tol:.3e}")
            worst = max(worst, err)
            errs.append(f"{part} {err:.3e} <= {tol:.3e}")
        log(f"k3 {name}: W={w} N={n} heads={heads} d={d} nW_img={nw} "
            + ", ".join(errs) + " ok")

    main, per_stage, step_ms, step_bound = {}, {}, 0.0, 0.0
    for name, w, n, heads, d, nw, launches in K2_STAGES:
        def make(i):
            return k3_inputs(w, n, heads, d, nw, seed=17 + i, stage_mask=True)

        call = rotating(make)
        fns = {"ms": call(lambda q, b, m, g: window_attention_bwd(
            q, b, m, g, heads))}
        if name == "stage0-shifted":
            fns["plain_ms"] = call(lambda q, b, m, g:
                                   window_attention_bwd_reference(
                                       q, b, m, g, heads))
            fns["library_ms"] = rotating(
                lambda i: (sdpa_backward(*make(i), heads),))(lambda f: f())
        times = in_turns(fns, reps=10)
        bd = bound(card, *k3_work(w, n, heads, d, nw))
        if name == "stage0-shifted":
            main = {**times, "bound_ms": bd["bound_ms"],
                    "bound_by": bd["bound_by"]}
        per_stage[name] = times["ms"]
        step_ms += launches * times["ms"]
        step_bound += launches * bd["bound_ms"]
        labels = {"ms": "kernel", "plain_ms": "plain",
                  "library_ms": "SDPA backward"}
        log(f"k3 {name} x{launches} per train step on {card}: "
            + ", ".join(f"{labels[k]} {v:.4f} ms" for k, v in times.items())
            + f"; bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}: "
            f"operations {bd['ops_ms']:.4f} ms, bytes {bd['bytes_ms']:.4f} "
            f"ms); kernel at {bd['bound_ms'] / times['ms'] * 100:.1f}% of "
            "the bound")
    log(f"k3 per tri-modal b8 train step (12 launches): kernel {step_ms:.4f} "
        f"ms, bound {step_bound:.4f} ms ({step_bound / step_ms * 100:.1f}%)")
    return {"max_abs_err": worst, **main, "ms_by_stage": per_stage,
            "train_step_ms": step_ms, "train_step_bound_ms": step_bound}


def kernel_breakdown(fn, reps: int = 5):
    """Device time per call of fn() by kernel family (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    families = {}
    for e in prof.key_averages():
        if e.self_cpu_time_total > 0 or e.self_device_time_total <= 0:
            continue  # host-side rows; kernels have device time only
        name = e.key.lower()
        # cuDNN's implicit-GEMM convs are named "...fprop_implicit_gemm..."
        family = ("framed_conv1d (K1)" if "framed_conv1d" in name
                  else "window_attention_bwd (K3)"
                  if "window_attention_bwd" in name or "sum_groups" in name
                  else "window_attention (K2)" if "window_attention" in name
                  else "Adam (multi-tensor)" if "multi_tensor" in name
                  else "cuDNN conv (CNN1D trunk, patch embed)"
                  if "fprop" in name or "conv" in name
                  else "gemm (Linear, fusion attention)" if "gemm" in name
                  else "LayerNorm" if "layer_norm" in name
                  else "roll, copies, pads, concat" if any(
                      k in name for k in ("roll", "copy", "pad", "cat"))
                  else "other elementwise, GELU, reductions")
        families[family] = (families.get(family, 0.0)
                            + e.self_device_time_total / reps / 1e3)
    return families


def full_batch(cfg, modalities, n: int, seed: int):
    """A full-width batch: zero-padded text tails and, past two rows, one
    absent row."""
    g = torch.Generator().manual_seed(seed)
    data = {}
    if "audio" in modalities:
        data["audio"] = torch.randn((n, cfg["audio_samples"]), generator=g) * 0.1
    if "text" in modalities:
        text = torch.randn((n, cfg["text_tokens"], cfg["hidden_size"]),
                           generator=g)
        for i in range(0, n, 3):
            text[i, 20 + i:] = 0.0  # zero-padded (masked) token rows
        data["text"] = text
    if "video" in modalities:
        size = cfg["video_size"]
        data["video"] = torch.randn((n, cfg["video_frames"], size, size, 3),
                                    generator=g)
    present = torch.ones(n)
    if n > 2:
        present[-1] = 0.0  # absent row: every token masked
    return {m: {"data": d, "present": present} for m, d in data.items()}


def to_device(tree, device):
    """Nested dicts of tensors, moved to `device`."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


@torch.no_grad()
def seeded_model(cfg, modalities):
    """The seeded model with non-trivial BatchNorm statistics and LayerNorm
    parameters.  With the initial LayerNorm (weight 1, bias 0) every token
    of the Swin tower's mean-pooled output sums to ~1e-6, and the fusion
    masks a token whose features sum to exactly 0: rounding would decide."""
    model = seeded_init_(build_model(MultimodalConfig(**cfg), modalities), SEED)
    g = torch.Generator().manual_seed(SEED + 1)
    for m in model.modules():
        if isinstance(m, BatchNorm1d):
            m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g)
                                 * 0.1)
            m.running_var.copy_(torch.rand(m.running_var.shape, generator=g)
                                + 0.5)
        elif isinstance(m, torch.nn.LayerNorm):
            m.weight.copy_(1.0 + 0.1 * torch.randn(m.weight.shape, generator=g))
            m.bias.copy_(0.05 * torch.randn(m.bias.shape, generator=g))
    return model.eval()


def parity_phase(label, cfg, modalities, n: int):
    """(a) The same seeded model on the card and on the CPU: each tower's
    features and the logits."""
    model = seeded_model(cfg, modalities)
    gpu = copy.deepcopy(model).to(DEVICE)
    batch = full_batch(cfg, modalities, n, SEED + 2)

    def run(m, b):  # PhysVerbModel.forward, keeping the features
        feats = m.extract_features(b)
        return feats, m.classifier(m.fusion(feats))

    with torch.inference_mode():
        t0 = time.monotonic()
        want_feats, want = run(model, batch)
        cpu_s = time.monotonic() - t0
        got_feats, got = run(gpu, to_device(batch, DEVICE))
        torch.cuda.synchronize()
    for h in want:
        if got[h].shape != (n, 2) or not torch.isfinite(got[h]).all():
            raise AssertionError(f"head {h}: bad logits {got[h].shape}")
    err = max((got[h].cpu() - want[h]).abs().max().item() for h in want)
    feat_err = {m: (got_feats[m].cpu() - want_feats[m]).abs().max().item()
                for m in want_feats}
    if err > 1e-3 or max(feat_err.values()) > 1e-3:
        raise AssertionError(f"{label}: GPU vs CPU logits differ by {err:.3e}, "
                             f"features by {feat_err} (limit 1e-3)")
    scale = max(want[h].abs().max().item() for h in want)
    log(f"slice {label} parity: b{n} full width, cuda vs cpu max |dlogit| "
        f"{err:.3e} <= 1e-3 ok (max |logit| {scale:.3e}); max |dfeature| "
        + ", ".join(f"{m} {e:.3e}" for m, e in feat_err.items())
        + f"; cpu forward {cpu_s:.2f} s")
    return err


def _http(srv, path, body=None, ctype="application/json"):
    host, port = srv.server_address[:2]
    req = urllib.request.Request(f"http://{host}:{port}{path}", data=body,
                                 headers={"Content-Type": ctype},
                                 method="POST" if body is not None else "GET")
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _check_scores(got, n):
    for head in ("phys", "verb"):
        probs = np.asarray(got[head])
        if probs.shape != (n, 2) or not np.isfinite(probs).all():
            raise AssertionError(f"{head}: bad scores shape {probs.shape}")
        if np.abs(probs.sum(1) - 1.0).max() > 1e-3:  # rounded to 4 dp
            raise AssertionError(f"{head}: probabilities do not sum to 1")


def request(rng, cfg, modalities, n: int, short: bool = False):
    """{modality: (n, ...)} float32 clips; `short` clips are padded by the
    server (5/8 of the samples, half the tokens, 12 frames)."""
    out = {}
    if "audio" in modalities:
        length = cfg["audio_samples"] * 5 // 8 if short else cfg["audio_samples"]
        out["audio"] = rng.standard_normal((n, length)) * 0.1
    if "text" in modalities:
        tokens = cfg["text_tokens"] // 2 if short else cfg["text_tokens"]
        out["text"] = rng.standard_normal((n, tokens, cfg["hidden_size"]))
    if "video" in modalities:
        size = cfg["video_size"]
        frames = 12 if short else cfg["video_frames"]
        out["video"] = rng.standard_normal((n, frames, size, size, 3))
    return {m: a.astype(np.float32) for m, a in out.items()}


def _npz(arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def serving_phase(srv, label, cfg, modalities, per_forward):
    """(b) Drive the main path: /score over HTTP, JSON and npz."""
    rng = np.random.default_rng(SEED + 3)
    batch_size = srv.predictor.batch_size
    short = json.dumps({m: a[0].round(4).tolist() for m, a in request(
        rng, cfg, modalities, 1, short=True).items()}).encode()
    # a batch larger than the fixed size: chunked into batch_size + the rest
    n_big = batch_size + batch_size // 4
    big = _npz(request(rng, cfg, modalities, n_big))
    singles = [_npz({m: a[0] for m, a in request(rng, cfg, modalities,
                                                 1).items()})
               for _ in range(4)]

    dispatches0 = _http(srv, "/statz")["model"]["dispatches"]
    kernels.launch_counts.clear()  # count this path only
    _check_scores(_http(srv, "/score", short), 1)
    _check_scores(_http(srv, "/score", big, "application/x-npz"), n_big)
    # concurrent single clips, coalesced by the micro-batcher
    results = [None] * len(singles)

    def hit(i):
        results[i] = _http(srv, "/score", singles[i], "application/x-npz")

    threads = [threading.Thread(target=hit, args=(i,))
               for i in range(len(singles))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    for r in results:
        _check_scores(r, 1)
    torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)  # read just after the main path
    stats = _http(srv, "/statz")["model"]
    dispatches = stats["dispatches"] - dispatches0
    if dispatches < 3:
        raise AssertionError(f"/statz dispatches advanced by {dispatches}")
    for name in set(per_forward) | set(counts):
        want = per_forward.get(name, 0) * dispatches
        if counts.get(name, 0) != want:
            raise AssertionError(
                f"{label}: {name} launched {counts.get(name, 0)} times in "
                f"{dispatches} served forwards, want {want}")
    log(f"slice {label} serving: 6 requests (JSON 1 short clip, npz {n_big} "
        f"clips, 4 concurrent npz clips) -> {dispatches} forwards, launches "
        f"{counts}, mean group {stats.get('mean_group_size')} ok")
    return counts


def throughput_phase(srv, label, cfg, modalities, card_line):
    """(c) Predictor.predict at the served batch, the forward by tower and
    by kernel family, and MicroBatcher single-clip p50."""
    pred, batcher = srv.predictor, srv.batcher
    gpu, batch_size = pred.model, pred.batch_size
    rng = np.random.default_rng(SEED + 4)
    req = request(rng, cfg, modalities, batch_size)
    host_mb = sum(a.nbytes for a in req.values()) / 1e6
    for _ in range(2):
        pred.predict(req)
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        pred.predict(req)  # ends in a device-to-host copy of the scores
    secs = time.perf_counter() - t0
    clips_s = batch_size * reps / secs

    on_card = to_device(full_batch(cfg, modalities, batch_size, SEED + 5),
                        DEVICE)
    towers = {}
    with torch.inference_mode():
        fwd = cuda_ms(lambda: gpu(on_card), reps=reps)
        for m, ext in gpu.extractors.items():
            if not isinstance(ext, IdentityExtractor):
                towers[m] = cuda_ms(lambda: ext(on_card[m]["data"]), reps=reps)
        trunk = cuda_ms(lambda: gpu.extractors["audio"].extractor(
            on_card["audio"]["data"]), reps=reps)
        feats = gpu.extract_features(on_card)
        rest = cuda_ms(lambda: gpu.classifier(gpu.fusion(feats)), reps=reps)
        families = kernel_breakdown(lambda: gpu(on_card), reps=3)
    busy = sum(families.values())
    log(f"slice {label} forward kernels by family (b{batch_size}, ms per "
        "forward): " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(
            families.items(), key=lambda kv: -kv[1]))
        + f"; sum {busy:.4f} ms = {busy / fwd * 100:.1f}% of the "
        f"{fwd:.3f} ms forward, the rest is the card idle between launches")
    lat = []
    clip = {k: v[:1] for k, v in req.items()}
    for _ in range(20):
        t1 = time.perf_counter()
        batcher.submit(clip).result(timeout=120)
        lat.append((time.perf_counter() - t1) * 1e3)
    p50 = float(np.median(lat))
    log(f"slice {label} throughput on {card_line}: Predictor.predict "
        f"b{batch_size} {clips_s:.1f} clips/s ({secs / reps * 1e3:.3f} "
        f"ms/batch incl. host pad + {host_mb:.1f} MB pageable copy); device "
        f"forward b{batch_size} {fwd:.3f} ms = "
        + " + ".join(f"{m} tower {t:.3f} ms" + (
            f" (CNN1D trunk {trunk:.3f} ms)" if m == "audio" else "")
            for m, t in towers.items())
        + f" + fusion/adaptors/heads {rest:.3f} ms; MicroBatcher "
        f"single-clip p50 {p50:.3f} ms "
        f"(max_delay_ms {batcher.max_delay * 1e3:.1f}, 20 sequential)")
    return {"predict_clips_per_s": clips_s, "predict_ms": secs / reps * 1e3,
            "forward_ms": fwd, "tower_ms": towers,
            "fusion_heads_ms": rest, "kernel_ms_by_family": families,
            "kernel_busy_pct": busy / fwd * 100, "p50_ms": p50}


def run_slice(label, cfg, batch_size, parity_n, per_forward, card_line):
    modalities = tuple(sorted(label.split(",")))
    err = parity_phase(label, cfg, modalities, parity_n)
    srv = build_server(ServeConfig(**cfg, modalities=label,
                                   batch_size=batch_size, device=DEVICE,
                                   allow_random_weights=True, port=0,
                                   seed=SEED))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        counts = serving_phase(srv, label, cfg, modalities, per_forward)
        numbers = throughput_phase(srv, label, cfg, modalities, card_line)
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.close()
        thread.join(timeout=60)
    log(json.dumps({"slice": label, "batch": batch_size,
                    "parity_max_abs_logit_err": err, "launches": counts,
                    **numbers}))
    return counts


# the train path: the tri-modal model fine-tuned at full width, batch 8
TRAIN = dict(TRIMODAL, batch_size=8)
TRAIN_DATA = dict(num_clusters=4, samples_per_cluster=12, seed=SEED,
                  audio_len=TRAIN["audio_samples"],
                  text_len=TRAIN["text_tokens"],
                  video_frames=TRAIN["video_frames"],
                  video_hw=TRAIN["video_size"])
# launches per train step, by presence pattern (remat on: K2 runs again in
# each block's recompute)
PER_PATTERN = {"video": {"window_attention": 24, "window_attention_bwd": 12},
               "audio,text": {"framed_conv1d": 1},
               "audio,text,video": {"framed_conv1d": 1,
                                    "window_attention": 24,
                                    "window_attention_bwd": 12}}
SPECS = {"phys": LossSpec("focal", class_weights=(0.5, 0.5), gamma=2.0),
         "verb": LossSpec("ce")}


def train_parity(n: int = 1, frames: int = 16):
    """The loss and every gradient of one batch of the full-width model,
    unfrozen, eval mode (deterministic), on the card against the CPU:
    each within 1e-3 * max|g| of that tensor."""
    cfg = dict(TRIMODAL, video_frames=frames, video_freeze=False)
    modalities = ("audio", "text", "video")
    cpu = seeded_model(cfg, modalities)
    gpu = copy.deepcopy(cpu).to(DEVICE)
    data = full_batch(cfg, modalities, n, SEED + 6)
    batch = {"modalities": data,
             "labels": {"phys": torch.ones(n, dtype=torch.int32),
                        "verb": torch.zeros(n, dtype=torch.int32)},
             "label_mask": {"phys": torch.ones(n), "verb": torch.ones(n)}}
    losses = {}
    for name, model, b in (("cpu", cpu, batch),
                           ("cuda", gpu, to_device(batch, DEVICE))):
        total, _ = head_losses_and_metrics(model(b["modalities"]), b, SPECS, 2)
        total.backward()
        losses[name] = total.item()
    loss_err = abs(losses["cuda"] - losses["cpu"])
    if not loss_err <= 1e-3 * abs(losses["cpu"]):
        raise AssertionError(f"train parity: loss cuda {losses['cuda']} vs "
                             f"cpu {losses['cpu']}")
    worst, count = 0.0, 0
    gpu_params = dict(gpu.named_parameters())
    for name, p in cpu.named_parameters():
        want, got = p.grad, gpu_params[name].grad
        if want is None or got is None:
            raise AssertionError(f"train parity: {name} has no gradient")
        scale = want.abs().max().item()
        err = (got.cpu() - want).abs().max().item()
        if not err <= 1e-3 * scale:
            raise AssertionError(f"train parity: {name} gradient differs by "
                                 f"{err:.3e} > 1e-3 * {scale:.3e}")
        worst = max(worst, err / scale if scale else 0.0)
        count += 1
    log(f"train parity: b{n} {frames} frames full width, unfrozen, loss cuda "
        f"{losses['cuda']:.6f} vs cpu {losses['cpu']:.6f}; {count} "
        f"gradients, worst max |d| / max |g| {worst:.3e} <= 1e-3 ok")
    return {"loss_err": loss_err, "grad_rel_err": worst}


def step_counts(trainer, batch):
    """Launch counts of one train step on `batch`, reset just before."""
    torch.cuda.synchronize()
    kernels.launch_counts.clear()
    trainer.train_step(batch)
    torch.cuda.synchronize()
    return dict(kernels.launch_counts)


def median_step_ms(trainer, batch, steps: int = 6, warm: int = 2):
    """Median device time of one train step (CUDA events) and the peak
    device memory over those steps."""
    for _ in range(warm):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        trainer.train_step(batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), torch.cuda.max_memory_allocated() / 2**30


def train_phase(card_line):
    """Fine-tune the tri-modal model through cli.train_multimodal.main, at
    full width, b8, 2 epochs on a synthetic set; check its outputs, the
    launches per presence pattern, card-vs-CPU gradients; time the step."""
    import pandas as pd

    from multimodalaggressionrecognition_tpu_torch.cli import train_multimodal
    from multimodalaggressionrecognition_tpu_torch.data.synthetic import (
        generate_synthetic_avabos)

    parity = train_parity()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        root = os.path.join(tmp, "avabos")
        generate_synthetic_avabos(root, **TRAIN_DATA)
        data_s = time.monotonic() - t0
        args = ["--dataset_root", root, "--synthetic",
                "--saving_dir", os.path.join(tmp, "runs"), "--run_name", "r",
                "--modalities", "audio,text,video", "--video_freeze", "false",
                "--epoch_num", "2", "--device", DEVICE, "--num_threads", "4"]
        for k in ("hidden_size", "fusion_layers", "fusion_heads",
                  "audio_samples", "text_tokens", "video_frames",
                  "video_size", "video_window", "batch_size"):
            args += [f"--{k}", str(TRAIN[k])]
        torch.cuda.synchronize()
        kernels.launch_counts.clear()  # count this path only
        t0 = time.monotonic()
        trainer = train_multimodal.main(args)
        torch.cuda.synchronize()
        counts = dict(kernels.launch_counts)  # read just after the main path
        fit_s = time.monotonic() - t0
        steps = trainer.state.step
        video_steps = counts.get("window_attention_bwd", 0) // 12
        if steps < 6 or video_steps < 3:
            raise AssertionError(f"train: {steps} steps, {video_steps} with "
                                 "video (want >= 6 and >= 3)")
        files = set(os.listdir(trainer.run_dir))
        need = {"checkpoint_current", "checkpoint_best_phys",
                "checkpoint_best_verb", "config.json"} | {
            f"{h}_{s}_log.csv" for h in ("phys", "verb")
            for s in ("train", "test")}
        if not need <= files:
            raise AssertionError(f"train: missing {sorted(need - files)}")
        logs = {f: pd.read_csv(os.path.join(trainer.run_dir, f))
                for f in need if f.endswith("_log.csv")}
        for f, df in logs.items():
            if df["epoch"].tolist() != [0, 1] or not np.isfinite(
                    df["loss"]).all():
                raise AssertionError(f"train: {f} holds {df.to_dict()}")
        clips_s = [float(v) for v in
                   logs["verb_train_log.csv"]["clips_per_sec"]]
        log(f"train main path: cli.train_multimodal.main, 2 epochs, {steps} "
            f"steps ({video_steps} with video), launches {counts}; data set "
            f"made in {data_s:.1f} s, fit {fit_s:.1f} s; epoch clips/s "
            f"{clips_s} (epoch 0 includes the first step's set-up)")

        # one step of each presence pattern, launches reset around it
        patterns = {}
        for batch in trainer.batches(trainer.train_loader):
            key = ",".join(sorted(batch["modalities"]))
            patterns.setdefault(key, batch)
        if sorted(patterns) != sorted(PER_PATTERN):
            raise AssertionError(
                f"train: presence patterns {sorted(patterns)}")
        per_pattern = {}
        for key, batch in sorted(patterns.items()):
            got = step_counts(trainer, batch)
            if got != PER_PATTERN[key]:
                raise AssertionError(f"train: a {key} step launched {got}, "
                                     f"want {PER_PATTERN[key]}")
            per_pattern[key] = got
        log(f"train launches per step by pattern: {per_pattern} ok")

        batch = patterns["audio,text,video"]
        swin = trainer.state.model.extractors["video"].backbone.backbone
        timing = {}
        for remat in (True, False):
            swin.remat = remat
            timing[remat] = median_step_ms(trainer, batch)
        swin.remat = True
        families = kernel_breakdown(lambda: trainer.train_step(batch), reps=2)
    busy = sum(families.values())
    (on_ms, on_gb), (off_ms, off_gb) = timing[True], timing[False]
    log(f"train step b8 (audio,text,video, 128 frames at 112 px) on "
        f"{card_line}: median {on_ms:.3f} ms, peak {on_gb:.2f} GiB with "
        f"remat; {off_ms:.3f} ms, peak {off_gb:.2f} GiB without")
    log("train step kernels by family (ms per step, remat on): "
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(
            families.items(), key=lambda kv: -kv[1]))
        + f"; sum {busy:.4f} ms = {busy / on_ms * 100:.1f}% of the "
        f"{on_ms:.3f} ms step")
    log(json.dumps({"train": "audio,text,video", "batch": TRAIN["batch_size"],
                    "video_freeze": False, "steps": steps,
                    "launches": counts, "launches_per_pattern": per_pattern,
                    "step_ms_remat": on_ms, "step_ms_no_remat": off_ms,
                    "peak_gib_remat": on_gb, "peak_gib_no_remat": off_gb,
                    "epoch_clips_per_s": clips_s,
                    "kernel_ms_by_family": families,
                    "kernel_busy_pct": busy / on_ms * 100, **parity}))
    return counts


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card_line = smi.splitlines()[0]
    log(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.monotonic()
    libs = kernels.build_all()
    log(f"build: {sorted(libs)} in {time.monotonic() - t0:.1f} s (nvcc, sm_90a)")

    k1 = k1_phase(name)
    k2 = k2_phase(name)
    k3 = k3_phase(name)
    launches = {label: run_slice(label, cfg, bs, parity_n, per_forward,
                                 card_line)
                for label, cfg, bs, parity_n, per_forward in SLICES}
    main_path = "train"  # this slice's path runs every kernel
    launches[main_path] = train_phase(card_line)

    def entry(kernel, source, replaces, numbers):
        return {"name": kernel, "route": "cuda",
                "source": f"multimodalaggressionrecognition_tpu_torch/csrc/"
                          f"{source}",
                "replaces": f"multimodalaggressionrecognition_tpu/{replaces}",
                "launches": launches[main_path].get(kernel, 0),
                "launches_by_path": {p: c.get(kernel, 0)
                                     for p, c in launches.items()},
                **numbers, "status": "ok"}

    log(json.dumps({"kernels": [
        entry("framed_conv1d", "framed_conv.cu",
              "ops/pallas/framed_conv.py:54", k1),
        entry("window_attention", "window_attention.cu",
              "ops/pallas/window_attention.py:112", k2),
        entry("window_attention_bwd", "window_attention_bwd.cu",
              "ops/pallas/window_attention.py:224", k3)]}))
    log(card_line)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
