#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (multimodalaggressionrecognition_tpu_torch).

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  1. device   - the card's name, `nvidia-smi` name and power limit, versions;
                TF32 off, so every f32 comparison below means f32.
  2. build    - nvcc for sm_90a of every kernel source, all started together.
  3. kernels  - each kernel against its plain PyTorch version on the card, at
                the JAX tests' shapes and at the main path's shape, atol/rtol
                1e-4 (both f32; only the summation order differs); at the main
                path's shape also the kernel's, the plain version's and one
                library call's time, and the least time the card could take.
  4. slice    - the audio,text flagship at full width (hidden 768, 80 000
                samples, 48 tokens, 1 fusion layer, 8 heads, batch 32) with
                seeded random weights:
                (a) logits on the card against the same model on the CPU, 1e-3;
                (b) the HTTP server (cli/serve.build_server) answering JSON and
                    npz /score requests, with the kernels' launch counts reset
                    just before and read just after: every kernel must have
                    launched, once per forward;
                (c) throughput of Predictor.predict at batch 32, the forward's
                    time by stage, and MicroBatcher single-clip p50 latency.
Prints a `kernels` JSON line, the card's name and power limit, and last
`{"ok": true, "device": {...}}`.  Without a CUDA device it exits non-zero and
prints no result.
"""

import copy
import io
import json
import subprocess
import sys
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
from multimodalaggressionrecognition_tpu_torch.ops.cuda.framed_conv import (
    framed_conv1d, framed_conv1d_reference, out_length)
from multimodalaggressionrecognition_tpu_torch.utils import kernels

SEED = 0
DEVICE = "cuda"
TOL = dict(atol=1e-4, rtol=1e-4)
# full width of the flagship (cli/train_multimodal.py defaults)
FULL = dict(hidden_size=768, fusion_layers=1, fusion_heads=8,
            audio_samples=80000, text_tokens=48)
BATCH = 32
# (name, B, L, F, hop, pad, C, epilogue): tests/test_pallas.py's shapes, a
# non-multiple F/hop, and the CNN1D stem as the served path calls it (its
# BatchNorm and ReLU folded into the epilogue)
K1_SHAPES = [("stem-2x8000", 2, 8000, 160, 40, 80, 64, False),
             ("stft-2x8000", 2, 8000, 512, 256, 0, 128, False),
             ("w2v-2x8000", 2, 8000, 10, 5, 0, 512, False),
             ("epilogue-1x4000", 1, 4000, 160, 40, 80, 64, True),
             ("f147-hop40", 2, 8000, 147, 40, 3, 24, False),
             ("stem-32x80000", BATCH, 80000, 160, 40, 80, 64, True)]


def peaks(name: str):
    """(f32 non-tensor FLOP/s, HBM bytes/s) from NVIDIA's data sheets."""
    if "PCIe" in name:
        return 51.2e12, 2.0e12
    if "NVL" in name:
        return 60.0e12, 3.9e12
    return 67.0e12, 3.35e12  # H100 SXM


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


def k1_inputs(b, length, f, c, epilogue, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, length), generator=g)
    w = torch.randn((f, c), generator=g) * 0.05
    bias = torch.randn((c,), generator=g)
    scale = torch.rand((c,), generator=g) + 0.5 if epilogue else None
    shift = torch.randn((c,), generator=g) * 0.2 if epilogue else None
    return [t if t is None else t.to(DEVICE)
            for t in (x, w, bias, scale, shift)]


def kernel_phase(card: str):
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
    kern = call(lambda x, w, bi, sc, sh, _: framed_conv1d(
        x, w, bi, f, hop, pad, sc, sh, relu=True))
    plain = call(lambda x, w, bi, sc, sh, _: framed_conv1d_reference(
        x, w, bi, f, hop, pad, sc, sh, relu=True))
    # yardstick only (the port never calls it): cuDNN's conv with bias, in
    # the (B, C, T) layout, without the scale/shift/ReLU epilogue
    library = call(lambda x, w, bi, sc, sh, w_conv: F.conv1d(
        x[:, None, :], w_conv, bi, stride=hop, padding=pad))
    # in turns: kernel, plain, library, library, plain, kernel
    times = {"ms": [], "plain_ms": [], "library_ms": []}
    for key in ("ms", "plain_ms", "library_ms", "library_ms", "plain_ms", "ms"):
        fn = {"ms": kern, "plain_ms": plain, "library_ms": library}[key]
        times[key].append(cuda_ms(fn))
    times = {k: min(v) for k, v in times.items()}
    flops = 2 * b * t * f * c
    nbytes = 4 * (b * length + f * c + 3 * c + b * t * c)
    peak_flops, peak_bw = peaks(card)
    bound_ops, bound_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    bound = {"bound_ms": max(bound_ops, bound_bytes),
             "bound_by": "operations" if bound_ops >= bound_bytes else "bytes"}
    log(f"k1 stem timing on {card}: kernel {times['ms']:.4f} ms, plain "
        f"{times['plain_ms']:.4f} ms, F.conv1d {times['library_ms']:.4f} ms, "
        f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}: "
        f"{flops / 1e9:.3f} GFLOP at {peak_flops / 1e12:.1f} TFLOP/s = "
        f"{bound_ops:.4f} ms, {nbytes / 1e6:.2f} MB at {peak_bw / 1e12:.2f} "
        f"TB/s = {bound_bytes:.4f} ms); kernel at "
        f"{bound['bound_ms'] / times['ms'] * 100:.1f}% of the bound")
    return {"max_abs_err": worst, **times, **bound}


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
                  else "cuDNN conv (trunk)" if "fprop" in name or "conv" in name
                  else "gemm (Linear, attention)" if "gemm" in name
                  else "elementwise, norm, pool, copy")
        families[family] = (families.get(family, 0.0)
                            + e.self_device_time_total / reps / 1e3)
    return families


def full_batch(seed: int):
    """A full-width batch: zero-padded text tails and one absent row."""
    g = torch.Generator().manual_seed(seed)
    audio = torch.randn((BATCH, FULL["audio_samples"]), generator=g) * 0.1
    text = torch.randn((BATCH, FULL["text_tokens"], FULL["hidden_size"]),
                       generator=g)
    for i in range(0, BATCH, 3):
        text[i, 20 + i:] = 0.0  # zero-padded (masked) token rows
    present = torch.ones(BATCH)
    present[-1] = 0.0  # absent row: every token masked
    return {"audio": {"data": audio, "present": present},
            "text": {"data": text, "present": present}}


def to(batch, device):
    return {m: {k: v.to(device) for k, v in d.items()} for m, d in batch.items()}


def parity_phase():
    """(a) The same seeded model on the card and on the CPU."""
    model = seeded_init_(build_model(MultimodalConfig(**FULL), ("audio", "text")),
                         SEED)
    g = torch.Generator().manual_seed(SEED + 1)
    for m in model.modules():  # non-trivial BatchNorm statistics
        if isinstance(m, BatchNorm1d):
            m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g)
                                 * 0.1)
            m.running_var.copy_(torch.rand(m.running_var.shape, generator=g)
                                + 0.5)
    model.eval()
    gpu = copy.deepcopy(model).to(DEVICE)
    batch = full_batch(SEED + 2)
    with torch.inference_mode():
        t0 = time.monotonic()
        want = model(batch)
        cpu_s = time.monotonic() - t0
        got = gpu(to(batch, DEVICE))
        torch.cuda.synchronize()
    err = max((got[h].cpu() - want[h]).abs().max().item() for h in want)
    for h in want:
        if got[h].shape != (BATCH, 2) or not torch.isfinite(got[h]).all():
            raise AssertionError(f"head {h}: bad logits {got[h].shape}")
    if err > 1e-3:
        raise AssertionError(f"GPU vs CPU logits differ by {err:.3e} > 1e-3")
    scale = max(want[h].abs().max().item() for h in want)
    log(f"slice parity: b{BATCH} full width, cuda vs cpu max |dlogit| "
        f"{err:.3e} <= 1e-3 ok (max |logit| {scale:.3e}; cpu forward "
        f"{cpu_s:.2f} s)")
    return batch


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


def serving_phase(srv):
    """(b) Drive the main path: /score over HTTP, JSON and npz."""
    rng = np.random.default_rng(SEED + 3)
    hidden, samples, tokens = (FULL["hidden_size"], FULL["audio_samples"],
                               FULL["text_tokens"])

    def clip_json(length, n_tokens):
        return json.dumps({
            "audio": (rng.standard_normal(length) * 0.1).round(4).tolist(),
            "text": rng.standard_normal((n_tokens, hidden)).round(4).tolist(),
        }).encode()

    # a batch larger than the fixed size: chunked into BATCH + the rest
    n_big = BATCH + BATCH // 4
    buf = io.BytesIO()
    np.savez(buf, audio=(rng.standard_normal((n_big, samples)) * 0.1)
             .astype(np.float32),
             text=rng.standard_normal((n_big, tokens, hidden)).astype(np.float32))
    short = clip_json(samples * 5 // 8, tokens // 2)  # padded server-side
    singles = [clip_json(samples, tokens) for _ in range(4)]

    dispatches0 = _http(srv, "/statz")["model"]["dispatches"]
    kernels.launch_counts.clear()  # count the main path only
    _check_scores(_http(srv, "/score", short), 1)
    _check_scores(_http(srv, "/score", buf.getvalue(), "application/x-npz"),
                  n_big)
    # concurrent single clips, coalesced by the micro-batcher
    results = [None] * len(singles)

    def hit(i):
        results[i] = _http(srv, "/score", singles[i])

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
    for name in ("framed_conv1d",):
        if counts.get(name, 0) != dispatches:
            raise AssertionError(f"{name} launched {counts.get(name, 0)} times "
                                 f"in {dispatches} served forwards")
    log(f"slice serving: 6 requests (JSON 1 short clip, npz {n_big} clips, "
        f"4 concurrent clips) -> {dispatches} forwards, launches {counts}, "
        f"mean group {stats.get('mean_group_size')} ok")
    return counts


def throughput_phase(srv, batch, card_line):
    """(c) Predictor.predict at b32, the forward by stage, and p50."""
    pred, batcher = srv.predictor, srv.batcher
    gpu = pred.model
    rng = np.random.default_rng(SEED + 4)
    hidden = FULL["hidden_size"]
    req = {"audio": (rng.standard_normal((BATCH, FULL["audio_samples"]))
                     * 0.1).astype(np.float32),
           "text": rng.standard_normal((BATCH, FULL["text_tokens"], hidden))
           .astype(np.float32)}
    for _ in range(3):
        pred.predict(req)
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        pred.predict(req)  # ends in a device-to-host copy of the scores
    secs = time.perf_counter() - t0
    clips_s = BATCH * reps / secs

    on_card = to(batch, DEVICE)
    audio = on_card["audio"]["data"]
    with torch.inference_mode():
        fwd = cuda_ms(lambda: gpu(on_card), reps=20)
        tower = cuda_ms(lambda: gpu.extractors["audio"](audio), reps=20)
        trunk = cuda_ms(lambda: gpu.extractors["audio"].extractor(audio),
                        reps=20)
        families = kernel_breakdown(lambda: gpu(on_card))
    busy = sum(families.values())
    log(f"forward kernels by family (b{BATCH}, ms per forward): "
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(
            families.items(), key=lambda kv: -kv[1]))
        + f"; sum {busy:.4f} ms = {busy / fwd * 100:.1f}% of the "
        f"{fwd:.3f} ms forward, the rest is the card idle between launches")
    lat = []
    clip = {k: v[:1] for k, v in req.items()}
    for _ in range(30):
        t1 = time.perf_counter()
        batcher.submit(clip).result(timeout=60)
        lat.append((time.perf_counter() - t1) * 1e3)
    p50 = float(np.median(lat))
    log(f"slice throughput on {card_line}: Predictor.predict b{BATCH} "
        f"{clips_s:.1f} clips/s ({secs / reps * 1e3:.3f} ms/batch incl. host "
        f"pad + copies); device forward b{BATCH} {fwd:.3f} ms = audio tower "
        f"{tower:.3f} ms (CNN1D trunk {trunk:.3f} ms, adaptor "
        f"{tower - trunk:.3f} ms) + fusion/heads {fwd - tower:.3f} ms; "
        f"MicroBatcher single-clip p50 {p50:.3f} ms "
        f"(max_delay_ms {batcher.max_delay * 1e3:.1f}, 30 sequential)")


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

    k1 = kernel_phase(name)
    batch = parity_phase()
    srv = build_server(ServeConfig(**FULL, batch_size=BATCH, device=DEVICE,
                                   allow_random_weights=True, port=0,
                                   seed=SEED))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        counts = serving_phase(srv)
        throughput_phase(srv, batch, card_line)
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.close()
        thread.join(timeout=60)

    log(json.dumps({"kernels": [{
        "name": "framed_conv1d", "route": "cuda",
        "source": "multimodalaggressionrecognition_tpu_torch/csrc/framed_conv.cu",
        "replaces": "multimodalaggressionrecognition_tpu/ops/pallas/"
                    "framed_conv.py:54",
        "launches": counts["framed_conv1d"], **k1, "status": "ok"}]}))
    log(card_line)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
