"""Each metric reader on a small recorded run: a trace of the kernels a b8
tri-modal step launches, the host spans and the step events."""

import json
import os

import pytest

from portbench.harness import RunRecord, _union_s, breakdown, read_metric
from portbench.yardstick import launches as L
from portbench.yardstick import peaks as P

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CARD = "NVIDIA H100 80GB HBM3"
KERNEL_NAMES = {  # one name per family, as the profiler shows them
    "framed_conv1d": "framed_conv1d_kernel<64>(float const*, ...)",
    "window_attention": "window_attention_kernel<32>(float const*, ...)",
    "window_attention_bwd": "window_attention_bwd_kernel<32>(...)",
    "roll": "roll_kernel<float4>(float const*, ...)",
}


def record(job, steps=4, share=0.5):
    """A run whose every hand-written kernel ran at `share` of its
    roofline, with a 1 ms GEMM and a 1 ms gap per step."""
    with open(os.path.join(ROOT, "portbench", "configs",
                           "trimodal_swin3d_t.json")) as f:
        cfg = json.load(f)
    kernels, t = [], 0
    for _ in range(steps):
        for key, launches in L.plan(cfg, job).items():
            for count, work in launches:
                for _ in range(count):
                    dur = round(P.bound_s(CARD, *work) / share * 1e9)
                    kernels.append((KERNEL_NAMES[key.split(".")[0]], t, dur))
                    t += dur
        kernels.append(("sm90_xmma_gemm_f32f32_tf32f32_f32_nn", t, 1_000_000))
        t += 2_000_000
    return RunRecord(
        cell="c", cfg=cfg, job=job, card=CARD, setup_s=12.5, steps=steps,
        clips=steps * job["batch_size"], window_s=t / 1e9,
        peak_mem_bytes=3 * 2**30, resident_bytes=2**30,
        step_intervals_ms=[10.0] * 9 + [20.0] * 3,
        host_spans_s=[0.002, 0.004],
        launches_per_step=L.expected_counts(cfg, job), kernels=kernels,
        busy_s=_union_s(kernels), flops_per_step=1e12)


JOB = {"batch_size": 8, "compute_dtype": "float32", "video_freeze": False,
       "video_remat": True, "aggr_type": "phys&verb"}


@pytest.mark.parametrize("name", ["k1_roofline_pct", "k2_roofline_pct",
                                  "k3_roofline_pct", "k4_roofline_pct"])
def test_rooflines(name):
    assert read_metric(name, record(JOB)) == pytest.approx(50.0, rel=1e-3)


def test_roofline_silent_without_its_kernel():
    frozen = dict(JOB, video_freeze=True)
    assert read_metric("k3_roofline_pct", record(frozen)) is None
    rec = record(JOB)
    rec.kernels = [k for k in rec.kernels if "roll" not in k[0]]
    assert read_metric("k4_roofline_pct", rec) is None
    rec = record(JOB)
    rec.launches_per_step = dict(rec.launches_per_step, roll=11)
    assert read_metric("k4_roofline_pct", rec) is None


def test_step_and_window_metrics():
    rec = record(JOB)
    busy = sum(d for _, _, d in rec.kernels) / 1e9
    assert read_metric("device_idle_pct", rec) == pytest.approx(
        100 * (1 - busy / rec.window_s))
    assert read_metric("trainer_host_ms", rec) == pytest.approx(3.0)
    assert read_metric("train_clips_per_s", rec) == pytest.approx(
        rec.clips / rec.window_s)
    assert read_metric("peak_mem_gib", rec) == 3.0
    assert read_metric("step_transient_gib", rec) == 2.0
    assert read_metric("setup_s", rec) == 12.5
    assert read_metric("train_step_p90_ms", rec) == pytest.approx(20.0)
    assert read_metric("train_mfu_pct", rec) == pytest.approx(
        100 * 4e12 / (rec.window_s * 165e12))
    rec.step_intervals_ms = [10.0] * 5
    assert read_metric("train_step_p90_ms", rec) is None
    rec.kernels, rec.busy_s, rec.flops_per_step = None, None, None
    for name in ("device_idle_pct", "train_mfu_pct", "k2_roofline_pct"):
        assert read_metric(name, rec) is None


def test_union_and_breakdown():
    kernels = [("a", 0, 10), ("b", 5, 10), ("c", 30, 5), ("a", 40, 5)]
    assert _union_s(kernels) == pytest.approx(25e-9)
    out = breakdown(kernels)
    assert out["device_ops"][0] == ["a", 15e-9]
    assert out["idle_gaps"][0][1] == pytest.approx(15e-9)
    assert out["idle_gaps"][0][0].endswith(": b")
