"""The frozen roofline counts against the figures the kernels were timed
against alone (PERF.md's kernel table), and the launch plan against the
launches a b8 step is known to make."""

import json
import os

import pytest

from portbench.yardstick import launches as L
from portbench.yardstick import peaks as P

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def load(name):
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as f:
        return json.load(f)


def test_k2_stage0():
    flops, nbytes, _ = P.k2_work(2048, 196, 3, 32, 16)
    assert flops / 1e9 == pytest.approx(30.2, abs=0.05)
    assert nbytes / 1e6 == pytest.approx(619, abs=0.5)
    _, with_lse, _ = P.k2_work(2048, 196, 3, 32, 16, lse=True)
    assert (with_lse - nbytes) / 1e6 == pytest.approx(4.8, abs=0.05)


def test_k3_stage0():
    flops, nbytes, _ = P.k3_work(2048, 196, 3, 32, 16)
    assert flops / 1e9 == pytest.approx(75.5, abs=0.05)
    assert nbytes / 1e9 == pytest.approx(1.24, abs=0.005)
    assert P.k3_work_bf16(2048, 196, 3, 32, 16)[1] / 1e6 == pytest.approx(
        547.7, abs=0.5)


def test_k4_stage0():
    _, nbytes, _ = P.k4_work(128, 4, 28, 28, 96, 4)
    assert nbytes / 2 / 1e6 == pytest.approx(154.1, abs=0.05)


def test_k1_stem():
    flops, nbytes, _ = P.k1_work(32, 80000, 160, 40, 80, 64)
    assert flops / 1e9 == pytest.approx(1.311, abs=0.001)
    assert nbytes / 1e6 == pytest.approx(26.67, abs=0.01)


def test_bounds_and_peaks():
    card = "NVIDIA H100 80GB HBM3"
    flops, nbytes, products = P.k2_work(2048, 196, 3, 32, 16)
    assert P.bound_s(card, flops, nbytes, products) * 1e3 == pytest.approx(
        0.1849, abs=1e-4)
    assert P.train_peak(card, "float32") == pytest.approx(165e12)
    assert P.train_peak(card, "bfloat16") == pytest.approx(989e12)


def test_b8_plan_matches_the_known_launches():
    cfg = load("trimodal_swin3d_t")
    job = {"batch_size": 8, "compute_dtype": "float32", "video_freeze": False,
           "video_remat": True, "aggr_type": "phys&verb"}
    assert L.expected_counts(cfg, job) == {
        "framed_conv1d": 1, "window_attention": 24,
        "window_attention_bwd": 12, "roll": 12}
    blocks = L.swin_blocks(cfg, 8)
    assert [b[:5] for b in blocks[:2]] == [(2048, 196, 3, 32, 0),
                                           (2048, 196, 3, 32, 16)]
    assert blocks[3][:5] == (512, 196, 6, 32, 4)
    assert blocks[-1][:5] == (128, 64, 24, 32, 0)
    frozen = dict(job, video_freeze=True)
    assert L.expected_counts(cfg, frozen) == {
        "framed_conv1d": 1, "window_attention": 12, "roll": 4}
    bf16 = dict(job, compute_dtype="bfloat16", video_remat=False)
    assert L.expected_counts(cfg, bf16) == {
        "framed_conv1d": 1, "window_attention.bf16": 12,
        "window_attention_bwd.bf16": 12, "roll.bf16": 8}
    audio_text = dict(job, aggr_type="verb")
    assert L.expected_counts(load("audiotext_flagship"), audio_text) == {
        "framed_conv1d": 1}
