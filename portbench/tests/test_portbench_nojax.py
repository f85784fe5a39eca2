"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module name; a run without a card prints no result."""

import os
import shutil
import subprocess
import sys
import types

from portbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_top_level_names_compared_whole(monkeypatch):
    for name in ("jax", "jaxlib.xla_client", "flax.linen",
                 "multimodalaggressionrecognition_tpu.models"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.setitem(sys.modules, "jaxtyping",
                        types.ModuleType("jaxtyping"))
    found = harness.forbidden_modules()
    assert {"jax", "jaxlib.xla_client", "flax.linen",
            "multimodalaggressionrecognition_tpu.models"} <= set(found)
    assert "jaxtyping" not in found
    assert not any(m.startswith("multimodalaggressionrecognition_tpu_torch")
                   for m in found)


def test_a_run_loads_no_jax():
    code = (
        "import json, sys, torch\n"
        "from portbench import harness, calibrate, run\n"
        "import importlib, pkgutil, portbench.metrics as pm\n"
        "for m in pkgutil.iter_modules(pm.__path__):\n"
        "    importlib.import_module('portbench.metrics.' + m.name)\n"
        "tiny = {'config': {'audio_samples': 16000, 'text_tokens': 8,\n"
        "        'text_min_tokens': 2, 'video_frames': 16, 'video_size': 32},\n"
        "        'job': {'batch_size': 2}}\n"
        "harness.run('trimodal_frozen_f32_b32', 5, 0.0, False, device='cpu',\n"
        "            overrides=tiny)\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=600,
                         env={**os.environ, "OMP_NUM_THREADS": "4"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "audiotext_train_f32_b32", "--seed", "3000000019", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, text=True, capture_output=True,
        timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_port_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "audiotext_train_f32_b32", "--seed", "3000000019", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, text=True, capture_output=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
