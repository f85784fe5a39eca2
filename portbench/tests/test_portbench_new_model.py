"""A configuration brings a new model to the benchmark in new files alone:
a copy of the benchmark gains a toy model (PhysVerb's pieces with two
fusion layers, a first-gradient check of the second layer's leaves and a
kernel name rule of its own), its configuration, traffic and limits files
and its manifest entries, and runs to a correct result on the CPU against
this checkout's port, with no file of the benchmark changed."""

import filecmp
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 3_000_000_037
CELL = "toy_audiotext_f32"
TOY_MODEL = '''"""A toy model: PhysVerb with its own check of its second fusion
layer and a kernel family of its own."""

from .physverb import (TINY, build_trainer, draw_masks, heads,  # noqa: F401
                       launch_plan, make_batch, meta_step, modalities,
                       parameter_spec, pool_config, reference_trainer,
                       trainable_names)

GRAD_GROUPS = {"fusion1_grad_gap": "fusion.encoder.layers.1."}


def family(kernel_name):
    return "toy fused" if "toy_fused" in kernel_name else None
'''
LIMITS = {"compared": ["loss_gap", "grad_gap", "fusion1_grad_gap",
                       "change_gap"],
          "limits": {"loss_gap": 2.7e-02, "grad_gap": 9.94e-03,
                     "fusion1_grad_gap": 9.94e-03, "change_gap": 2.14e-01}}
RUN = f"""
import json, torch
from portbench import harness, models
torch.set_num_threads(4)
cfg = harness.load_cell({CELL!r})[1]
model = models.load(cfg)
result, readings = harness.run({CELL!r}, {SEED}, 0.0, False, device="cpu",
                               overrides=model.TINY)
family = models.family_of(cfg)
print(json.dumps({{"result": result, "numbers": readings["numbers"],
                  "files": [harness.__file__, model.__file__],
                  "families": [family("toy_fused_kernel<4>"),
                               family("framed_conv1d_kernel<64>")]}}))
"""


def add_toy(root):
    """The files and manifest entries a configuration adds."""
    bench = os.path.join(root, "portbench")
    with open(os.path.join(bench, "configs", "audiotext_flagship.json")) as f:
        cfg = json.load(f)
    cfg.update(name="toy_audiotext", model="toy_fusion2", fusion_layers=2)
    with open(os.path.join(bench, "traffic", "train_f32_b32_verb.json")) as f:
        job = json.load(f)
    new = {"configs/toy_audiotext.json": json.dumps(cfg),
           "traffic/toy_train_f32_verb.json": json.dumps(job),
           f"limits/{CELL}.json": json.dumps(LIMITS),
           "models/toy_fusion2.py": TOY_MODEL}
    for rel, text in new.items():
        path = os.path.join(bench, rel)
        assert not os.path.exists(path)
        with open(path, "w") as f:
            f.write(text)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    manifest["configs"].append(
        {"name": "toy_audiotext", "source": cfg["source"],
         "file": "portbench/configs/toy_audiotext.json", "reduced": [],
         "why": "a toy: the flagship with two fusion layers"})
    manifest["workloads"].append(
        {"name": CELL, "config": "toy_audiotext",
         "traffic": "toy_train_f32_verb", "chips": 1,
         "why": "a toy: its own check of the second fusion layer"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return {os.path.join("portbench", rel) for rel in new}


def files(root):
    out = set()
    for d, dirs, names in os.walk(os.path.join(root, "portbench")):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        out |= {os.path.relpath(os.path.join(d, n), root) for n in names}
    return out


def test_a_new_model_in_new_files_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    added = add_toy(tmp_path)
    env = dict(os.environ, OMP_NUM_THREADS="4", PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run([sys.executable, "-c", RUN], cwd=tmp_path,
                         text=True, capture_output=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert all(f.startswith(str(tmp_path)) for f in got["files"])
    assert got["result"]["correct"], got["result"]["checks"]
    assert set(got["result"]["checks"]) == set(LIMITS["compared"])
    assert "video_grad_gap" not in got["numbers"]
    assert 0 < got["numbers"]["fusion1_grad_gap"] <= got["numbers"]["grad_gap"]
    assert got["families"] == ["toy fused", "K1"]

    # nothing the benchmark had was edited: only files and entries added
    assert files(tmp_path) == files(ROOT) | added
    for rel in files(ROOT):
        assert filecmp.cmp(os.path.join(ROOT, rel), tmp_path / rel,
                           shallow=False), rel
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        before = json.load(f)
    with open(tmp_path / "BENCHMARK.json") as f:
        after = json.load(f)
    for key in ("configs", "workloads"):
        after[key] = after[key][:-1]
    assert after == before
