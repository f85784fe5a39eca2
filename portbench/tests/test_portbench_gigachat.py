"""The GigaChat cell from the benchmark's files alone: a copy of
`BENCHMARK.json` and `portbench/` runs the cell at its model's CPU sizes
(`models/physverb_gigachat.py` `TINY`) against this checkout's port,
gives every number its limits compare, and with the fp8 control in the
program's place reads further off; the plain reference of the tower loads
neither the port nor JAX; the operations of a step are counted on meta
tensors."""

import json
import os
import shutil
import subprocess
import sys

from portbench import harness, models
from portbench.yardstick.flops import step_flops

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 3_000_000_037
CELL = "audiotext_gigachat31_ft_bf16_b32"
RUN = f"""
import json, torch
from portbench import harness, models
torch.set_num_threads(4)
cfg, job = harness.load_cell({CELL!r})[1:3]
model = models.load(cfg)
out = {{}}
control = {{"reference_products": job["control_products"]}}
for kind, kw in (("program", {{}}), ("control", control)):
    result, readings = harness.run({CELL!r}, {SEED}, 0.0, False, device="cpu",
                                   overrides=model.TINY, **kw)
    out[kind] = {{"result": result, "numbers": readings["numbers"]}}
out["files"] = [harness.__file__, model.__file__]
print(json.dumps(out))
"""
IMPORTS = """
import sys
import portbench.reference.gigachat
print(sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "multimodalaggressionrecognition_tpu",
    "multimodalaggressionrecognition_tpu_torch")))
"""


def test_the_cell_runs_from_a_copy_of_the_benchmark(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, OMP_NUM_THREADS="4", PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run([sys.executable, "-c", RUN], cwd=tmp_path,
                         text=True, capture_output=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert all(f.startswith(str(tmp_path)) for f in got["files"])
    program, control = got["program"], got["control"]
    assert set(program["result"]["checks"]) == {
        "loss1_gap", "grad_gap", "text_grad_gap", "change_gap"}
    assert program["numbers"]["text_grad_gap"] <= \
        program["numbers"]["grad_gap"]
    assert control["numbers"]["grad_gap"] > program["numbers"]["grad_gap"]


def test_the_reference_loads_neither_the_port_nor_jax():
    out = subprocess.run([sys.executable, "-c", IMPORTS], cwd=ROOT,
                         text=True, capture_output=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"


def test_a_step_counts_the_tower_on_the_padded_tokens():
    """At the cell's sizes, on meta tensors: ~62 TFLOP a step, nearly all
    of it the tower's."""
    cfg, job = harness.load_cell(CELL)[1:3]
    cfg = {**cfg, **models.load(cfg).pool_config([], ())}
    flops = step_flops(cfg, job)
    assert 5e13 < flops < 8e13
