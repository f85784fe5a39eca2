"""BENCHMARK.json against the benchmark's contract: keys, names, units,
files, and a reader for every metric."""

import importlib
import json
import os
import re

import pytest

from portbench import models

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
# what a model module gives the harness (`portbench/models/__init__.py`)
MODEL_GIVES = ("TINY", "modalities", "heads", "parameter_spec", "make_batch",
               "pool_config", "draw_masks", "reference_trainer",
               "trainable_names", "build_trainer", "GRAD_GROUPS",
               "launch_plan", "meta_step")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["portbench"]
    assert 1 <= manifest["run_seconds"] <= 51
    assert len(manifest["command"]) <= 32
    for word in manifest["command"]:
        assert not word.startswith("/") and ".." not in word
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_configs(manifest):
    names = set()
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert c["file"].startswith("portbench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg
            assert not key.endswith(("_dim", "_rank", "_size"))
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    used = {w["config"] for w in manifest["workloads"]}
    assert used == names


def test_each_config_names_a_model(manifest):
    for c in manifest["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert NAME.match(cfg["model"]), c["name"]
        model = models.load(cfg)
        assert [n for n in MODEL_GIVES if not hasattr(model, n)] == []
        assert set(model.TINY) <= {"config", "job"}
        assert all(k.endswith("_gap") for k in model.GRAD_GROUPS)


def test_workloads(manifest):
    seen = set()
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert os.path.isfile(os.path.join(ROOT, "portbench", "traffic",
                                           w["traffic"] + ".json"))
        assert os.path.isfile(os.path.join(ROOT, "portbench", "limits",
                                           w["name"] + ".json"))
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, len(manifest["workloads"]) // 4)


def test_metrics(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"] for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    names = set()
    for section in ("end_to_end", "per_layer"):
        for m in manifest[section]:
            keys = {"name", "unit", "better", "source"}
            keys |= {"bound"} if section == "end_to_end" else {"layer",
                                                                "moves"}
            assert set(m) - {"workloads"} == keys, m["name"]
            assert NAME.match(m["name"]) and m["name"] not in names
            names.add(m["name"])
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                              "higher")
            assert m["source"] in SOURCES
            assert set(m.get("workloads", cells)) <= cells
            importlib.import_module(f"portbench.metrics.{m['name']}").read
            if section == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace")
                assert 0.01 <= m["bound"] <= 0.25
            else:
                assert m["moves"] in e2e and "\n" not in m["layer"]
                if m["name"].endswith("_roofline_pct"):
                    assert m["unit"] == "%"
    for cell in cells:
        reported = [m for m in manifest["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in manifest["per_layer"])


def test_limits_files(manifest):
    for w in manifest["workloads"]:
        with open(os.path.join(ROOT, "portbench", "limits",
                               w["name"] + ".json")) as f:
            limits = json.load(f)
        assert limits["compared"]
        for key in limits["compared"]:
            limit = limits["limits"][key]
            lower = limits["readings"][key]["lower"]
            upper = limits["readings"][key]["upper"]
            assert lower < limit < upper and upper >= 3 * lower, (w["name"],
                                                                  key)
