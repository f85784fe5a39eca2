"""The output check at a tiny size on the CPU: the port's plain CPU path
against the reference is correct; the control (the reference, its
products one precision lower, in the program's place) and the faults
planted under the timed path (a step that leaves the state unchanged,
half of each batch left out) are not.  The harness's look for a card is
skipped; the rest of a run is driven as on the card."""

import json
import os

import pytest
import torch

from portbench import harness, models
from portbench.models import physverb

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 3_000_000_019


def cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


def tiny_run(cell, **kw):
    """A run of `cell` at its model's CPU sizes (`TINY`)."""
    torch.set_num_threads(4)
    tiny = models.load(harness.load_cell(cell)[1]).TINY
    result, readings = harness.run(cell, SEED, 0.0, False, device="cpu",
                                   overrides=tiny, **kw)
    return result, readings


@pytest.mark.parametrize("cell", cells())
def test_sound_run_is_correct(cell):
    result, readings = tiny_run(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] == 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    losses = readings["program"]["losses"]
    assert len(losses) == 3 and losses[0] == pytest.approx(
        readings["reference"]["losses"][0], rel=1e-2)


@pytest.mark.parametrize("cell", cells())
def test_control_is_not_correct(cell):
    _, _, job, _, _ = harness.load_cell(cell)
    result, _ = tiny_run(cell, reference_products=job["control_products"])
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", cells())
def test_fault_is_not_correct(cell, fault):
    result, readings = tiny_run(cell, faults=(fault,))
    assert not result["correct"], result["checks"]
    if fault == "unchanged":
        assert readings["numbers"]["change_gap"] == pytest.approx(1.0)
        assert readings["numbers"]["grad_gap"] == pytest.approx(1.0)


def test_swin_gradient_gap_reads_the_swin_leaves_alone():
    names = ["extractors.audio.extractor.bn0.weight", "extractors.video.a",
             "extractors.video.b", "fusion.w"]
    reference = {"losses": [1.0] * 3, "grad_norms": [1.0, 2.0, 2.0, 1.0],
                 "change_norms": [1.0] * 4}
    program = dict(reference, grad_norms=[1.3, 2.0, 2.2, 1.0])
    numbers = harness.compare(program, reference, names, physverb.GRAD_GROUPS)
    assert numbers["grad_gap"] == pytest.approx(0.2)  # over the median, 1.5
    assert numbers["video_grad_gap"] == pytest.approx(0.1)
    assert "video_grad_gap" not in harness.compare(
        program, reference, [n.replace("video", "text") for n in names],
        physverb.GRAD_GROUPS)
