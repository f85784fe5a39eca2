"""The port's multi-rank Trainer on 2 gloo CPU ranks
(tests/test_multiproc_trainer.py): `ProcessLocalBatches` slices each
global batch, the steps sum over the data group, rank 0 writes the logs
and checkpoints; and the preemption consensus.  Also `ProcessLocalBatches`
against the JAX package's, and `parallel.dryrun_multichip(4)`.
"""

import csv
import os

import numpy as np
import pytest
import torch

from _torch_parallel_child import build_batches, launch, run_training


def _losses(run_dir, split):
    with open(os.path.join(run_dir, f"main_{split}_log.csv")) as f:
        return [float(r["loss"]) for r in csv.DictReader(f)]


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("trainer")
    launch("trainer", 2, work)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        run_training(str(work / "sp_run"))
    finally:
        torch.set_num_threads(threads)
    return work


def test_two_rank_trainer_matches_single_process(trainer_runs):
    work = trainer_runs
    for split in ("train", "test"):
        mp = _losses(work / "mp_run", split)
        sp = _losses(work / "sp_run", split)
        assert len(mp) == len(sp) == 2
        np.testing.assert_allclose(mp, sp, atol=1e-5)
    files = set(os.listdir(work / "mp_run"))
    assert {"checkpoint_current", "checkpoint_best_main",
            "main_train_log.csv", "main_test_log.csv"} <= files
    # a checkpoint written by rank 0 restores on one process
    from multimodalaggressionrecognition_tpu_torch.io.checkpoint import (
        restore_variables)

    sd, meta = restore_variables(str(work / "mp_run" / "checkpoint_current"))
    assert meta["epoch"] == 1 and "inner.0.weight" in sd


def test_preemption_consensus_stops_every_rank_at_one_step(trainer_runs):
    """SIGTERM's flag set on rank 1 only, at its third poll: both ranks stop
    after batch 3, rank 0 writes the partial checkpoint, and the 2-rank
    resume reproduces the uninterrupted single-process run."""
    work = trainer_runs
    got = torch.load(work / "preempt.pt", weights_only=False)
    assert got["steps"] == [3.0, 3.0]
    assert got["meta"]["partial"] and got["meta"]["epoch"] == 0
    assert got["meta"]["batches_done"] == 3
    assert not os.path.exists(work / "preempt_run" / "checkpoint_preempt")
    for split in ("train", "test"):
        np.testing.assert_allclose(_losses(work / "preempt_run", split),
                                   _losses(work / "sp_run", split),
                                   atol=1e-5)


@pytest.mark.parametrize("process_id", [0, 1, 3])
def test_process_local_batches_match_jax(process_id):
    from multimodalaggressionrecognition_tpu.data.pipeline import (
        ProcessLocalBatches as JaxBatches)
    from multimodalaggressionrecognition_tpu_torch.data.pipeline import (
        ProcessLocalBatches)

    batches = build_batches()
    got = list(ProcessLocalBatches(batches, process_id, 4))
    want = list(JaxBatches(batches, process_id=process_id, num_processes=4))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["modalities"]["feat"]["data"],
                                      w["modalities"]["feat"]["data"])
        np.testing.assert_array_equal(g["labels"]["main"],
                                      w["labels"]["main"])
    skipped = list(ProcessLocalBatches(batches, process_id, 4)
                   .iter_skipping(3))
    np.testing.assert_array_equal(skipped[0]["sample_mask"],
                                  want[3]["sample_mask"])
    with pytest.raises(ValueError, match="must divide evenly across 3 "
                                         "processes"):
        next(iter(ProcessLocalBatches(batches, 0, 3)))
    with pytest.raises(ValueError, match="must divide evenly across 3 "
                                         "processes"):
        next(iter(JaxBatches(batches, process_id=0, num_processes=3)))


def test_dryrun_multichip_four_ranks():
    from multimodalaggressionrecognition_tpu_torch.parallel import (
        dryrun_multichip)

    out = dryrun_multichip(4)
    assert "dryrun_multichip(4): ok, dp 2 x tp 2" in out
