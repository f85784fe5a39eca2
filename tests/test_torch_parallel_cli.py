"""The port's CLIs under --data_parallel and --model_parallelism on 2 gloo
CPU ranks against the same CLIs on one process
(tests/test_tp_cli.py:31-53, 182-236):

- train_text_transformer, 2 epochs, under --data_parallel and under
  --model_parallelism 2: per-epoch train losses within 5e-4, UAR 1e-6;
- a --model_parallelism 2 run stopped after epoch 0 and resumed with the
  same --run_name: its log equal to the uninterrupted run's (5e-4);
- evaluate --data_parallel: every head's metrics equal to one rank's, the
  loss within 1e-5;

and the checks of `make_parallelism` (test_tp_cli.py:56-64).
"""

import glob

import numpy as np
import pandas as pd
import pytest

from _torch_parallel_child import launch


def _log(pattern):
    logs = glob.glob(pattern)
    assert len(logs) == 1, pattern
    return pd.read_csv(logs[0])


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    import torch

    from multimodalaggressionrecognition_tpu_torch.cli import (
        evaluate, train_text_transformer)
    from multimodalaggressionrecognition_tpu_torch.data.synthetic import (
        generate_synthetic_avabos)

    work = tmp_path_factory.mktemp("cli")
    root = str(work / "avabos")
    generate_synthetic_avabos(root, num_clusters=3, samples_per_cluster=6,
                              seed=3, audio_len=16000, video_frames=8,
                              video_hw=32)
    eval_args = ["--dataset_root", root, "--modalities", "audio,text",
                 "--audio_samples", "16000", "--text_tokens", "16",
                 "--batch_size", "4", "--device", "cpu", "--num_threads", "1",
                 "--saving_dir", str(work / "eval")]
    torch.save(eval_args, work / "evaluate_args.pt")
    launch("cli", 2, work, timeout=600)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        train_text_transformer.main([
            "--dataset_root", root, "--batch_size", "4", "--num_layers", "1",
            "--log_console", "false", "--device", "cpu", "--num_threads", "1",
            "--epoch_num", "2", "--saving_dir", str(work / "plain")])
        plain_eval = evaluate.main(eval_args)
    finally:
        torch.set_num_threads(threads)
    return work, plain_eval


@pytest.mark.parametrize("run", ["dp", "tp"])
def test_cli_parallel_matches_one_process(cli_runs, run):
    work, _ = cli_runs
    plain = _log(str(work / "plain" / "*" / "main_train_log.csv"))
    got = _log(str(work / run / "*" / "main_train_log.csv"))
    assert list(got["epoch"]) == [0, 1]
    np.testing.assert_allclose(got["loss"], plain["loss"], rtol=0, atol=5e-4)
    np.testing.assert_allclose(got["UAR"], plain["UAR"], rtol=0, atol=1e-6)
    test_plain = _log(str(work / "plain" / "*" / "main_test_log.csv"))
    test_got = _log(str(work / run / "*" / "main_test_log.csv"))
    np.testing.assert_allclose(test_got["loss"], test_plain["loss"], rtol=0,
                               atol=5e-4)


def test_tp_run_resume_matches_uninterrupted(cli_runs):
    work, _ = cli_runs
    full = _log(str(work / "tp" / "*" / "main_train_log.csv"))
    split = _log(str(work / "resume" / "split" / "main_train_log.csv"))
    assert list(split["epoch"]) == [0, 1]
    np.testing.assert_allclose(split["loss"], full["loss"], rtol=0,
                               atol=5e-4)
    # rank 0 alone wrote the run: one lock file, one config
    assert sorted(p.name for p in (work / "resume" / "split").glob(
        ".runlock*")) == [".runlock.p0"]


def test_evaluate_data_parallel_matches_one_rank(cli_runs):
    work, plain = cli_runs
    import torch

    got = torch.load(work / "evaluate_out.pt", weights_only=False)
    assert sorted(got) == sorted(plain)
    for head, m in plain.items():
        for k, v in m.items():
            if k == "loss":
                np.testing.assert_allclose(got[head][k], v, rtol=0,
                                           atol=1e-5)
            else:
                np.testing.assert_array_equal(got[head][k], v,
                                              err_msg=f"{head} {k}")


def test_make_parallelism_checks():
    from multimodalaggressionrecognition_tpu_torch.cli.common import (
        TrainConfig, check_parallelism, make_parallelism)

    with pytest.raises(SystemExit, match="does not divide the 8 available"):
        check_parallelism(8, 3, 16)
    with pytest.raises(SystemExit, match="must be divisible by the data "
                                         r"axis \(8 devices / tp 2 = 4\)"):
        check_parallelism(8, 2, 6)
    assert check_parallelism(8, 2, 8) == 4
    assert check_parallelism(4, 1, 8) == 4
    # one process: tp 3 does not divide it; the check runs before any
    # process group comes up
    with pytest.raises(SystemExit, match="divide"):
        make_parallelism(TrainConfig(model_parallelism=3, device="cpu"))
    assert make_parallelism(TrainConfig()) is None


def test_every_entry_takes_the_parallel_flags():
    import dataclasses

    from multimodalaggressionrecognition_tpu_torch.cli import (
        evaluate, train3dcnn, train_audio_rnn, train_audio_text,
        train_audio_transformer, train_multimodal, train_text_transformer,
        train_video_rnn, train_video_transformer)
    from multimodalaggressionrecognition_tpu_torch.cli.common import (
        parse_config)

    configs = [evaluate.EvalConfig]
    for mod in (train3dcnn, train_audio_rnn, train_audio_text,
                train_audio_transformer, train_multimodal,
                train_text_transformer, train_video_rnn,
                train_video_transformer):
        configs += [v for v in vars(mod).values()
                    if isinstance(v, type) and dataclasses.is_dataclass(v)
                    and v.__module__ == mod.__name__]
    assert len(configs) >= 9
    for cls in configs:
        cfg = parse_config(cls, ["--data_parallel", "--model_parallelism",
                                 "2"])
        assert cfg.data_parallel is True and cfg.model_parallelism == 2
