"""``--distributed true`` in ``cli.train`` (CTC) and ``cli.pretrain`` on
two gloo ranks on the CPU (``torchrun``'s environment, a localhost
rendezvous): the ranks read their row blocks of the same batches, end
with bitwise-equal parameters, and log the global step that one
process without ``--distributed`` logs on the same corpus (the corpora
give 2-row batches either way, so the global batches are the same);
rank 0 alone writes the checkpoints. One pair of ranks runs both
trainers in turn. SGD, so a parameter moves by its gradient; tolerances:
losses rtol 1e-5, parameters 1e-6."""
import os

import numpy as np
import pytest
import torch

from audio8_tpu_torch.cli import pretrain as pretrain_cli
from audio8_tpu_torch.cli import train as train_cli
from audio8_tpu_torch.utils import Offsets
from tests.test_torch_dp_ctc import check_params
from tests.test_torch_pretrain_cli import SMALL as PRETRAIN_SMALL
from tests.test_torch_pretrain_cli import write_audio_corpus
from tests.test_torch_threads import cap_torch_threads
from tests.test_torch_train_cli import _train_args, write_letter_corpus
from tests.torch_dp_ranks import kept_offsets, run_cli_ranks, subdir

cap_torch_threads()


@pytest.fixture(autouse=True)
def _default_offsets():
    saved = (Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK,
             list(Offsets.VALUES))
    yield
    Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK = saved[:4]
    Offsets.VALUES[:] = saved[4]


def _check_runs(two, one, metric_keys):
    for k, v in two[0]["params"].items():
        assert torch.equal(v, two[1]["params"][k]), k
    assert two[0]["log"] == [dict(r, seconds=two[0]["log"][i]["seconds"])
                             for i, r in enumerate(two[1]["log"])]
    for key in metric_keys:
        np.testing.assert_allclose([r[key] for r in two[0]["log"]],
                                   [r[key] for r in one.log], rtol=1e-5,
                                   err_msg=key)
    check_params(two[0]["params"], {k: v.detach() for k, v in
                                    one.model.state_dict().items()}, 1e-6)


SGD = ["--optim", "sgd", "--lr", "0.01"]


def _same_files(one_dir, two_dir):
    assert sorted(os.listdir(two_dir)) == sorted(os.listdir(one_dir))


def _pretrain_args(corpus, basedir):
    return PRETRAIN_SMALL + [
        "--manifest_dir", str(corpus), "--basedir", basedir,
        "--tokens_per_batch", "16000", "--max_sample_len", "8000",
        "--train_steps", "3", "--steps_per_checkpoint", "2",
        "--warmup_steps", "2", "--num_train_workers", "1", *SGD]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both trainers' 2-rank runs on one pair of ranks: the run
    directory, the corpora and each run's rank results; the special-token
    ids stay as the corpora left them (the ranks' start) until the
    module's tests end."""
    root = tmp_path_factory.mktemp("dp_cli")
    with kept_offsets():
        corpora = {"train": write_letter_corpus(subdir(root, "train_corpus")),
                   "pretrain": write_audio_corpus(subdir(root,
                                                         "pretrain_corpus"))}
        jobs = [("audio8_tpu_torch.cli.train",
                 _train_args(corpora["train"], str(root / "train2")) + SGD),
                ("audio8_tpu_torch.cli.pretrain",
                 _pretrain_args(corpora["pretrain"],
                                str(root / "pretrain2")))]
        train, pretrain = run_cli_ranks(jobs, 2, root / "ranks")
        yield root, corpora, {"train": train, "pretrain": pretrain}


def test_train_two_ranks_match_one_process(ranks, tmp_path):
    root, corpora, runs = ranks
    two = runs["train"]
    one = train_cli.train(_train_args(corpora["train"],
                                      str(tmp_path / "run1")) + SGD)
    _check_runs(two, one, ("loss", "audio_s"))
    assert [r["frozen"] for r in two[0]["log"]] == [True, True, False]
    _same_files(tmp_path / "run1", root / "train2")


def test_pretrain_two_ranks_match_one_process(ranks, tmp_path):
    root, corpora, runs = ranks
    two = runs["pretrain"]
    one = pretrain_cli.train(_pretrain_args(corpora["pretrain"],
                                            str(tmp_path / "run1")))
    assert [r["rows"] for r in two[0]["log"]] == \
        [r["rows"] for r in one.log] == [2, 2, 2]
    _check_runs(two, one, ("loss", "code_perplexity", "accuracy",
                           "grad_norm"))
