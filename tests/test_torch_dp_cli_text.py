"""``--distributed true`` in ``cli.pretrain_paired`` and ``cli.train_lm``
on two gloo ranks on the CPU; one pair of ranks runs both trainers in
turn.

Paired: the CLIP similarities are the global batch's on every rank (each
gathers all ranks' embeddings, its gradient reaching its own rows, the
temperature's on rank 0 alone), so the ranks log the step one process
logs on the same corpus, the learned temperature included (counted once,
not twice). LM: as in JAX every rank draws ``batch_size // world``
blocks from the same seeded generator, so two ranks at batch 4 hold one
process's batch-2 blocks twice; with dropout off the token-mean loss and
the step are that process's. SGD where the trainer has it (the LM's
AdamW: losses only); tolerances as ``tests/test_torch_dp_cli.py``'s."""
import numpy as np
import pytest
import torch

from audio8_tpu_torch.cli import pretrain_paired as paired_cli
from audio8_tpu_torch.cli import train_lm
from tests.test_torch_dp_cli import (_check_runs,  # noqa: F401
                                     _default_offsets, _same_files)
from tests.test_torch_lm_cli import LM
from tests.test_torch_paired_cli import _args as paired_args
from tests.test_torch_paired_cli import write_paired_corpus
from tests.test_torch_threads import cap_torch_threads
from tests.test_torch_transducer_cli import write_corpus
from tests.torch_dp_ranks import kept_offsets, run_cli_ranks, subdir

cap_torch_threads()
PAIRED_SGD = ["--optim", "sgd"]


def _lm_args(root, basedir, batch):
    args = ["--text", str(root / "train.ltr"), "--valid_text",
            str(root / "valid.ltr"), "--dict_file",
            str(root / "dict.ltr.txt"), "--basedir", basedir,
            "--train_steps", "3", "--steps_per_checkpoint", "3",
            "--dropout", "0.0", *LM]
    args[args.index("--batch_size") + 1] = str(batch)
    return args


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both trainers' 2-rank runs on one pair of ranks; the special-token
    ids stay as the corpora left them (the ranks' start) until the
    module's tests end."""
    root = tmp_path_factory.mktemp("dp_cli_text")
    with kept_offsets():
        corpora = {"paired": write_paired_corpus(subdir(root, "paired")),
                   "lm": subdir(root, "lm")}
        write_corpus(corpora["lm"])
        jobs = [("audio8_tpu_torch.cli.pretrain_paired",
                 paired_args(corpora["paired"], str(root / "paired2"))
                 + PAIRED_SGD),
                ("audio8_tpu_torch.cli.train_lm",
                 _lm_args(corpora["lm"], str(root / "lm2"), 4))]
        paired, lm = run_cli_ranks(jobs, 2, root / "ranks")
        yield root, corpora, {"paired": paired, "lm": lm}


def test_paired_two_ranks_match_one_process(ranks, tmp_path):
    root, corpora, runs = ranks
    one = paired_cli.train(paired_args(corpora["paired"],
                                       str(tmp_path / "run1")) + PAIRED_SGD)
    _check_runs(runs["paired"], one, ("loss", "clip_accuracy",
                                      "logit_scale"))
    assert one.log[-1]["logit_scale"] != one.log[0]["logit_scale"]
    _same_files(tmp_path / "run1", root / "paired2")


def test_lm_two_ranks_match_one_process(ranks, tmp_path):
    root, corpora, runs = ranks
    two = runs["lm"]
    one = train_lm.train(_lm_args(corpora["lm"], str(tmp_path / "run1"), 2))
    for k, v in two[0]["params"].items():
        assert torch.equal(v, two[1]["params"][k]), k
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([r[key] for r in two[0]["log"]],
                                   [r[key] for r in one.log], rtol=1e-5,
                                   err_msg=key)
    # the global batch: each block twice
    assert [r["tokens"] for r in two[0]["log"]] == \
        [2 * r["tokens"] for r in one.log]
    np.testing.assert_allclose(two[0]["valid"][-1]["valid_nll"],
                               one.valid[-1]["valid_nll"], rtol=1e-5)
