"""``--distributed true`` in ``cli.train_seq2seq`` and
``cli.train_transducer`` on two gloo ranks on the CPU: bitwise-equal
ranks that log the global step one process logs on the same corpus (its
2-row batches are the same either way), and the same checkpoint files
(rank 0's). One pair of ranks runs both trainers in turn. SGD, so a
parameter moves by its gradient; tolerances as
``tests/test_torch_dp_cli.py``'s (losses rtol 1e-5, parameters 1e-6)."""
import numpy as np
import pytest

from audio8_tpu_torch.cli import train_seq2seq as s2s_cli
from audio8_tpu_torch.cli import train_transducer
from tests.test_torch_dp_cli import (SGD, _check_runs,  # noqa: F401
                                     _default_offsets, _same_files)
from tests.test_torch_seq2seq_cli import _args as s2s_args
from tests.test_torch_threads import cap_torch_threads
from tests.test_torch_train_cli import write_letter_corpus
from tests.test_torch_transducer_cli import _train_args as rnnt_args
from tests.test_torch_transducer_cli import write_corpus
from tests.torch_dp_ranks import kept_offsets, run_cli_ranks, subdir

cap_torch_threads()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both trainers' 2-rank runs on one pair of ranks; the special-token
    ids stay as the corpora left them (the ranks' start) until the
    module's tests end."""
    root = tmp_path_factory.mktemp("dp_cli_more")
    with kept_offsets():
        corpora = {"seq2seq": write_letter_corpus(subdir(root, "s2s")),
                   "transducer": subdir(root, "rnnt")}
        write_corpus(corpora["transducer"])
        jobs = [("audio8_tpu_torch.cli.train_seq2seq",
                 s2s_args(corpora["seq2seq"], str(root / "s2s2")) + SGD),
                ("audio8_tpu_torch.cli.train_transducer",
                 rnnt_args(corpora["transducer"], str(root / "rnnt2"), 2)
                 + SGD)]
        s2s, rnnt = run_cli_ranks(jobs, 2, root / "ranks")
        yield root, corpora, {"seq2seq": s2s, "transducer": rnnt}


def test_seq2seq_two_ranks_match_one_process(ranks, tmp_path):
    root, corpora, runs = ranks
    one = s2s_cli.train(s2s_args(corpora["seq2seq"], str(tmp_path / "run1"))
                        + SGD)
    _check_runs(runs["seq2seq"], one, ("loss", "audio_s"))
    _same_files(tmp_path / "run1", root / "s2s2")


def test_transducer_two_ranks_match_one_process(ranks, tmp_path):
    root, corpora, runs = ranks
    two = runs["transducer"]
    one = train_transducer.train(rnnt_args(corpora["transducer"],
                                           str(tmp_path / "run1"), 2) + SGD)
    _check_runs(two, one, ("loss", "audio_s"))
    np.testing.assert_allclose(
        [v["average_valid_loss"] for v in one.valid],
        [v["average_valid_loss"] for v in two[0]["valid"]], rtol=1e-5)
    _same_files(tmp_path / "run1", root / "rnnt2")
