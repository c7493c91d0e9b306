"""``--distributed true --tensor_parallel 2`` in ``cli.train_seq2seq``
(the encoder's and the decoder's self and cross attention and FFNs
split) and ``cli.train_transducer`` (the encoder split, the predictor
and joint replicated) on two gloo ranks on the CPU, sequence
parallelism off and on: the ranks bitwise equal to each other, and one
process's run on the same corpus within ``tests/test_torch_tp_cli.py``'s
tolerances. One pair of ranks runs the four jobs in turn. SGD."""
import numpy as np
import pytest

from audio8_tpu_torch.cli import train_seq2seq as s2s_cli
from audio8_tpu_torch.cli import train_transducer
from tests.test_torch_dp_cli import SGD, _default_offsets  # noqa: F401
from tests.test_torch_seq2seq_cli import _args as s2s_args
from tests.test_torch_threads import cap_torch_threads
from tests.test_torch_tp_cli import SP, TP, _moved, check_tp_runs
from tests.test_torch_train_cli import write_letter_corpus
from tests.test_torch_transducer_cli import _train_args as rnnt_args
from tests.test_torch_transducer_cli import write_corpus
from tests.torch_dp_ranks import kept_offsets, run_cli_ranks, subdir

cap_torch_threads()


def _whole(state):
    return state.log, {k: v.detach().clone()
                       for k, v in state.model.state_dict().items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_cli_more")
    with kept_offsets():
        s2s_c = write_letter_corpus(subdir(root, "s2s"))
        rnnt_c = subdir(root, "rnnt")
        write_corpus(rnnt_c)
        args = {"seq2seq": s2s_args(s2s_c, str(root / "s2s1")) + SGD,
                "transducer": rnnt_args(rnnt_c, str(root / "rnnt1"), 2)
                + SGD}
        one = {"seq2seq": _whole(s2s_cli.train(args["seq2seq"])),
               "transducer": _whole(train_transducer.train(
                   args["transducer"]))}
        names = [(kind, mode) for kind in ("seq2seq", "transducer")
                 for mode in ("tp", "sp")]
        module = {"seq2seq": "audio8_tpu_torch.cli.train_seq2seq",
                  "transducer": "audio8_tpu_torch.cli.train_transducer"}
        jobs = [(module[kind], _moved(args[kind], str(root / f"{kind}_{mode}"))
                 + TP + (SP if mode == "sp" else []))
                for kind, mode in names]
        results = run_cli_ranks(jobs, 2, root / "ranks")
        yield one, dict(zip(names, results))


@pytest.mark.parametrize("mode", ["tp", "sp"])
def test_seq2seq_tp_matches_one_process(runs, mode):
    one, results = runs
    check_tp_runs(results[("seq2seq", mode)], *one["seq2seq"],
                  keys=("loss", "audio_s"))


@pytest.mark.parametrize("mode", ["tp", "sp"])
def test_transducer_tp_matches_one_process(runs, mode):
    one, results = runs
    two = results[("transducer", mode)]
    check_tp_runs(two, *one["transducer"], keys=("loss", "audio_s"))
    timeless = [[{k: v for k, v in row.items()
                  if not k.endswith(("seconds", "elapsed_epoch"))}
                 for row in r["valid"]] for r in two]
    assert timeless[0] == timeless[1]
