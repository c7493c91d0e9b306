"""``--distributed true --tensor_parallel 2`` in ``cli.pretrain_paired``
(the audio encoder and the text tower split, its relative-position table
replicated and summed over the model group) on two gloo ranks on the
CPU, sequence parallelism off and on: the ranks bitwise equal to each
other, and one process's run on the same corpus within
``tests/test_torch_tp_cli.py``'s tolerances. SGD."""
import pytest

from audio8_tpu_torch.cli import pretrain_paired as paired_cli
from tests.test_torch_dp_cli import _default_offsets  # noqa: F401
from tests.test_torch_dp_cli_text import PAIRED_SGD
from tests.test_torch_paired_cli import _args as paired_args
from tests.test_torch_paired_cli import write_paired_corpus
from tests.test_torch_threads import cap_torch_threads
from tests.test_torch_tp_cli import SP, TP, check_tp_runs
from tests.torch_dp_ranks import kept_offsets, run_cli_ranks, subdir

cap_torch_threads()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_cli_text")
    with kept_offsets():
        corpus = write_paired_corpus(subdir(root, "paired"))
        state = paired_cli.train(paired_args(corpus, str(root / "one"))
                                 + PAIRED_SGD)
        one = (state.log, {k: v.detach().clone()
                           for k, v in state.model.state_dict().items()})
        jobs = [("audio8_tpu_torch.cli.pretrain_paired",
                 paired_args(corpus, str(root / mode)) + PAIRED_SGD + TP
                 + (SP if mode == "sp" else [])) for mode in ("tp", "sp")]
        results = run_cli_ranks(jobs, 2, root / "ranks")
        yield one, dict(zip(("tp", "sp"), results))


@pytest.mark.parametrize("mode", ["tp", "sp"])
def test_paired_tp_matches_one_process(runs, mode):
    one, results = runs
    check_tp_runs(results[mode], *one, keys=("loss",))
