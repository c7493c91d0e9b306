"""``--distributed true --tensor_parallel 2`` in ``cli.pretrain_hubert``
and ``cli.pretrain_data2vec`` (its EMA teacher split as the student is)
on two gloo ranks on the CPU, sequence parallelism off and on: the ranks
bitwise equal to each other, and one process's run on the same corpus
within ``tests/test_torch_tp_cli.py``'s tolerances. SGD."""
import pytest

from audio8_tpu_torch.cli import pretrain_data2vec, pretrain_hubert
from tests.test_torch_dp_cli import _default_offsets  # noqa: F401
from tests.test_torch_dp_cli_ssl import _d2v_args, _hubert_args
from tests.test_torch_dp_cli_ssl import km  # noqa: F401
from tests.test_torch_ssl_cli import corpus as ssl_corpus  # noqa: F401
from tests.test_torch_threads import cap_torch_threads
from tests.test_torch_tp_cli import SP, TP, check_tp_runs
from tests.torch_dp_ranks import kept_offsets, run_cli_ranks

cap_torch_threads()


def _whole(state):
    state = state[0] if isinstance(state, tuple) else state
    return state.log, {k: v.detach().clone()
                       for k, v in state.model.state_dict().items()}


@pytest.fixture(scope="module")
def runs(km, ssl_corpus, tmp_path_factory):  # noqa: F811
    root = tmp_path_factory.mktemp("tp_cli_ssl")
    with kept_offsets():
        one = {"hubert": _whole(pretrain_hubert.train(
                   _hubert_args(km, str(root / "hubert1")))),
               "data2vec": _whole(pretrain_data2vec.train(
                   _d2v_args(ssl_corpus, str(root / "d2v1"))))}
        names = [(kind, mode) for kind in ("hubert", "data2vec")
                 for mode in ("tp", "sp")]
        args = {"hubert": lambda d: _hubert_args(km, d),
                "data2vec": lambda d: _d2v_args(ssl_corpus, d)}
        module = {"hubert": "audio8_tpu_torch.cli.pretrain_hubert",
                  "data2vec": "audio8_tpu_torch.cli.pretrain_data2vec"}
        jobs = [(module[kind], args[kind](str(root / f"{kind}_{mode}"))
                 + TP + (SP if mode == "sp" else []))
                for kind, mode in names]
        results = run_cli_ranks(jobs, 2, root / "ranks")
        yield one, dict(zip(names, results))


@pytest.mark.parametrize("kind", ["hubert", "data2vec"])
@pytest.mark.parametrize("mode", ["tp", "sp"])
def test_ssl_tp_matches_one_process(runs, kind, mode):
    one, results = runs
    check_tp_runs(results[(kind, mode)], *one[kind], keys=("loss",))
