"""``--zero1`` and ``--fsdp`` in ``cli.pretrain_hubert`` and
``cli.pretrain_data2vec`` on two gloo ranks on the CPU, each held to the
same trainer's ``--distributed`` DP run (AdamW): every logged loss within
rtol 1e-6, and every ``.pt`` and resume file within 1e-6 absolute,
data2vec's ``teacher-step-N.pt`` among them (under FSDP the teacher is
sharded as the student is, its EMA taken on the chunks and its forward
gathering each layer; under ZeRO-1 it stays whole, as the student's
parameters do)."""
import shutil

import pytest
import torch

from tests.test_torch_dp_cli import _default_offsets  # noqa: F401
from tests.test_torch_dp_cli_ssl import _d2v_args, _hubert_args
from tests.test_torch_dp_cli_ssl import km  # noqa: F401
from tests.test_torch_ssl_cli import corpus as ssl_corpus  # noqa: F401
from tests.test_torch_threads import cap_torch_threads
from tests.torch_dp_ranks import kept_offsets, run_cli_ranks
from tests.torch_zero_ranks import close_logs, same_saves

cap_torch_threads()

ADAM = ["--optim", "adamw", "--lr", "0.001", "--weight_decay", "0.01"]
MODES = {"dp": [], "zero1": ["--zero1", "true"], "fsdp": ["--fsdp", "true"]}
TRAINERS = ("hubert", "data2vec")


@pytest.fixture(scope="module")
def ranks(km, ssl_corpus, tmp_path_factory):
    """Both trainers under each mode on one pair of ranks."""
    root = tmp_path_factory.mktemp("zero_cli_ssl")
    with kept_offsets():
        args = {"hubert": lambda b: ("audio8_tpu_torch.cli.pretrain_hubert",
                                     _hubert_args(km, b)),
                "data2vec": lambda b: (
                    "audio8_tpu_torch.cli.pretrain_data2vec",
                    _d2v_args(ssl_corpus, b))}
        keys = [(t, m) for t in TRAINERS for m in MODES]
        jobs = []
        for t, m in keys:
            module, argv = args[t](str(root / f"{t}_{m}"))
            jobs.append((module, argv + ADAM + MODES[m]))
        out = run_cli_ranks(jobs, 2, root / "ranks")
        yield root, dict(zip(keys, out))
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("trainer", TRAINERS)
@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_sharded_trainer_matches_data_parallel(ranks, trainer, mode):
    root, runs = ranks
    two, dp = runs[(trainer, mode)], runs[(trainer, "dp")]
    assert two[0]["log"] == [dict(r, seconds=two[0]["log"][i]["seconds"])
                             for i, r in enumerate(two[1]["log"])]
    close_logs(two[0]["log"], dp[0]["log"])
    for k, v in two[0]["params"].items():
        assert torch.equal(v, two[1]["params"][k]), k
        assert float((v - dp[0]["params"][k]).abs().max()) <= 1e-6, k
    names = same_saves(root / f"{trainer}_{mode}", root / f"{trainer}_dp")
    if trainer == "data2vec":
        assert "teacher-step-2.pt" in names
