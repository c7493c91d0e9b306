"""``--zero1`` and ``--fsdp`` in ``cli.train_seq2seq``,
``cli.train_transducer`` and ``cli.pretrain_paired`` on two gloo ranks on
the CPU, each held to the same trainer's ``--distributed`` DP run (AdamW,
one update per step): every logged loss within rtol 1e-6, and every
``.pt`` and resume file (whole parameters, moments) within 1e-6 absolute.
Seq2seq's first step runs its encoder frozen (``--unfreeze_enc_after_step
0``), paired's its towers (``--unfreeze_*_after_step 0``): the
frozen leaves get zero gradients and still decay. Under FSDP the decoder,
text-encoder and predictor layers are units of their own, and the
validation decodes (greedy, beam) gather the whole model."""
import shutil

import pytest
import torch

from tests.test_torch_dp_cli import _default_offsets  # noqa: F401
from tests.test_torch_paired_cli import _args as paired_args
from tests.test_torch_paired_cli import write_paired_corpus
from tests.test_torch_seq2seq_cli import _args as s2s_args
from tests.test_torch_threads import cap_torch_threads
from tests.test_torch_train_cli import write_letter_corpus
from tests.test_torch_transducer_cli import _train_args as rnnt_args
from tests.test_torch_transducer_cli import write_corpus
from tests.torch_dp_ranks import kept_offsets, run_cli_ranks, subdir
from tests.torch_zero_ranks import close_logs, same_saves

cap_torch_threads()

ADAM = ["--optim", "adamw", "--lr", "0.001", "--weight_decay", "0.01",
        "--grad_accum", "1", "--train_steps", "2",
        "--steps_per_checkpoint", "2"]
MODES = {"dp": [], "zero1": ["--zero1", "true"], "fsdp": ["--fsdp", "true"]}
TRAINERS = ("seq2seq", "transducer", "paired")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The three trainers under each mode on one pair of ranks."""
    root = tmp_path_factory.mktemp("zero_cli_more")
    with kept_offsets():
        s2s = write_letter_corpus(subdir(root, "s2s"))
        rnnt = subdir(root, "rnnt")
        write_corpus(rnnt)
        paired = write_paired_corpus(subdir(root, "paired"))
        args = {
            "seq2seq": lambda b: ("audio8_tpu_torch.cli.train_seq2seq",
                                  s2s_args(s2s, b) + ADAM
                                  + ["--valid_steps", "1",
                                     "--unfreeze_enc_after_step", "0"]),
            "transducer": lambda b: ("audio8_tpu_torch.cli.train_transducer",
                                     rnnt_args(rnnt, b, 2) + ADAM
                                     + ["--valid_steps", "1"]),
            "paired": lambda b: ("audio8_tpu_torch.cli.pretrain_paired",
                                 paired_args(paired, b) + ADAM
                                 + ["--unfreeze_text_after_step", "0"])}
        keys = [(t, m) for t in TRAINERS for m in MODES]
        jobs = []
        for t, m in keys:
            module, argv = args[t](str(root / f"{t}_{m}"))
            jobs.append((module, argv + MODES[m]))
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
    if trainer == "seq2seq":
        assert [r["frozen"] for r in dp[0]["log"]] == [True, False]
    if trainer == "paired":
        assert [r["freeze_text"] for r in dp[0]["log"]] == [True, False]
    if trainer != "paired":  # the validation decodes score as DP's
        assert [v["cer"] for v in two[0]["valid"]] == \
            [v["cer"] for v in dp[0]["valid"]]
    assert same_saves(root / f"{trainer}_{mode}", root / f"{trainer}_dp")
