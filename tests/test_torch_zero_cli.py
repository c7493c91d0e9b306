"""``--zero1`` and ``--fsdp`` in ``cli.train`` (CTC) and ``cli.pretrain``
(with ``--moe_experts 4``: the expert leaves shard like any leaf) on two
gloo ranks on the CPU, held to the same trainer's ``--distributed`` DP
run: every logged loss within rtol 1e-6, and every ``.pt`` and resume file
(whole parameters, AdamW moments, counts) within 1e-6 absolute. The
checkpoints cross: a 2-rank ZeRO-1 save resumes in one plain process as
the DP save does, a plain save resumes under 2-rank FSDP as under 2-rank
DP, and the Orbax directory ``cli.convert_checkpoint --output_format
orbax`` writes from a ZeRO-1 save is restored by the JAX package's
``load_checkpoint`` with the DP save's moments. A SIGTERM on one FSDP
rank saves whole state at the next step on every rank and ends the run
(no hang). One rank (``WORLD_SIZE`` 1): the flags shard nothing, and the
runs are bitwise the plain runs (2 CTC steps, 1 pretraining step)."""
import os
import shutil
import socket

import jax
import numpy as np
import pytest
import torch

from audio8_tpu.train.checkpoint import load_checkpoint as jax_load
from audio8_tpu_torch.cli import convert_checkpoint
from audio8_tpu_torch.cli import pretrain as pretrain_cli
from audio8_tpu_torch.cli import train as train_cli
from audio8_tpu_torch.models.text import read_vocab_list
from tests.test_torch_dp_cli import _default_offsets  # noqa: F401
from tests.test_torch_pretrain_cli import SMALL as PRETRAIN_SMALL
from tests.test_torch_pretrain_cli import write_audio_corpus
from tests.test_torch_threads import cap_torch_threads
from tests.test_torch_train_cli import _train_args, write_letter_corpus
from tests.torch_dp_ranks import kept_offsets, run_cli_ranks, subdir
from tests.torch_zero_ranks import (close_logs, run_cli_ranks_sigterm,
                                    same_saves)

cap_torch_threads()

ADAM = ["--optim", "adamw", "--lr", "0.001", "--weight_decay", "0.01",
        "--grad_accum", "1", "--train_steps", "2",
        "--steps_per_checkpoint", "2"]
MODES = {"dp": [], "zero1": ["--zero1", "true"], "fsdp": ["--fsdp", "true"]}
TRAIN = "audio8_tpu_torch.cli.train"
PRETRAIN = "audio8_tpu_torch.cli.pretrain"


def _pretrain_args(corpus, basedir, steps="2"):
    return PRETRAIN_SMALL + [
        "--manifest_dir", str(corpus), "--basedir", basedir,
        "--tokens_per_batch", "16000", "--max_sample_len", "8000",
        "--train_steps", steps, "--steps_per_checkpoint", steps,
        "--warmup_steps", "1", "--num_train_workers", "1",
        "--optim", "adamw", "--lr", "0.001", "--weight_decay", "0.01",
        "--moe_experts", "4", "--moe_every", "1"]


def _job(trainer, corpora, basedir, extra=()):
    if trainer == "train":
        return (TRAIN, _train_args(corpora["train"], basedir) + ADAM
                + list(extra))
    return (PRETRAIN, _pretrain_args(corpora["pretrain"], basedir)
            + list(extra))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both trainers under each mode on one pair of ranks."""
    root = tmp_path_factory.mktemp("zero_cli")
    with kept_offsets():
        corpora = {"train": write_letter_corpus(subdir(root, "train_c")),
                   "pretrain": write_audio_corpus(subdir(root,
                                                         "pretrain_c"))}
        keys = [(t, m) for t in ("train", "pretrain") for m in MODES]
        jobs = [_job(t, corpora, str(root / f"{t}_{m}"), MODES[m])
                for t, m in keys]
        out = run_cli_ranks(jobs, 2, root / "ranks")
        yield root, corpora, dict(zip(keys, out))
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(autouse=True)
def _cleaned(tmp_path):
    """A test's run directories go when it ends (AdamW checkpoints of the
    default extractor: tens of MB each)."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("trainer", ["train", "pretrain"])
@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_sharded_trainer_matches_data_parallel(ranks, trainer, mode):
    root, _, runs = ranks
    two, dp = runs[(trainer, mode)], runs[(trainer, "dp")]
    assert two[0]["log"] == [dict(r, seconds=two[0]["log"][i]["seconds"])
                             for i, r in enumerate(two[1]["log"])]
    close_logs(two[0]["log"], dp[0]["log"])
    for k, v in two[0]["params"].items():
        assert torch.equal(v, two[1]["params"][k]), k
        assert float((v - dp[0]["params"][k]).abs().max()) <= 1e-6, k
    assert same_saves(root / f"{trainer}_{mode}", root / f"{trainer}_dp")


def test_zero1_save_resumes_in_one_process(ranks, tmp_path):
    root, corpora, _ = ranks
    logs = {}
    for mode in ("dp", "zero1"):
        logs[mode] = train_cli.train(
            _train_args(corpora["train"], str(tmp_path / mode)) + ADAM
            + ["--train_steps", "3", "--restart_from",
               str(root / f"train_{mode}")]).log
    assert [r["step"] for r in logs["zero1"]] == [3]
    close_logs(logs["zero1"], logs["dp"])


def test_plain_save_resumes_under_fsdp(ranks, tmp_path):
    _, corpora, _ = ranks
    plain = str(tmp_path / "plain")
    with kept_offsets():
        train_cli.train(_train_args(corpora["train"], plain) + ADAM)
        more = ["--train_steps", "3", "--restart_from", plain]
        dp, fsdp = run_cli_ranks(
            [_job("train", corpora, str(tmp_path / m), more + MODES[m])
             for m in ("dp", "fsdp")], 2, tmp_path / "ranks")
    assert [r["step"] for r in fsdp[0]["log"]] == [3]
    close_logs(fsdp[0]["log"], dp[0]["log"])
    same_saves(tmp_path / "fsdp", tmp_path / "dp")


def test_zero1_orbax_conversion_restores_in_jax(ranks, tmp_path):
    root, corpora, _ = ranks
    labels = len(read_vocab_list(str(corpora["train"] / "dict.ltr.txt")))
    trees = {}
    for mode in ("dp", "zero1"):
        out = convert_checkpoint.main([
            "--input", str(root / f"train_{mode}" / "checkpoint-step-2.pt"),
            "--output", str(tmp_path / mode / "checkpoint"),
            "--output_format", "orbax", "--ctc", "true", "--num_labels",
            str(labels), "--d_model", "32", "--num_heads", "2",
            "--num_layers", "1", "--d_ff", "64", "--device", "cpu"])
        trees[mode] = jax_load(out)
    assert "opt_state" in trees["zero1"] and int(trees["zero1"]["step"]) == 2
    mine, want = (jax.tree_util.tree_leaves_with_path(trees[m])
                  for m in ("zero1", "dp"))
    assert [p for p, _ in mine] == [p for p, _ in want]
    moments = 0
    for (path, a), (_, b) in zip(mine, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=1e-6, err_msg=str(path))
        moments += any(getattr(k, "key", getattr(k, "name", None))
                       in ("mu", "nu") for k in path)
    assert moments > 0


def test_sigterm_under_fsdp_saves_and_ends(ranks, tmp_path):
    _, corpora, _ = ranks
    basedir = tmp_path / "run"
    with kept_offsets():
        (out,) = run_cli_ranks_sigterm(
            [_job("train", corpora, str(basedir),
                  ["--fsdp", "true", "--train_steps", "3",
                   "--steps_per_checkpoint", "3"])],
            2, tmp_path / "ranks", sender=1, timeout=240)
    assert [r["step"] for r in out[0]["log"]] == [1]
    assert [r["step"] for r in out[1]["log"]] == [1]
    assert sorted(os.listdir(basedir)) == ["checkpoint-step-1.pt",
                                           "checkpoint-step-1.resume"]
    blob = torch.load(basedir / "checkpoint-step-1.resume")
    assert blob["step"] == 1 and len(blob["mu"]) == len(blob["names"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_one_rank_is_the_plain_run(ranks, mode, tmp_path, monkeypatch):
    import torch.distributed as dist

    _, corpora, _ = ranks
    plain = {"train": train_cli.train(
        _train_args(corpora["train"], str(tmp_path / "p")) + ADAM),
             "pretrain": pretrain_cli.train(_pretrain_args(
                 corpora["pretrain"], str(tmp_path / "pp"), steps="1"))}
    for k, v in dict(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
                     MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(k, v)
    flags = ["--distributed", "true"] + MODES[mode]
    try:
        one = {"train": train_cli.train(
            _train_args(corpora["train"], str(tmp_path / "o")) + ADAM
            + flags),
               "pretrain": pretrain_cli.train(_pretrain_args(
                   corpora["pretrain"], str(tmp_path / "op"), steps="1")
                   + flags)}
        assert dist.is_initialized() and dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    for kind in ("train", "pretrain"):
        assert one[kind].shards is None
        assert [r["loss"] for r in one[kind].log] == \
            [r["loss"] for r in plain[kind].log]
        for a, b in zip(one[kind].params, plain[kind].params):
            assert torch.equal(a, b)
