"""The port's pretraining entry point end to end on the CPU: ``cli.pretrain
--device cpu`` takes 10 steps of two 0.5 s rows on a tiny synthetic
corpus (dropout and time masking on, the Gumbel temperature annealing),
validates, and writes fairseq-layout pretrained checkpoints that load
back, each with its resume file; bucketed batches train too, and so do
``--optim sgd``, ``--remat`` and ``--profile_dir``. Flags of parts not
ported yet raise (``--restart_from`` is ported and tested in
``tests/test_torch_restart.py``)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from audio8_tpu_torch.cli import pretrain
from audio8_tpu_torch.config import PretrainConfig
from audio8_tpu_torch.models.convert import load_fairseq_pretrained
from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2Model
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

SMALL = ["--d_model", "32", "--num_heads", "2", "--num_layers", "1",
         "--d_ff", "64", "--final_dim", "16", "--num_vq_vars", "8",
         "--n_negatives", "10", "--device", "cpu"]


def write_audio_corpus(root):
    """Eight train and three valid unlabelled clips under ``root``;
    returns it."""
    rng = np.random.default_rng(0)
    for split, n in (("train", 8), ("valid", 3)):
        with open(root / f"{split}.tsv", "w") as tf:
            tf.write(str(root) + "\n")
            for i in range(n):
                samples = int(rng.integers(8000, 20000))
                wavfile.write(str(root / f"{split}{i}.wav"), 16000,
                              (rng.normal(size=samples) * 3000)
                              .astype(np.int16))
                tf.write(f"{split}{i}.wav\t{samples}\n")
    return root


@pytest.fixture
def corpus(tmp_path):
    return write_audio_corpus(tmp_path)


def _args(corpus, basedir, steps=10):
    return SMALL + ["--manifest_dir", str(corpus), "--basedir", basedir,
                    "--tokens_per_batch", "16000", "--max_sample_len",
                    "8000", "--train_steps", str(steps),
                    "--steps_per_checkpoint", "1", "--valid_steps", "2",
                    "--warmup_steps", "2", "--num_train_workers", "1"]


def test_pretrain_writes_checkpoints_that_load(corpus, tmp_path):
    basedir = str(tmp_path / "run")
    state = pretrain.train(_args(corpus, basedir))
    log = state.log
    assert state.step == 10 and len(log) == 10
    assert all(np.isfinite(r["loss"]) and r["audio_s"] > 0 for r in log)
    assert all(0.0 <= r["accuracy"] <= 1.0 and 1.0 <= r["code_perplexity"]
               <= 16.0 for r in log)  # G * V = 2 * 8 codewords
    temps = [r["temperature"] for r in log]
    assert temps[0] == 2.0 and temps == sorted(temps, reverse=True)
    ckpts = {f for f in os.listdir(basedir) if f.endswith(".pt")}
    assert ckpts == {f"checkpoint-step-{i}.pt" for i in range(1, 11)}
    model = Wav2Vec2Model(PretrainConfig(
        d_model=32, num_heads=2, num_layers=1, d_ff=64, final_dim=16,
        num_vq_vars=8))
    state_dict = load_fairseq_pretrained(
        os.path.join(basedir, "checkpoint-step-10.pt"))
    model.load_state_dict(state_dict, strict=True)
    for k, v in state.model.state_dict().items():
        assert torch.equal(state_dict[k], v), k


def test_module_entry_point(corpus, tmp_path):
    """``python -m audio8_tpu_torch.cli.pretrain`` runs the training loop."""
    basedir = str(tmp_path / "run")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "audio8_tpu_torch.cli.pretrain",
         *_args(corpus, basedir, steps=1)], cwd=root, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert sorted(os.listdir(basedir)) == ["checkpoint-step-1.pt",
                                           "checkpoint-step-1.resume"]


def test_pretrain_with_bucketing(corpus, tmp_path):
    state = pretrain.train(_args(corpus, str(tmp_path / "run"), steps=3)
                           + ["--bucketing", "true", "--buckets", "8000",
                              "12000"])
    assert state.step == 3
    # 2 rows of the 8000-sample bucket or 1 of the 12000-sample one
    assert {(r["rows"], r["samples"], r["audio_s"]) for r in state.log} \
        <= {(2, 8000, 1.0), (1, 12000, 0.75)}


@pytest.mark.parametrize("flag", [["--distributed", "true",
                                   "--tensor_parallel", "2", "--zero1",
                                   "true"],
                                  ["--tensor_parallel", "2", "--fsdp",
                                   "true"],
                                  # sharding and the model group run,
                                  # not side by side
                                  ["--zero1", "true", "--tensor_parallel",
                                   "2"],
                                  ["--fsdp", "true", "--sequence_parallel",
                                   "true", "--tensor_parallel", "2"],
                                  ["--sequence_parallel", "true",
                                   "--tensor_parallel", "2", "--zero1",
                                   "true"],
                                  ["--moe_experts", "4",
                                   "--tensor_parallel", "2"]])
def test_unported_flags_raise(corpus, tmp_path, flag):
    with pytest.raises(NotImplementedError):
        pretrain.train(_args(corpus, str(tmp_path / "r"), steps=1) + flag)


@pytest.mark.parametrize("flag", [["--optim", "sgd"], ["--remat", "true"],
                                  ["--profile_dir", "{tmp}"]])
def test_trainer_flags_pretrain(corpus, tmp_path, flag):
    """``--optim sgd``, ``--remat`` and ``--profile_dir``, which raised
    before they were ported, pretrain; the profiler's window opens after
    step 10 and its trace is written when the 11-step run ends."""
    from audio8_tpu_torch.train.optim import SGDState

    flag = [f.replace("{tmp}", str(tmp_path / "p")) for f in flag]
    profiled = flag[0] == "--profile_dir"
    state = pretrain.train(_args(corpus, str(tmp_path / "r"),
                                 steps=11 if profiled else 2) + flag)
    assert all(np.isfinite(r["loss"]) for r in state.log)
    assert isinstance(state.opt_state, SGDState) == (flag[0] == "--optim")
    assert state.model.config.remat == (flag[0] == "--remat")
    assert (state.profile_trace is not None) == profiled
    if profiled:
        assert os.listdir(tmp_path / "p") == ["trace-steps-10-15.json"]


@pytest.mark.parametrize("flag", [["--extractor_mode", "layer",
                                   "--conv_bias", "true"],
                                  ["--layer_drop", "0.5"],
                                  ["--moe_experts", "4", "--moe_every", "1"]])
def test_ported_flags_pretrain(corpus, tmp_path, flag):
    """The layer-norm extractor with conv bias, LayerDrop and the MoE FFN,
    which raised before they were ported, pretrain; the MoE run logs its
    load-balance loss, at least its floor of 1."""
    state = pretrain.train(_args(corpus, str(tmp_path / "r"), steps=2)
                           + flag)
    assert state.step == 2
    assert all(np.isfinite(r["loss"]) for r in state.log)
    moe = flag[0] == "--moe_experts"
    assert all(("moe_aux" in r) == moe for r in state.log)
    assert all(r["moe_aux"] >= 1.0 - 1e-5 for r in state.log if moe)


def test_final_dim_follows_the_preset():
    base = pretrain.parse_args(["--manifest_dir", "m"])
    large = pretrain.parse_args(["--manifest_dir", "m", "--preset", "large"])
    assert (base.final_dim, base.d_model) == (256, 768)
    assert (large.final_dim, large.d_model) == (768, 1024)
    assert pretrain.parse_args(["--manifest_dir", "m", "--preset", "large",
                                "--final_dim", "64"]).final_dim == 64
