"""Restart, resume and preemption in the port against the JAX package,
on the CPU.

* ``cli.common.resolve_restart`` on the committed fairseq golden
  checkpoints gives the weights of JAX's ``resolve_restart`` from the
  same init: a pretrained ``.pt`` warm-starts the CTC model's encoder
  (the head keeps its init, the quantizer and projections drop), a CTC
  ``.pt`` falls back to the CTC layout, the pretraining model takes a
  pretrained ``.pt`` whole; a ``.pt`` starts at step 0; a directory
  picks its latest ``checkpoint-step-N.pt`` and starts at N, as JAX's
  ``find_latest_checkpoint`` and ``parse_checkpoint_step`` read the same
  names, or at 0 under ``--restart_tt ignore``; an HF
  ``save_pretrained`` directory warm-starts at step 0 with JAX's
  weights (a ForCTC directory fills the CTC model, or the pretraining
  model with its encoder) and a topology that is not the model's raises
  ``ValueError`` in both packages.
* The resume file's round trip through the run's directory is bitwise
  (weights, AdamW moments, step count); a resume file of another kind or
  shape restores nothing, and a ``.pt`` named directly is a warm start
  at step 0 even with a resume file beside it.
* ``PreemptionGuard`` fires once after SIGTERM. A ``cli.train``
  subprocess sent SIGTERM saves, exits 0, and a restart from its
  directory continues at the saved step with the saved moments.
* The port's twin of ``tests/test_cli_e2e.py::
  test_pretrain_then_finetune_cli``: pretrain, fine-tune from the
  pretraining directory with the encoder frozen (printing a beam-decoded
  validation sample under ``--verbose``), evaluate; the frozen
  extractor's weights in the fine-tuned ``.pt`` equal the pretrained
  ``.pt``'s (the port's AdamW leaves a frozen leaf as it is at the
  trainer's weight decay 0).
"""
import os
import shutil
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.cli.common import resolve_restart as jax_resolve_restart
from audio8_tpu.config import AcousticConfig as JaxConfig
from audio8_tpu.config import PretrainConfig as JaxPretrainConfig
from audio8_tpu.models.wav2vec2 import Wav2Vec2AcousticModel as JaxModel
from audio8_tpu.models.wav2vec2 import Wav2Vec2Model as JaxPretrainModel
from audio8_tpu.train.checkpoint import \
    find_latest_checkpoint as jax_find_latest
from audio8_tpu.train.checkpoint import \
    parse_checkpoint_step as jax_parse_step
from audio8_tpu_torch.cli import pretrain as pretrain_cli
from audio8_tpu_torch.cli import test as test_cli
from audio8_tpu_torch.cli import train as train_cli
from audio8_tpu_torch.cli.common import resolve_restart
from audio8_tpu_torch.config import AcousticConfig, PretrainConfig
from audio8_tpu_torch.models.convert import (load_fairseq_ctc,
                                             load_fairseq_pretrained,
                                             params_from_jax)
from audio8_tpu_torch.models.wav2vec2 import (Wav2Vec2AcousticModel,
                                              Wav2Vec2Model)
from audio8_tpu_torch.train.checkpoint import (find_latest_checkpoint,
                                               load_resume,
                                               parse_checkpoint_step,
                                               resume_path, save_checkpoint)
from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                          create_optimizer)
from audio8_tpu_torch.train.preempt import PreemptionGuard
from audio8_tpu_torch.utils import Offsets

from tests.test_torch_pretrain import CFG
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

PRE_CFG = dict(CFG, d_ff=256)  # the golden pretrained checkpoint's
from tests.test_torch_pretrain_cli import SMALL as PRE_SMALL
from tests.test_torch_pretrain_cli import corpus as pretrain_corpus  # noqa
from tests.test_torch_train_cli import SMALL, _train_args, corpus  # noqa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures", "fairseq_golden")
FX = ((32, 10, 5), (32, 3, 2))
CTC_CFG = dict(num_labels=12, d_model=64, num_heads=4, num_layers=2,
               d_ff=256, custom_conv_features=FX, dropout=0.0,
               timestep_masking=0.0, channel_masking=0.0)


@pytest.fixture(autouse=True)
def _restore_port_offsets():
    saved = (Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK,
             list(Offsets.VALUES))
    yield
    Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK = saved[:4]
    Offsets.VALUES[:] = saved[4]


def _state(model):
    return TrainState(model, create_optimizer(create_lrs(
        1e-3, 10, sched_type="constant", warmup_steps=0)))


def _jax_init(ctc: bool):
    if ctc:
        return JaxModel(config=JaxConfig(**CTC_CFG)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4000)))["params"]
    rngs = {k: jax.random.PRNGKey(i)
            for i, k in enumerate(("params", "mask", "gumbel", "dropout"))}
    return JaxPretrainModel(config=JaxPretrainConfig(**PRE_CFG)).init(
        rngs, jnp.zeros((2, 4000)), train=True)["params"]


def _port_model(ctc: bool, init):
    model = (Wav2Vec2AcousticModel(AcousticConfig(**CTC_CFG)) if ctc
             else Wav2Vec2Model(PretrainConfig(**PRE_CFG)))
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, init)),
                          strict=True)
    return model


@pytest.mark.parametrize("source,ctc", [("pretrained_tiny.pt", True),
                                        ("ctc_tiny.pt", True),
                                        ("pretrained_tiny.pt", False)])
def test_fairseq_pt_loads_as_in_jax(source, ctc):
    init = _jax_init(ctc)
    path = os.path.join(FIX, source)
    want, _, jstep = jax_resolve_restart(path, init, ctc=ctc, num_layers=2)
    want = params_from_jax(jax.tree.map(np.asarray, want))
    state = _state(_port_model(ctc, init))
    assert resolve_restart(path, state, ctc=ctc) == jstep == 0
    assert state.step == state.opt_state.count == 0
    got = state.model.state_dict()
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    if source == "pretrained_tiny.pt" and ctc:  # the head kept its init
        fresh = params_from_jax(jax.tree.map(np.asarray, init))
        assert torch.equal(got["proj.weight"], fresh["proj.weight"])
        enc = load_fairseq_pretrained(path)["encoder.layers.0.fc1.weight"]
        assert torch.equal(got["encoder.encoder.layers.0.fc1.weight"], enc)


@pytest.mark.parametrize("restart_tt", [None, "ignore"])
def test_directory_picks_the_latest_step(tmp_path, restart_tt):
    run = tmp_path / "run"
    run.mkdir()
    shutil.copy(os.path.join(FIX, "pretrained_tiny.pt"),
                run / "checkpoint-step-3.pt")
    shutil.copy(os.path.join(FIX, "ctc_tiny.pt"), run / "checkpoint-step-7.pt")
    (run / "checkpoint-best.pt").write_bytes(b"")
    jax_run = tmp_path / "jax_run"  # the same names, as JAX's checkpoints
    for name in ("checkpoint-step-3", "checkpoint-step-7", "checkpoint-best"):
        (jax_run / name).mkdir(parents=True)
    jpath, jstep = jax_find_latest(str(jax_run))
    path, step = find_latest_checkpoint(str(run))
    assert (os.path.basename(path), step) == \
        (os.path.basename(jpath) + ".pt", jstep) == ("checkpoint-step-7.pt", 7)
    assert parse_checkpoint_step(path) == jax_parse_step(jpath) == 7

    init = _jax_init(True)
    state = _state(_port_model(True, init))
    got = resolve_restart(str(run), state, ctc=True, restart_tt=restart_tt)
    assert got == state.step == state.opt_state.count == \
        (0 if restart_tt == "ignore" else 7)
    want = load_fairseq_ctc(os.path.join(FIX, "ctc_tiny.pt"))
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, want[k]), k


HF_TOPOLOGY = dict(pre_norm=True, extractor_mode="layer", conv_bias=True)
HF_CFG = dict(CTC_CFG, num_labels=16, d_ff=128)


@pytest.mark.parametrize("ctc,topology", [
    (True, HF_TOPOLOGY), (False, HF_TOPOLOGY),
    (True, dict(HF_TOPOLOGY, pre_norm=False))])
def test_hf_directory_loads_as_in_jax(tmp_path, ctc, topology):
    """The stable-LN golden fixture (a ``Wav2Vec2ForCTC`` directory)."""
    from tests.test_torch_hf import unpack_fixture

    d, _, _ = unpack_fixture("wav2vec2_stable_ln", tmp_path / "hf")
    if ctc:
        jmodel = JaxModel(config=JaxConfig(**HF_CFG, **topology))
        init = jmodel.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 4000)))["params"]
        model = Wav2Vec2AcousticModel(AcousticConfig(**HF_CFG, **topology))
    else:
        kw = dict(PRE_CFG, d_ff=128, **topology)
        rngs = {k: jax.random.PRNGKey(i) for i, k in
                enumerate(("params", "mask", "gumbel", "dropout"))}
        init = JaxPretrainModel(config=JaxPretrainConfig(**kw)).init(
            rngs, jnp.zeros((2, 4000)), train=True)["params"]
        model = Wav2Vec2Model(PretrainConfig(**kw))
    init = jax.tree.map(np.asarray, init)
    model.load_state_dict(params_from_jax(init), strict=True)
    state = _state(model)
    if not topology["pre_norm"]:
        with pytest.raises(ValueError, match="topology"):
            jax_resolve_restart(d, init, ctc=ctc, num_layers=2, **topology)
        with pytest.raises(ValueError, match="topology"):
            resolve_restart(d, state, ctc=ctc)
        return
    want, _, jstep = jax_resolve_restart(d, init, ctc=ctc, num_layers=2,
                                         **topology)
    want = params_from_jax(jax.tree.map(np.asarray, want))
    assert resolve_restart(d, state, ctc=ctc) == jstep == 0
    assert state.step == state.opt_state.count == 0
    got = state.model.state_dict()
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k


def _trained_state(seed):
    model = Wav2Vec2AcousticModel(AcousticConfig(**CTC_CFG),
                                  generator=torch.Generator().manual_seed(0))
    state = _state(model)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(3):
        state.apply_gradients([torch.randn(p.shape, generator=gen)
                               for p in state.params], clip_norm=1.0)
    return state


def test_resume_file_round_trip_is_bitwise(tmp_path):
    state = _trained_state(1)
    path = save_checkpoint(state, str(tmp_path / "checkpoint-step-3.pt"),
                           "ctc")
    assert os.path.exists(resume_path(path))
    fresh = _state(Wav2Vec2AcousticModel(AcousticConfig(**CTC_CFG)))
    assert resolve_restart(str(tmp_path), fresh, ctc=True) == 3
    assert fresh.step == fresh.opt_state.count == 3
    for a, b in zip(state.params, fresh.params):
        assert torch.equal(a, b)
    for a, b in zip(state.opt_state.mu + state.opt_state.nu,
                    fresh.opt_state.mu + fresh.opt_state.nu):
        assert torch.equal(a, b)
    assert fresh.current_lr == state.current_lr
    direct = _state(Wav2Vec2AcousticModel(AcousticConfig(**CTC_CFG)))
    assert resolve_restart(path, direct, ctc=True) == direct.step == 0
    assert all(not m.any() for m in direct.opt_state.mu)
    for a, b in zip(state.params, direct.params):
        assert torch.equal(a, b)
    # another kind, or other shapes: the moments stay, nothing restores
    other = _state(Wav2Vec2AcousticModel(AcousticConfig(**CTC_CFG)))
    assert load_resume(other, path, "pretrain") is None
    assert other.step == 0 and all(not m.any() for m in other.opt_state.mu)
    wider = _state(Wav2Vec2AcousticModel(AcousticConfig(
        **dict(CTC_CFG, d_ff=128))))
    assert load_resume(wider, path, "ctc") is None and wider.step == 0


def test_preemption_guard_fires_once():
    guard = PreemptionGuard()
    try:
        assert not guard.should_save(1)
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.time() + 5
        while not guard._flag.is_set() and time.time() < deadline:
            time.sleep(0.01)
        assert guard.should_save(2)
        assert not guard.should_save(3) and not guard.should_save(4)
    finally:
        guard.close()
    assert signal.getsignal(signal.SIGTERM) is not guard._on_signal


def test_sigterm_saves_exits_0_and_resumes(corpus, tmp_path):
    basedir = str(tmp_path / "run")
    args = _train_args(corpus, basedir)
    for flag, value in (("--train_steps", "100000"),
                        ("--steps_per_checkpoint", "100000"),
                        ("--unfreeze_enc_after_step", "0")):
        args[args.index(flag) + 1] = value
    proc = subprocess.Popen(
        [sys.executable, "-m", "audio8_tpu_torch.cli.train", *args],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        for line in proc.stderr:  # the guard is installed by now
            if "Model has" in line:
                break
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-2000:]
    path, saved = find_latest_checkpoint(basedir)
    assert saved >= 1 and "preempted: saved step" in err
    blob = torch.load(resume_path(path), weights_only=True)
    assert blob["step"] == blob["count"] == saved

    args[args.index("--train_steps") + 1] = str(saved + 2)
    state = train_cli.train(args + ["--restart_from", basedir])
    assert [r["step"] for r in state.log] == [saved + 1, saved + 2]
    assert state.step == state.opt_state.count == saved + 2
    assert not state.log[0]["frozen"]


def test_pretrain_resumes_its_temperature(pretrain_corpus, tmp_path):
    basedir = str(tmp_path / "pre")
    args = PRE_SMALL + ["--manifest_dir", str(pretrain_corpus),
                        "--basedir", basedir, "--tokens_per_batch", "16000",
                        "--max_sample_len", "8000", "--train_steps", "3",
                        "--steps_per_checkpoint", "1", "--valid_steps", "1",
                        "--warmup_steps", "2", "--num_train_workers", "1"]
    whole = pretrain_cli.train(args)
    args[args.index("--train_steps") + 1] = "5"
    more = pretrain_cli.train(args + ["--restart_from", basedir])
    assert [r["step"] for r in more.log] == [4, 5]
    temps = [r["temperature"] for r in whole.log + more.log]
    assert temps == sorted(temps, reverse=True) and len(set(temps)) == 5
    assert more.opt_state.count == 5


def test_pretrain_then_finetune_cli(corpus, tmp_path, capsys):
    pre_dir = str(tmp_path / "pre")
    pretrain_cli.train([
        "--basedir", pre_dir, "--manifest_dir", str(corpus),
        "--d_model", "32", "--num_heads", "2", "--num_layers", "1",
        "--d_ff", "64", "--num_vq_vars", "8", "--num_vq_groups", "2",
        "--tokens_per_batch", "16000", "--max_sample_len", "12000",
        "--train_steps", "2", "--steps_per_checkpoint", "2",
        "--valid_steps", "1", "--warmup_steps", "2", "--n_negatives", "10",
        "--buckets", "4000", "8000", "12000", "--device", "cpu",
        "--num_train_workers", "1"])
    ft_dir = str(tmp_path / "ft")
    args = _train_args(corpus, ft_dir)
    for flag, value in (("--train_steps", "2"), ("--grad_accum", "1"),
                        ("--steps_per_checkpoint", "2"),
                        ("--valid_steps", "1"), ("--warmup_steps", "1"),
                        ("--unfreeze_enc_after_step", "100"),
                        ("--timestep_masking", "0.0")):
        args[args.index(flag) + 1] = value
    state = train_cli.train(args + [
        "--restart_from", pre_dir, "--restart_tt", "ignore",
        "--dropout", "0.0", "--channel_masking", "0.0",
        "--verbose", "true", "--beam", "4"])
    assert state.step == 2 and [r["step"] for r in state.log] == [1, 2]
    # --verbose: one beam transcript per validation batch, as in JAX
    assert len(capsys.readouterr().out.splitlines()) >= 2

    pre = load_fairseq_pretrained(find_latest_checkpoint(pre_dir)[0])
    ft = load_fairseq_ctc(find_latest_checkpoint(ft_dir)[0])
    fx = [k for k in pre if k.startswith("feature_extractor.")]
    assert fx
    for k in fx:
        assert torch.equal(pre[k], ft["encoder." + k]), k
    metrics = test_cli.evaluate(SMALL + [
        "--basedir", ft_dir, "--root_dir", str(corpus),
        "--valid_dataset", "valid.tsv", "--target_tokens_per_batch", "40000",
        "--valid_steps", "3", "--pad_to_multiple", "4000"])
    assert "wer" in metrics and metrics["wer"] >= 0
