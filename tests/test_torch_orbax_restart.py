"""Runs that cross between the JAX package's Orbax checkpoints and the
port, on the CPU: weights, optimizer moments and step, both ways.

* Resumes, CTC here and pretraining in
  ``tests/test_torch_orbax_restart_pretrain.py``, under ``adamw``,
  ``fused_adamw`` and ``sgd`` (tiny models of ``tests/fixtures/orbax_golden``'s configs,
  dropout off, a warmup-cosine schedule): JAX trains 3 steps and saves,
  the port's ``resolve_restart`` restores the full state (step 3, the
  count and the moments bitwise) and trains 2 more, within the
  trajectory tolerances of JAX's 5; the port trains 3 and saves its
  ``.pt`` and resume file, ``cli.convert_checkpoint``'s Orbax writer
  (``to_orbax``) writes the TrainState, JAX's ``resolve_restart``
  restores it whole (not its params-only fallback) and trains 2 more,
  within the tolerances of the port's 5.
* ``--optim`` other than the saved one: both packages fall back to the
  params and the step of the name.
* A JAX pretraining checkpoint warm-starts the CTC model's ``encoder``
  as JAX's ``resolve_restart`` does (the heads dropped, the CTC head
  kept), at the step of the name.
* A run's directory with a ``.pt`` and an Orbax directory takes the
  newer, and raises at one step.
* ``cli.train --distributed true`` on two gloo ranks resumes a JAX run's
  full state on every rank, as one process does.
* Decoding: ``cli.test`` on a JAX-written run directory scores as JAX's
  ``evaluate``; ``cli.transcribe`` on the golden CTC directory gives
  JAX's transcripts, and the ``.pt`` that ``cli.convert_checkpoint``
  writes from it (with a resume file that restores the moments) the same
  log-probs bitwise; the n-best rescorer reads a
  JAX ``a8t-train-lm`` basedir (``lm_config.json`` and its latest Orbax
  checkpoint) and scores as JAX's; ``cli.train_lm --restart_from`` takes
  its full state.
"""
import dataclasses
import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from audio8_tpu.cli.common import resolve_restart as jax_resolve_restart
from audio8_tpu.config import AcousticConfig as JaxAcousticConfig
from audio8_tpu.config import PretrainConfig as JaxPretrainConfig
from audio8_tpu.models.wav2vec2 import Wav2Vec2AcousticModel as JaxCtcModel
from audio8_tpu.models.wav2vec2 import Wav2Vec2Model as JaxPretrainModel
from audio8_tpu.train import steps as jax_steps
from audio8_tpu.train.checkpoint import load_checkpoint as jax_load
from audio8_tpu.train.checkpoint import save_checkpoint as jax_save
from audio8_tpu.train.optim import TrainState as JaxState
from audio8_tpu.train.optim import create_lrs as jax_lrs
from audio8_tpu.train.optim import create_optimizer as jax_opt
from audio8_tpu.utils import Offsets as JaxOffsets
from audio8_tpu_torch.cli.common import resolve_restart
from audio8_tpu_torch.cli.convert_checkpoint import to_orbax
from audio8_tpu_torch.config import AcousticConfig, PretrainConfig
from audio8_tpu_torch.models.convert import params_from_jax
from audio8_tpu_torch.models.wav2vec2 import (Wav2Vec2AcousticModel,
                                              Wav2Vec2Model)
from audio8_tpu_torch.train.checkpoint import (find_latest_checkpoint,
                                               save_checkpoint)
from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                          create_optimizer)
from audio8_tpu_torch.train.steps import make_ctc_steps, make_pretrain_steps
from audio8_tpu_torch.utils import Offsets
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "orbax_golden")
with open(os.path.join(GOLDEN, "MANIFEST.json")) as _f:
    MANIFEST = json.load(_f)


def _config(kind: str) -> dict:
    cfg = dict(MANIFEST[kind]["config"])
    cfg["custom_conv_features"] = tuple(map(tuple,
                                            cfg["custom_conv_features"]))
    return cfg


CTC, PRE = _config("ctc"), _config("pretrain")
SCHED = MANIFEST["schedule"]
WD = 0.01
SAVED, MORE = 3, 2
OPTIMS = ["adamw", "fused_adamw", "sgd"]
# the trajectory tolerances of tests/test_torch_dropout_trajectories.py
# (CTC) and tests/test_torch_pretrain.py (pretraining)
RTOL = {"ctc": (1e-3, 5e-3), "pretrain": (1e-3, 5e-3)}


@pytest.fixture(autouse=True)
def _fairseq_offsets():
    saved = (Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK,
             list(Offsets.VALUES))
    Offsets.remap_fairseq_ctc()
    JaxOffsets.remap_fairseq_ctc()
    yield
    Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK = saved[:4]
    Offsets.VALUES[:] = saved[4]
    JaxOffsets.PAD, JaxOffsets.GO, JaxOffsets.EOS, JaxOffsets.UNK = \
        saved[:4]
    JaxOffsets.VALUES[:] = saved[4]


def _ctc_batch():
    from tools.make_orbax_golden_fixtures import ctc_batch

    return ctc_batch(MANIFEST["ctc"]["batch_seed"])


class CtcRun:
    """Both packages' CTC steps on one batch from one JAX init; JAX's
    gradient function is compiled once for every optimizer."""

    kind, ctc = "ctc", True

    def __init__(self):
        batch = _ctc_batch()
        self.jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        self.tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
        self.jmodel = JaxCtcModel(config=JaxAcousticConfig(**CTC))
        self.params = jax.tree.map(np.asarray, jax.jit(self.jmodel.init)(
            jax.random.PRNGKey(0), self.jbatch["signal"],
            self.jbatch["signal_lengths"])["params"])
        self.jgrad, self.compiled = None, {}

    def jax_tx(self, optim):
        return jax_opt(jax_lrs(**SCHED), optim, WD)

    def jax_steps(self, state, tx, n):
        if id(tx) not in self.compiled:
            self.compiled[id(tx)] = jax_steps.make_ctc_steps(self.jmodel, tx)
        jgrad, jupdate, _ = self.compiled[id(tx)]
        self.jgrad = self.jgrad or jgrad
        losses = []
        for i in range(n):
            loss, g, bsz, _ = self.jgrad(state.params, self.jbatch,
                                         jax.random.PRNGKey(i), freeze=False)
            state, _ = jupdate(state, g, bsz)
            losses.append(float(loss))
        return state, losses

    def port_model(self):
        return Wav2Vec2AcousticModel(AcousticConfig(**CTC))

    def port_steps(self, state, n):
        grad_fn, update_fn, _ = make_ctc_steps(state.model)
        losses = []
        for _ in range(n):
            loss, g, bsz, _ = grad_fn(self.tbatch, None, freeze=False)
            state, _ = update_fn(state, g, bsz)
            losses.append(float(loss))
        return losses


class PretrainRun(CtcRun):
    """Both packages' pretraining steps; the port replays the seeds each
    JAX step draws (``tests/test_torch_pretrain.py:_record``)."""

    kind, ctc = "pretrain", False

    def __init__(self):
        from tools.make_orbax_golden_fixtures import pretrain_signal

        self.signal = pretrain_signal(MANIFEST["pretrain"]["signal_seed"])
        cfg = JaxPretrainConfig(**PRE)
        rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(
            ("params", "mask", "gumbel", "dropout"))}
        self.params = jax.tree.map(np.asarray, JaxPretrainModel(
            config=cfg).init(rngs, self.signal, train=True)["params"])
        self.keys = list(jax.random.split(jax.random.PRNGKey(5),
                                          SAVED + MORE))
        self.seeds = [self._seeds(k) for k in self.keys]
        self.compiled = {}

    def _seeds(self, rng):
        """The seeds of one JAX step at ``rng`` (time mask, Gumbel,
        negatives), recorded from an eager ``apply`` with the step's rng
        folding, as ``tests/test_torch_pretrain.py:_record`` does."""
        from audio8_tpu.ops import hashrand as jax_hashrand
        from audio8_tpu_torch.models.wav2vec2 import PretrainSeeds
        from audio8_tpu_torch.ops.hashrand import MASK32

        real, seen = jax_hashrand.seed_from_key, []

        def recording(key):
            seed = real(key)
            seen.append(int(seed) & MASK32)
            return seed

        jax_hashrand.seed_from_key = recording
        try:
            JaxPretrainModel(config=JaxPretrainConfig(**PRE)).apply(
                {"params": jax.tree.map(jnp.asarray, self.params)},
                jnp.asarray(self.signal), train=True, temperature=2.0,
                rngs={"dropout": jax.random.fold_in(rng, 0),
                      "mask": jax.random.fold_in(rng, 1),
                      "gumbel": jax.random.fold_in(rng, 2)})
        finally:
            jax_hashrand.seed_from_key = real
        neg = int(real(jax.random.fold_in(rng, 3))) & MASK32
        return PretrainSeeds(mask=seen[0], gumbel=seen[-1], negatives=neg)

    def jax_steps(self, state, tx, n):
        if id(tx) not in self.compiled:
            self.compiled[id(tx)] = jax_steps.make_pretrain_steps(
                JaxPretrainModel(config=JaxPretrainConfig(**PRE)), tx,
                clip=1.0, n_negatives=PRE["n_negatives"])
        step, _ = self.compiled[id(tx)]
        losses = []
        first = int(state.step)
        for key in self.keys[first:first + n]:
            state, metrics = step(state, jnp.asarray(self.signal), key)
            losses.append(float(metrics["loss"]))
        return state, losses

    def port_model(self):
        return Wav2Vec2Model(PretrainConfig(**PRE))

    def port_steps(self, state, n):
        step, _ = make_pretrain_steps(state.model, clip=1.0,
                                      n_negatives=PRE["n_negatives"])
        losses = []
        first = state.step
        for seeds in self.seeds[first:first + n]:
            state, metrics = step(state, torch.from_numpy(self.signal),
                                  seeds, torch.Generator())
            losses.append(float(metrics["loss"]))
        return losses


@pytest.fixture(scope="module")
def runs():
    return {"ctc": CtcRun()}


def _port_state(run, optim, params=None):
    model = run.port_model()
    if params is not None:
        model.load_state_dict(params_from_jax(params), strict=True)
    return TrainState(model, create_optimizer(create_lrs(**SCHED), optim,
                                              WD))


def _close(mine, theirs, kind):
    rtol, _ = RTOL[kind]
    np.testing.assert_allclose(mine, theirs, rtol=rtol)


@pytest.mark.parametrize("optim", OPTIMS)
def test_ctc_resumes_both_ways(runs, optim, tmp_path):
    resume_both_ways(runs["ctc"], optim, tmp_path)


def resume_both_ways(run, optim, tmp_path):
    """JAX 3 steps, save, the port 2 more, against JAX's 5; the port 3
    steps, its Orbax TrainState, JAX 2 more, against the port's 5."""
    kind = run.kind
    tx = run.jax_tx(optim)
    jstate = JaxState.create(jax.tree.map(jnp.asarray, run.params), tx)
    jstate, j_first = run.jax_steps(jstate, tx, SAVED)
    saved = jax_save(jstate, str(tmp_path / "jax" / "checkpoint"), SAVED)
    jstate, j_more = run.jax_steps(jstate, tx, MORE)

    # JAX 3 steps -> the port 2 steps, against JAX's 5
    state = _port_state(run, optim)
    assert resolve_restart(str(tmp_path / "jax"), state,
                           ctc=run.ctc) == SAVED
    want_sd, (count, mu, nu) = params_from_jax(
        jax.tree.map(np.asarray, jax_load(saved)["params"]),
        jax.tree.map(np.asarray, jax_load(saved)["opt_state"]))
    assert state.step == state.opt_state.count == count == SAVED
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, want_sd[k]), k
    if mu is not None:
        for i, n in enumerate(state.names):
            assert torch.equal(state.opt_state.mu[i], mu[n]), n
            assert torch.equal(state.opt_state.nu[i], nu[n]), n
    _close(run.port_steps(state, MORE), j_more, kind)

    # the port 3 steps -> JAX 2 steps, against the port's 5
    state = _port_state(run, optim, run.params)
    p_first = run.port_steps(state, SAVED)
    _close(p_first, j_first, kind)
    os.makedirs(tmp_path / "port")
    pt = save_checkpoint(state, str(tmp_path / "port" /
                                    f"checkpoint-step-{SAVED}.pt"), kind)
    p_more = run.port_steps(state, MORE)
    out = to_orbax(_loaded(run, pt), pt, str(tmp_path / "conv" /
                                             "checkpoint"))
    assert os.path.basename(out) == f"checkpoint-step-{SAVED}"
    template = JaxState.create(jax.tree.map(jnp.asarray, run.params), tx)
    _, jstate, step = jax_resolve_restart(
        out, run.params, template, ctc=run.ctc, num_layers=PRE["num_layers"])
    assert jstate is not None and step == SAVED  # the full state
    jstate, j_more = run.jax_steps(jstate, tx, MORE)
    _close(j_more, p_more, kind)


def _loaded(run, pt):
    """The model of the port's ``.pt`` at ``pt``."""
    from audio8_tpu_torch.cli.common import load_weights

    model = run.port_model()
    load_weights(pt, model, run.ctc, run.kind)
    return model


def test_optim_mismatch_falls_back_to_params(runs, tmp_path):
    run = runs["ctc"]
    tx = run.jax_tx("adamw")
    jstate = JaxState.create(jax.tree.map(jnp.asarray, run.params), tx)
    for _ in range(3):
        jstate, _ = jstate.apply_gradients(
            jax.tree.map(lambda p: jnp.full_like(p, 0.01), jstate.params), tx)
    jstate = dataclasses.replace(jstate, step=jnp.asarray(9, jnp.int32))
    path = jax_save(jstate, str(tmp_path / "checkpoint"), 4)
    sgd = run.jax_tx("sgd")
    _, restored, step = jax_resolve_restart(
        path, run.params, JaxState.create(
            jax.tree.map(jnp.asarray, run.params), sgd), ctc=True)
    assert restored is None and step == 4
    state = _port_state(run, "sgd")
    assert resolve_restart(path, state, ctc=True) == 4
    assert state.step == state.opt_state.count == 4
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    state = _port_state(run, "adamw")  # the saved kind: step 9, the leaf's
    assert resolve_restart(path, state, ctc=True) == 9
    assert state.opt_state.count == 3


def test_pretraining_tree_warm_starts_ctc(runs, tmp_path):
    pre = jax.tree.map(np.asarray, JaxPretrainModel(
        config=JaxPretrainConfig(**PRE)).init(
            {k: jax.random.PRNGKey(i) for i, k in enumerate(
                ("params", "mask", "gumbel", "dropout"))},
            jnp.zeros((2, 4000)), train=True)["params"])
    path = jax_save({"params": pre}, str(tmp_path / "checkpoint"), 7)
    run = runs["ctc"]
    state = _port_state(run, "adamw", run.params)
    head = state.model.state_dict()["proj.weight"].clone()
    assert resolve_restart(path, state, ctc=True) == 7
    merged, restored, step = jax_resolve_restart(
        path, run.params, JaxState.create(
            jax.tree.map(jnp.asarray, run.params), run.jax_tx("adamw")),
        ctc=True)
    assert restored is None and step == 7
    want = params_from_jax(jax.tree.map(np.asarray, merged))
    got = state.model.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert torch.equal(got["proj.weight"], head)  # the head keeps its init


def test_directory_of_both_kinds(runs, tmp_path):
    run = runs["ctc"]
    shutil.copytree(os.path.join(GOLDEN, "ctc", "checkpoint-step-2"),
                    tmp_path / "checkpoint-step-2")
    state = _port_state(run, "adamw", run.params)
    save_checkpoint(state, str(tmp_path / "checkpoint-step-1.pt"), "ctc")
    assert find_latest_checkpoint(str(tmp_path)) == (
        str(tmp_path / "checkpoint-step-2"), 2)
    state = _port_state(run, "adamw")
    assert resolve_restart(str(tmp_path), state, ctc=True) == 2
    expected = np.load(os.path.join(GOLDEN, "expected.npz"))
    for i, n in enumerate(state.names):
        assert np.array_equal(state.opt_state.mu[i].numpy(),
                              expected[f"ctc/mu/{n}"]), n
    save_checkpoint(state, str(tmp_path / "checkpoint-step-2.pt"), "ctc")
    with pytest.raises(ValueError, match="two checkpoints at step 2"):
        find_latest_checkpoint(str(tmp_path))


# --------------------------------------------------------------- decoding

def test_cli_test_scores_a_jax_run_as_jax_does(tmp_path):
    from audio8_tpu.cli.test import evaluate as jax_evaluate
    from audio8_tpu.models.text import read_vocab_list
    from audio8_tpu_torch.cli import test as test_cli
    from tests.test_torch_train_cli import SMALL, write_letter_corpus

    corpus = write_letter_corpus(tmp_path)
    vocab = read_vocab_list(str(corpus / "dict.ltr.txt"))
    model = JaxCtcModel(config=JaxAcousticConfig(
        num_labels=len(vocab), d_model=32, num_heads=2, num_layers=1,
        d_ff=64, timestep_masking=0.0, channel_masking=0.0))
    params = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 4000)))
    run = tmp_path / "run"
    jax_save({"params": params["params"]}, str(run / "checkpoint"), 4)
    common = [a for a in SMALL if a not in ("--device", "cpu")] + [
        "--pad_to_multiple", "4000", "--basedir", str(run), "--root_dir",
        str(corpus), "--valid_dataset", "valid.tsv",
        "--target_tokens_per_batch", "40000"]
    ours = test_cli.evaluate(common + ["--device", "cpu"])
    theirs = jax_evaluate(common + ["--lane_align", "false"])
    assert {k: ours[k] for k in theirs} == theirs


def test_transcribe_reads_the_jax_directory(monkeypatch, tmp_path):
    import audio8_tpu.cli.transcribe as jax_transcribe
    import audio8_tpu_torch.cli.transcribe as transcribe
    from audio8_tpu_torch.cli import convert_checkpoint

    fx = CTC["custom_conv_features"]
    monkeypatch.setattr(jax_transcribe, "AcousticConfig", functools.partial(
        JaxAcousticConfig, custom_conv_features=fx))
    monkeypatch.setattr(transcribe, "AcousticConfig", functools.partial(
        AcousticConfig, custom_conv_features=fx))
    monkeypatch.setattr(convert_checkpoint, "AcousticConfig",
                        functools.partial(AcousticConfig,
                                          custom_conv_features=fx))
    dict_file = str(tmp_path / "dict.ltr.txt")
    with open(dict_file, "w") as f:
        f.writelines(f"{c} {100 - i}\n" for i, c in enumerate("|ETAONIH"))
    rng = np.random.default_rng(4)
    wavs = []
    for i in range(2):
        path = str(tmp_path / f"utt{i}.wav")
        wavfile.write(path, 16_000, (rng.normal(size=16_000 + 3000 * i)
                                     * 3000).astype(np.int16))
        wavs.append(path)
    size = ["--d_model", "32", "--num_heads", "2", "--num_layers", "1",
            "--d_ff", "64"]
    src = os.path.join(GOLDEN, "ctc", "checkpoint-step-2")
    args = ["--checkpoint", src, "--dict_file", dict_file, *size]
    theirs = jax_transcribe.main(args + ["--lane_align", "false"] + wavs)
    mine = transcribe.main(args + ["--device", "cpu"] + wavs)
    assert mine == theirs
    pt = convert_checkpoint.main(["--input", src, "--output",
                                  str(tmp_path / "conv" / "checkpoint"),
                                  *size, "--num_labels", "12"])
    assert os.path.basename(pt) == "checkpoint-step-2.pt"
    state = TrainState(Wav2Vec2AcousticModel(AcousticConfig(**CTC)),
                       create_optimizer(create_lrs(**SCHED), "adamw", WD))
    assert resolve_restart(str(tmp_path / "conv"), state, ctc=True) == 2
    expected = np.load(os.path.join(GOLDEN, "expected.npz"))
    for i, n in enumerate(state.names):  # the .resume file's moments
        assert np.array_equal(state.opt_state.nu[i].numpy(),
                              expected[f"ctc/nu/{n}"]), n
    from audio8_tpu_torch.cli.common import load_weights

    a, b = (Wav2Vec2AcousticModel(AcousticConfig(**dict(CTC))).eval()
            for _ in range(2))
    load_weights(src, a, ctc=True)
    load_weights(pt, b, ctc=True)
    x = torch.from_numpy(rng.normal(size=(1, 4000)).astype(np.float32))
    with torch.no_grad():
        la, lb = a(x)[0], b(x)[0]
    assert torch.equal(la, lb)


def test_rescorer_and_lm_trainer_read_a_jax_lm_basedir(tmp_path):
    from audio8_tpu.ops.rescore import NeuralLMRescorer as JaxRescorer
    from audio8_tpu_torch.cli import train_lm
    from audio8_tpu_torch.ops.rescore import NeuralLMRescorer
    from tests.test_torch_text_lm import CFG, jax_lm

    _, params = jax_lm()
    lm_dir = tmp_path / "lm"
    lm_dir.mkdir()
    (lm_dir / "lm_config.json").write_text(json.dumps(dict(CFG)))
    tx = jax_opt(jax_lrs(1e-3, 10, warmup_steps=1), "adamw")
    jstate = JaxState.create(jax.tree.map(jnp.asarray, params), tx)
    jstate, _ = jstate.apply_gradients(
        jax.tree.map(lambda p: jnp.full_like(p, 0.01), jstate.params), tx)
    jax_save(jstate, str(lm_dir / "checkpoint"), 1)
    hyps = [[5, 6, 7], [8], [], [9, 10, 11, 12, 5]]
    mine = NeuralLMRescorer(str(lm_dir)).lm_logp(hyps)
    theirs = JaxRescorer(str(lm_dir)).lm_logp(hyps)
    np.testing.assert_allclose(mine, theirs, rtol=1e-5, atol=1e-5)

    from audio8_tpu_torch.config import TextLMConfig
    from audio8_tpu_torch.models.text import CausalTextLM

    state = TrainState(CausalTextLM(TextLMConfig(**CFG)), create_optimizer(
        create_lrs(1e-3, 10, warmup_steps=1), "adamw"))
    train_lm.restore(state, str(lm_dir))
    assert state.step == state.opt_state.count == 1
    want_sd, (_, mu, _) = params_from_jax(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.opt_state))
    for i, n in enumerate(state.names):
        assert torch.equal(state.params[i].detach(), want_sd[n]), n
        assert torch.equal(state.opt_state.mu[i], mu[n]), n


def test_distributed_ranks_resume_a_jax_run(tmp_path):
    """``cli.train --distributed true --restart_from`` a JAX run on two
    gloo ranks: every rank restores the Orbax TrainState whole (each reads
    it, then ``sync_from_rank0``), the ranks end bitwise equal, and their
    steps are one process's resume of the same directory (loss rtol
    1e-5, parameters 1e-6, after SGD steps)."""
    from audio8_tpu.models.text import read_vocab_list
    from audio8_tpu_torch.cli import train as train_cli
    from tests.test_torch_dp_ctc import check_params
    from tests.test_torch_train_cli import _train_args, write_letter_corpus
    from tests.torch_dp_ranks import run_cli_ranks, subdir

    corpus = write_letter_corpus(subdir(tmp_path, "corpus"))
    vocab = read_vocab_list(str(corpus / "dict.ltr.txt"))
    model = JaxCtcModel(config=JaxAcousticConfig(
        num_labels=len(vocab), d_model=32, num_heads=2, num_layers=1,
        d_ff=64))
    params = model.init(jax.random.PRNGKey(5), jnp.zeros((1, 4000)))
    tx = jax_opt(jax_lrs(0.01, 3, warmup_steps=2), "sgd")
    jstate = JaxState.create(params["params"], tx)
    jstate, _ = jstate.apply_gradients(
        jax.tree.map(lambda p: jnp.full_like(p, 1e-3), jstate.params), tx)
    jax_run = tmp_path / "jax_run"  # named step 0: its saved step is 1
    jax_save(jstate, str(jax_run / "checkpoint"), 0)

    def args(basedir):
        return _train_args(corpus, str(basedir)) + [
            "--optim", "sgd", "--lr", "0.01", "--restart_from", str(jax_run)]

    two = run_cli_ranks([("audio8_tpu_torch.cli.train",
                          args(tmp_path / "two"))], 2, tmp_path / "ranks")[0]
    one = train_cli.train(args(tmp_path / "one"))
    for k, v in two[0]["params"].items():
        assert torch.equal(v, two[1]["params"][k]), k
    # the full state's step 1, not the name's 0: steps 2 and 3 of 3
    assert len(two[0]["log"]) == len(one.log) == 2
    np.testing.assert_allclose([r["loss"] for r in two[0]["log"]],
                               [r["loss"] for r in one.log], rtol=1e-5)
    check_params(two[0]["params"], {k: v.detach() for k, v in
                                    one.model.state_dict().items()}, 1e-6)
