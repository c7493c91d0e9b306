"""Dropout-on training trajectories: the port's ``make_ctc_steps`` and
``make_pretrain_steps`` against the JAX package's with every dropout at
0.1 (``dropout``, ``attention_dropout``, ``dropout_input``,
``dropout_features``), the recipes' default rate.

The JAX steps run jitted; each of their dropout draws is recorded in
program order by wrapping ``audio8_tpu.nn.dropout._hash_dropout`` and
``audio8_tpu.ops.pallas.attention_kernel.attention_core`` (both looked up
as module attributes at trace time) with a ``jax.debug.callback`` that
writes the concrete seed into the slot the call took while tracing. The
port takes the same seeds in the same order through
``ops.hashrand.SeedReplay`` and must draw exactly as many; the span
mask, Gumbel and negatives seeds (``seed_from_key``) are recorded the
same way and given as ``PretrainSeeds``. Tolerances are
the dropout-off trajectories': loss rtol 1e-3, grad norm rtol 5e-3, step
1 loss rtol 1e-4. The CTC trajectory runs under ``fused_attention=None``
(JAX: XLA attention; port: the core in "xla" semantics) and ``True``
(the Pallas core in interpret mode; port: "kernel" semantics), the
pretraining one under None.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio8_tpu.nn.dropout as jax_dropout
import audio8_tpu.ops.hashrand as jax_hashrand
import audio8_tpu.ops.pallas.attention_kernel as jax_attention_kernel
from audio8_tpu.config import AcousticConfig as JaxAcousticConfig
from audio8_tpu.config import PretrainConfig as JaxPretrainConfig
from audio8_tpu.models.wav2vec2 import Wav2Vec2AcousticModel as JaxCtcModel
from audio8_tpu.models.wav2vec2 import Wav2Vec2Model as JaxPretrainModel
from audio8_tpu.train import steps as jax_steps
from audio8_tpu.train.optim import TrainState as JaxState
from audio8_tpu.train.optim import create_lrs as jax_lrs
from audio8_tpu.train.optim import create_optimizer as jax_opt
from audio8_tpu.utils import Offsets as JaxOffsets
from audio8_tpu_torch.config import AcousticConfig, PretrainConfig
from audio8_tpu_torch.models.convert import params_from_jax
from audio8_tpu_torch.models.wav2vec2 import (PretrainSeeds,
                                              Wav2Vec2AcousticModel,
                                              Wav2Vec2Model)
from audio8_tpu_torch.ops.hashrand import MASK32, SeedReplay
from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                          create_optimizer)
from audio8_tpu_torch.train.steps import make_ctc_steps, make_pretrain_steps
from audio8_tpu_torch.utils import Offsets
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

FX = ((32, 10, 5), (32, 3, 2))
DROPOUT = dict(dropout=0.1, attention_dropout=0.1, dropout_input=0.1,
               dropout_features=0.1)
V, LR = 12, 2e-4
CTC_CFG = dict(num_labels=V, d_model=64, num_heads=4, num_layers=2,
               d_ff=128, custom_conv_features=FX, timestep_masking=0.0,
               channel_masking=0.0, freeze_fx=False, **DROPOUT)
N_NEG = 20
PRETRAIN_CFG = dict(d_model=64, num_heads=4, num_layers=2, d_ff=128,
                    custom_conv_features=FX, num_vq_vars=8, num_vq_groups=2,
                    final_dim=32, n_negatives=N_NEG, **DROPOUT)


class JaxSeeds:
    """The seeds one jitted JAX step draws, per stream, in program order:
    "dropout" (hash dropout and the Pallas core's probability dropout)
    and "key" (``seed_from_key``: span masks, Gumbel noise, negatives). A
    draw takes the next slot while the step is traced, and a callback
    writes its concrete seed there when the step runs. Under
    differentiation JAX traces the forward twice, so a run writes each
    seed into two slots: the first occurrence of a seed is its draw (two
    distinct draws share a seed with probability 2^-32)."""

    def __init__(self, monkeypatch):
        self._slots, self._traced = {}, 0
        drop = jax_dropout._hash_dropout
        core = jax_attention_kernel.attention_core
        from_key = jax_hashrand.seed_from_key

        def dropout(x, rate, seed):
            self._note("dropout", seed)
            return drop(x, rate, seed)

        def attention(q, k, v, key_valid, scale, rate, seed=None):
            if rate > 0.0:
                self._note("dropout", seed)
            return core(q, k, v, key_valid, scale, rate, seed)

        def seed_from_key(key):
            seed = from_key(key)
            self._note("key", seed)
            return seed

        monkeypatch.setattr(jax_dropout, "_hash_dropout", dropout)
        monkeypatch.setattr(jax_attention_kernel, "attention_core", attention)
        monkeypatch.setattr(jax_hashrand, "seed_from_key", seed_from_key)

    def _note(self, stream, seed):
        slot = self._traced
        self._traced += 1
        jax.debug.callback(functools.partial(self._write, stream, slot), seed)

    def _write(self, stream, slot, seed):
        # the Pallas core's seed is a (1,) array
        self._slots[slot] = (stream,
                             int(np.asarray(seed).reshape(-1)[0]) & MASK32)

    def take(self):
        """This run's ``(dropout seeds as a SeedReplay, key seeds)``."""
        jax.effects_barrier()
        out = {"dropout": [], "key": []}
        for _, (stream, seed) in sorted(self._slots.items()):
            if seed not in out[stream]:
                out[stream].append(seed)
        self._slots.clear()
        assert out["dropout"], "the JAX step drew no dropout seed"
        return SeedReplay(out["dropout"]), out["key"]


def _check(loss, gnorm, j_loss, j_gnorm):
    np.testing.assert_allclose(loss, j_loss, rtol=1e-3)
    np.testing.assert_allclose(gnorm, j_gnorm, rtol=5e-3)
    np.testing.assert_allclose(loss[0], j_loss[0], rtol=1e-4)


# ------------------------------------------------------------------- CTC


@pytest.fixture
def _fairseq_offsets():
    saved = (Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK,
             list(Offsets.VALUES))
    Offsets.remap_fairseq_ctc()
    JaxOffsets.remap_fairseq_ctc()
    yield
    Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK = saved[:4]
    Offsets.VALUES[:] = saved[4]


def _ctc_batch(seed):
    rng = np.random.default_rng(seed)
    b, t, u = 3, 2400, 6
    lengths = np.array([t, 1700, 0], np.int32)
    signal = rng.normal(size=(b, t)).astype(np.float32)
    signal[np.arange(t)[None, :] >= lengths[:, None]] = 0.0
    tokens = rng.integers(4, V, size=(b, u)).astype(np.int32)
    tok_len = np.array([u, u - 2, 0], np.int32)
    tokens[np.arange(u)[None, :] >= tok_len[:, None]] = Offsets.PAD
    return {"signal": signal, "signal_lengths": lengths,
            "token_ids": tokens, "token_lengths": tok_len}


@pytest.fixture(scope="module")
def ctc_params():
    """One JAX init for both settings (the parameters do not depend on
    ``fused_attention``)."""
    batch = _ctc_batch(1)
    jmodel = JaxCtcModel(config=JaxAcousticConfig(**CTC_CFG))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(batch["signal"]),
                                  jnp.asarray(batch["signal_lengths"]))
    return jax.tree.map(np.asarray, params["params"])


@pytest.mark.parametrize("fused", [None, True])
def test_ctc_trajectory_with_dropout(_fairseq_offsets, monkeypatch,
                                     ctc_params, fused):
    """Ten unfrozen steps: the dropout masks reach the encoder's weights
    through the gradient (a frozen step would test a subset)."""
    batch, params = _ctc_batch(1), ctc_params
    cfg = dict(CTC_CFG, fused_attention=fused)
    jmodel = JaxCtcModel(config=JaxAcousticConfig(**cfg))
    jtx = jax_opt(jax_lrs(LR, 10, sched_type="constant", warmup_steps=0))
    jstate = JaxState.create(jax.tree.map(jnp.asarray, params), jtx)
    jgrad, jupdate, _ = jax_steps.make_ctc_steps(jmodel, jtx, clip=25.0)
    model = Wav2Vec2AcousticModel(AcousticConfig(**cfg))
    model.load_state_dict(params_from_jax(params), strict=True)
    state = TrainState(model, create_optimizer(
        create_lrs(LR, 10, sched_type="constant", warmup_steps=0)))
    grad_fn, update_fn, _ = make_ctc_steps(model, clip=25.0)
    seeds = JaxSeeds(monkeypatch)
    jb_ = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    j_loss, j_gnorm, loss, gnorm = [], [], [], []
    for step in range(10):
        key = jax.random.fold_in(jax.random.PRNGKey(7), step)
        jl, jg, jb, _ = jgrad(jstate.params, jb_, key, freeze=False)
        replay, _ = seeds.take()
        jstate, jn = jupdate(jstate, jg, jb)
        pl, pg, pb, _ = grad_fn(tb, replay, freeze=False)
        assert replay.remaining == 0  # as many draws, in the same order
        state, pn = update_fn(state, pg, pb)
        j_loss.append(float(jl))
        j_gnorm.append(float(jn))
        loss.append(float(pl))
        gnorm.append(float(pn))
    _check(loss, gnorm, j_loss, j_gnorm)


# ----------------------------------------------------------- pretraining


def test_pretrain_trajectory_with_dropout(monkeypatch):
    n = 5
    signal = np.random.default_rng(2).normal(size=(2, 2400)).astype(
        np.float32)
    jmodel = JaxPretrainModel(config=JaxPretrainConfig(**PRETRAIN_CFG))
    rngs = {k: jax.random.PRNGKey(i)
            for i, k in enumerate(("params", "mask", "gumbel", "dropout"))}
    params = jax.tree.map(np.asarray, jax.jit(
        lambda r, x: jmodel.init(r, x, train=True))(
        rngs, jnp.asarray(signal))["params"])
    keys = list(jax.random.split(jax.random.PRNGKey(23), n))
    jtx = jax_opt(jax_lrs(LR, n, sched_type="constant", warmup_steps=0))
    jstate = JaxState.create(jax.tree.map(jnp.asarray, params), jtx)
    jstep, _ = jax_steps.make_pretrain_steps(jmodel, jtx, clip=1.0,
                                             n_negatives=N_NEG)
    model = Wav2Vec2Model(PretrainConfig(**PRETRAIN_CFG))
    model.load_state_dict(params_from_jax(params), strict=True)
    state = TrainState(model, create_optimizer(
        create_lrs(LR, n, sched_type="constant", warmup_steps=0)))
    step, _ = make_pretrain_steps(model, clip=1.0, n_negatives=N_NEG)
    seeds = JaxSeeds(monkeypatch)
    x = torch.from_numpy(signal)
    j_loss, j_gnorm, loss, gnorm = [], [], [], []
    for k in keys:
        jstate, jm = jstep(jstate, jnp.asarray(signal), k)
        replay, (mask, gumbel, negatives) = seeds.take()
        state, m = step(state, x, PretrainSeeds(mask=mask, gumbel=gumbel,
                                                negatives=negatives), replay)
        assert replay.remaining == 0
        j_loss.append(float(jm["loss"]))
        j_gnorm.append(float(jm["grad_norm"]))
        loss.append(float(m["loss"]))
        gnorm.append(float(m["grad_norm"]))
    _check(loss, gnorm, j_loss, j_gnorm)
