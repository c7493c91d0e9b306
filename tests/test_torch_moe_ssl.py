"""The MoE aux loss in the port's pretraining factories against the
jitted JAX steps on the CPU: one step of ``make_pretrain_steps`` here,
of ``make_hubert_steps`` in ``test_torch_moe_hubert.py`` and of
``make_data2vec_steps`` in ``test_torch_moe_data2vec.py``, each from one
JAX init (d 64, f 128, 2 layers, layer 1 an MoE of E 4,
``moe_aux_weight`` 0.5, every dropout at 0.1 with the JAX step's seeds
replayed, ``tests/test_torch_dropout_trajectories.py:JaxSeeds``): the
loss (rtol 1e-4), the gradient norm (rtol 5e-3) and ``moe_aux`` (rtol
1e-5) agree, and ``moe_aux`` is at least its floor of 1 (perfect
balance), as JAX's own factory tests assert.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from audio8_tpu.config import PretrainConfig as JaxPretrainConfig
from audio8_tpu.models.wav2vec2 import Wav2Vec2Model as JaxPretrainModel
from audio8_tpu.train import steps as jax_steps
from audio8_tpu.train.optim import TrainState as JaxState
from audio8_tpu.train.optim import create_lrs as jax_lrs
from audio8_tpu.train.optim import create_optimizer as jax_opt
from audio8_tpu_torch.config import PretrainConfig
from audio8_tpu_torch.models.convert import params_from_jax
from audio8_tpu_torch.models.wav2vec2 import PretrainSeeds, Wav2Vec2Model
from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                          create_optimizer)
from audio8_tpu_torch.train.steps import make_pretrain_steps
from tests.test_torch_dropout_trajectories import (LR, N_NEG, PRETRAIN_CFG,
                                                   JaxSeeds)
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

MOE = dict(moe_experts=4, moe_aux_weight=0.5)


def _check(m, jm):
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=5e-3)
    np.testing.assert_allclose(float(m["moe_aux"]), float(jm["moe_aux"]),
                               rtol=1e-5)
    assert float(m["moe_aux"]) >= 1.0 - 1e-5


def test_pretrain_step_matches_jax(monkeypatch):
    cfg = dict(PRETRAIN_CFG, **MOE)
    signal = np.random.default_rng(2).normal(size=(2, 2400)).astype(
        np.float32)
    jmodel = JaxPretrainModel(config=JaxPretrainConfig(**cfg))
    rngs = {k: jax.random.PRNGKey(i)
            for i, k in enumerate(("params", "mask", "gumbel", "dropout"))}
    params = jax.tree.map(np.asarray, jax.jit(
        lambda r, x: jmodel.init(r, x, train=True))(
        rngs, jnp.asarray(signal))["params"])
    jtx = jax_opt(jax_lrs(LR, 1, sched_type="constant", warmup_steps=0))
    jstate = JaxState.create(jax.tree.map(jnp.asarray, params), jtx)
    jstep, _ = jax_steps.make_pretrain_steps(jmodel, jtx, clip=1.0,
                                             n_negatives=N_NEG)
    model = Wav2Vec2Model(PretrainConfig(**cfg))
    model.load_state_dict(params_from_jax(params), strict=True)
    state = TrainState(model, create_optimizer(
        create_lrs(LR, 1, sched_type="constant", warmup_steps=0)))
    step, _ = make_pretrain_steps(model, clip=1.0, n_negatives=N_NEG)
    seeds = JaxSeeds(monkeypatch)
    _, jm = jstep(jstate, jnp.asarray(signal), jax.random.PRNGKey(23))
    replay, (mask, gumbel, negatives) = seeds.take()
    _, m = step(state, torch.from_numpy(signal),
                PretrainSeeds(mask=mask, gumbel=gumbel, negatives=negatives),
                replay)
    assert replay.remaining == 0
    _check(m, jm)
