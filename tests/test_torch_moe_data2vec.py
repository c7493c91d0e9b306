"""MoE data2vec in the port against the jitted JAX
``make_data2vec_steps`` (``tests/test_torch_data2vec.py``'s model with
layer 1 an MoE of E 4, ``moe_aux_weight`` 0.5, every dropout at 0.1):
the aux comes from the student alone, in a training step (loss,
gradient norm and ``moe_aux`` within the bounds of
``tests/test_torch_moe_ssl.py``) and in evaluation, whose JAX loss
collects it too (loss and ``moe_aux`` rtol 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.train import steps as jax_steps
from audio8_tpu.train.optim import TrainState as JaxState
from audio8_tpu.train.optim import create_lrs as jax_lrs
from audio8_tpu.train.optim import create_optimizer as jax_opt
from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                          create_optimizer)
from audio8_tpu_torch.train.steps import make_data2vec_steps
from tests import test_torch_data2vec as d2v_tests
from tests.test_torch_dropout_trajectories import LR, JaxSeeds
from tests.test_torch_moe_ssl import MOE, _check
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()


@pytest.mark.parametrize("train", [True, False])
def test_data2vec_step_matches_jax(monkeypatch, train):
    """The student's aux alone, in a training step and in evaluation
    (whose JAX loss collects it too)."""
    cfg = dict(d2v_tests.CFG, **MOE)
    jmodel, params = d2v_tests.jax_init(cfg)
    signal = d2v_tests.d2v_signal(1)
    jtx = jax_opt(jax_lrs(LR, 1, sched_type="constant", warmup_steps=0))
    jstate = JaxState.create(jax.tree.map(jnp.asarray, params), jtx)
    jstep, jeval = jax_steps.make_data2vec_steps(jmodel, jtx, clip=1.0)
    model, teacher = (d2v_tests.port_model(cfg, params) for _ in range(2))
    state = TrainState(model, create_optimizer(
        create_lrs(LR, 1, sched_type="constant", warmup_steps=0)))
    step, evaluate = make_data2vec_steps(model, teacher, clip=1.0)
    seeds = JaxSeeds(monkeypatch)
    jb = {"signal": jnp.asarray(signal), "signal_lengths": None}
    tb = {"signal": torch.from_numpy(signal), "signal_lengths": None}
    key = jax.random.PRNGKey(7)
    if train:
        _, _, jm = jstep(jstate, jax.tree.map(jnp.asarray, params), jb, key)
        replay, (mask,) = seeds.take()
        _, m = step(state, tb, mask, replay)
        assert replay.remaining == 0
        _check(m, jm)
        return
    jloss, jm = jeval(jax.tree.map(jnp.asarray, params),
                      jax.tree.map(jnp.asarray, params), jb, key)
    jax.effects_barrier()
    (mask,) = [s for _, (stream, s) in sorted(seeds._slots.items())
               if stream == "key"][:1]
    loss, m = evaluate(tb, mask)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["moe_aux"]), float(jm["moe_aux"]),
                               rtol=1e-5)
