"""The port's AdamW (``train/optim.py`` over ``ops/adamw.py``; on the CPU
the kernel's plain version) against the JAX package's ``FusedAdamW``
(the Pallas kernel in interpret mode) and optax.adamw, through each
package's ``TrainState.apply_gradients``: 2 steps with zero gradients for
a frozen leaf, then 3 with every leaf, a grad scale of 1/3, clipping at
global norm 1 and weight decay 0.01. f32, params and moments within 1e-6
relative (absolute 1e-8 near zero). And ``create_lrs`` for every
``sched_type``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.train.optim import TrainState as JaxState
from audio8_tpu.train.optim import create_lrs as jax_lrs
from audio8_tpu.train.optim import create_optimizer as jax_opt
from audio8_tpu_torch.train.optim import (SGD, TrainState, create_lrs,
                                          create_optimizer)
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

SHAPES = {"enc": (6, 5), "proj": (5, 3), "bias": (3,)}
TOL = dict(rtol=1e-6, atol=1e-8)


def _grads(rng, step):
    g = {k: (rng.normal(size=s) * 4.0).astype(np.float32)
         for k, s in SHAPES.items()}
    if step < 2:  # frozen encoder: JAX passes zeros
        g["enc"] = np.zeros(SHAPES["enc"], np.float32)
    return g


class _Params(torch.nn.Module):
    def __init__(self, init):
        super().__init__()
        for k, v in init.items():
            self.register_parameter(k, torch.nn.Parameter(
                torch.from_numpy(v.copy())))


@pytest.mark.parametrize("jax_optim", ["fused_adamw", "adamw"])
def test_five_steps_match_jax(jax_optim):
    rng = np.random.default_rng(0)
    init = {k: rng.normal(size=s).astype(np.float32)
            for k, s in SHAPES.items()}
    sched = dict(lr=1e-2, train_steps=5, sched_type="cosine",
                 warmup_steps=2)
    jtx = jax_opt(jax_lrs(**sched), jax_optim, 0.01)
    jstate = JaxState.create({k: jnp.asarray(v) for k, v in init.items()},
                             jtx)
    state = TrainState(_Params(init),
                       create_optimizer(create_lrs(**sched), "adamw", 0.01))
    for step in range(5):
        g = _grads(rng, step)
        jstate, jnorm = jstate.apply_gradients(
            {k: jnp.asarray(v) for k, v in g.items()}, jtx,
            grad_scale=1.0 / 3.0, clip_norm=1.0)
        gnorm = state.apply_gradients(
            {k: torch.from_numpy(v) for k, v in g.items()},
            grad_scale=1.0 / 3.0, clip_norm=1.0)
        assert float(jnorm) > 1.0  # the clip is active
        np.testing.assert_allclose(float(gnorm), float(jnorm), rtol=1e-6)
    assert state.step == int(jstate.step) == 5
    opt = jstate.opt_state
    adam = opt if hasattr(opt, "mu") else opt.inner_state[0]
    for i, name in enumerate(state.names):
        np.testing.assert_allclose(state.params[i].detach().numpy(),
                                   np.asarray(jstate.params[name]), **TOL,
                                   err_msg=name)
        np.testing.assert_allclose(state.opt_state.mu[i].numpy(),
                                   np.asarray(adam.mu[name]), **TOL)
        np.testing.assert_allclose(state.opt_state.nu[i].numpy(),
                                   np.asarray(adam.nu[name]), **TOL)


def test_frozen_leaf_still_steps():
    """A zero gradient still decays the weight (wd > 0) and the moments."""
    init = {k: np.ones(s, np.float32) for k, s in SHAPES.items()}
    state = TrainState(_Params(init), create_optimizer(
        create_lrs(1e-2, 5, "constant", warmup_steps=0), "adamw", 0.1))
    state.apply_gradients({k: torch.zeros(s) for k, s in SHAPES.items()})
    p = state.params[state.names.index("enc")].detach().numpy()
    np.testing.assert_allclose(p, 1.0 - 1e-2 * 0.1, rtol=1e-6)


@pytest.mark.parametrize("sched_type", ["cosine", "linear", "invtime",
                                        "inverse-time", "exponential",
                                        "constant"])
@pytest.mark.parametrize("alpha", [0.0, 0.1])
def test_create_lrs_matches_jax(sched_type, alpha):
    kw = dict(lr=3e-4, train_steps=40, sched_type=sched_type, alpha=alpha,
              warmup_steps=10, plateau_steps=5)
    ours, theirs = create_lrs(**kw), jax_lrs(**kw)
    for step in (0, 1, 9, 10, 14, 15, 16, 30, 55, 56, 100):
        np.testing.assert_allclose(ours(step), float(theirs(step)),
                                   rtol=1e-6, err_msg=str(step))


def test_create_optimizer_kinds():
    sched = create_lrs(1e-3, 10)
    assert create_optimizer(sched, "fused_adamw", 0.01).weight_decay == 0.01
    assert create_optimizer(sched, "adam", 0.01).weight_decay == 0.0
    assert isinstance(create_optimizer(sched, "sgd"), SGD)
    with pytest.raises(ValueError):
        create_optimizer(sched, "lamb")
