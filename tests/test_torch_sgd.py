"""``--optim sgd``: the port's ``SGD`` (``train/optim.py``) against the
JAX package's ``optax.inject_hyperparams(optax.sgd)``, on the CPU.

* ``TrainState.apply_gradients`` with a grad scale of 1/3 and clipping
  at global norm 1 (active), a warmup-cosine schedule and zero
  gradients for a frozen leaf: five steps' parameters within 1e-6
  relative, the norms within 1e-6.
* Ten unfrozen CTC steps of the tiny model (``make_ctc_steps``, dropout
  off), SGD on both sides: loss rtol 1e-3, grad norm rtol 5e-3, step 1
  loss rtol 1e-4.
* A JAX SGD optimizer state after three steps (its count; SGD keeps no
  moments) carried across by ``params_from_jax`` sets the port's count
  and LR position; an AdamW state refuses it (no moments).
* A resume file of an SGD run restores its count and step; an AdamW
  state does not take it, nor an SGD state an AdamW file.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.config import AcousticConfig as JaxAcousticConfig
from audio8_tpu.models.wav2vec2 import Wav2Vec2AcousticModel as JaxCtcModel
from audio8_tpu.train import steps as jax_steps
from audio8_tpu.train.optim import TrainState as JaxState
from audio8_tpu.train.optim import create_lrs as jax_lrs
from audio8_tpu.train.optim import create_optimizer as jax_opt
from audio8_tpu_torch.config import AcousticConfig
from audio8_tpu_torch.models.convert import params_from_jax
from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
from audio8_tpu_torch.train.checkpoint import load_resume, save_checkpoint
from audio8_tpu_torch.train.optim import (SGD, SGDState, TrainState,
                                          create_lrs, create_optimizer)
from audio8_tpu_torch.train.steps import make_ctc_steps
from tests.test_torch_dropout_trajectories import CTC_CFG, _check, _ctc_batch
from tests.test_torch_dropout_trajectories import \
    _fairseq_offsets  # noqa: F401 - a fixture
from tests.test_torch_optim import SHAPES, _grads, _Params
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

NO_DROPOUT = dict(CTC_CFG, dropout=0.0, attention_dropout=0.0,
                  dropout_input=0.0, dropout_features=0.0)
SGD_LR = 0.02


def test_apply_gradients_matches_optax_sgd():
    rng = np.random.default_rng(0)
    init = {k: rng.normal(size=s).astype(np.float32)
            for k, s in SHAPES.items()}
    sched = dict(lr=1e-1, train_steps=5, sched_type="cosine",
                 warmup_steps=2)
    jtx = jax_opt(jax_lrs(**sched), "sgd")
    jstate = JaxState.create({k: jnp.asarray(v) for k, v in init.items()},
                             jtx)
    state = TrainState(_Params(init),
                       create_optimizer(create_lrs(**sched), "sgd"))
    assert isinstance(state.tx, SGD) and isinstance(state.opt_state,
                                                    SGDState)
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
    assert state.step == state.opt_state.count == int(jstate.step) == 5
    for i, name in enumerate(state.names):
        np.testing.assert_allclose(state.params[i].detach().numpy(),
                                   np.asarray(jstate.params[name]),
                                   rtol=1e-6, atol=1e-8, err_msg=name)
    frozen = state.params[state.names.index("enc")].detach().numpy()
    assert not np.array_equal(frozen, init["enc"])  # steps 2-4 moved it


def test_ctc_trajectory_matches_optax_sgd(_fairseq_offsets):
    steps, batch = 10, _ctc_batch(1)
    jmodel = JaxCtcModel(config=JaxAcousticConfig(**NO_DROPOUT))
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(batch["signal"]),
        jnp.asarray(batch["signal_lengths"]))["params"])
    jtx = jax_opt(jax_lrs(SGD_LR, steps, sched_type="constant",
                          warmup_steps=0), "sgd")
    jstate = JaxState.create(jax.tree.map(jnp.asarray, params), jtx)
    jgrad, jupdate, _ = jax_steps.make_ctc_steps(jmodel, jtx, clip=25.0)
    model = Wav2Vec2AcousticModel(AcousticConfig(**NO_DROPOUT))
    model.load_state_dict(params_from_jax(params), strict=True)
    state = TrainState(model, create_optimizer(
        create_lrs(SGD_LR, steps, sched_type="constant", warmup_steps=0),
        "sgd"))
    grad_fn, update_fn, _ = make_ctc_steps(model, clip=25.0)
    jb_ = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    curves = ([], [], [], [])
    for step in range(steps):
        key = jax.random.fold_in(jax.random.PRNGKey(7), step)
        jl, jg, jb, _ = jgrad(jstate.params, jb_, key, freeze=False)
        jstate, jn = jupdate(jstate, jg, jb)
        pl, pg, pb, _ = grad_fn(tb, None, freeze=False)
        state, pn = update_fn(state, pg, pb)
        for curve, v in zip(curves, (pl, pn, jl, jn)):
            curve.append(float(v))
    loss, gnorm, j_loss, j_gnorm = curves
    assert loss[-1] < 0.9 * loss[0]  # SGD descends
    _check(loss, gnorm, j_loss, j_gnorm)


def test_params_from_jax_returns_the_sgd_count(_fairseq_offsets):
    batch = _ctc_batch(1)
    jmodel = JaxCtcModel(config=JaxAcousticConfig(**NO_DROPOUT))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(batch["signal"]),
                                  jnp.asarray(batch["signal_lengths"]))
    sched = dict(lr=1e-2, train_steps=8, sched_type="linear",
                 warmup_steps=0)
    jtx = jax_opt(jax_lrs(**sched), "sgd")
    jstate = JaxState.create(params["params"], jtx)
    for _ in range(3):
        jstate, _ = jstate.apply_gradients(
            jax.tree.map(jnp.zeros_like, jstate.params), jtx)
    state_dict, (count, mu, nu) = params_from_jax(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.opt_state))
    assert (count, mu, nu) == (3, None, None)
    model = Wav2Vec2AcousticModel(AcousticConfig(**NO_DROPOUT))
    model.load_state_dict(state_dict, strict=True)
    state = TrainState(model, create_optimizer(create_lrs(**sched), "sgd"))
    state.load_opt_state(count, mu, nu)
    assert state.step == state.opt_state.count == 3
    np.testing.assert_allclose(state.current_lr, float(jax_lrs(**sched)(3)),
                               rtol=1e-6)  # the schedule's position
    adam = TrainState(model, create_optimizer(create_lrs(1e-2, 10)))
    with pytest.raises(ValueError, match="moments"):
        adam.load_opt_state(count, mu, nu)


@pytest.mark.parametrize("saved,loaded", [("sgd", "sgd"), ("sgd", "adamw"),
                                          ("adamw", "sgd")])
def test_resume_file_round_trip(tmp_path, saved, loaded):
    init = {k: np.ones(s, np.float32) for k, s in SHAPES.items()}

    def fresh(optim):
        return TrainState(_Params(init), create_optimizer(
            create_lrs(1e-2, 10, "constant", warmup_steps=0), optim))

    state = fresh(saved)
    for _ in range(3):
        state.apply_gradients({k: torch.ones(s) for k, s in SHAPES.items()})
    path = str(tmp_path / "checkpoint-step-3.pt")
    save_checkpoint(state, path, "paired")
    other = fresh(loaded)
    got = load_resume(other, path, "paired")
    if saved == loaded:
        assert got == other.step == other.opt_state.count == 3
    else:  # another optimizer's state is not taken
        assert got is None and other.step == other.opt_state.count == 0
