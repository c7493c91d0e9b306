"""Training trajectories of the port's ``make_paired_steps`` against the
JAX package's on one init, on the CPU (the models and batch of
``test_torch_paired.py``): a 10-step float32 trajectory with every
dropout at 0.1 (the jitted JAX step's seeds recorded and replayed,
``test_torch_dropout_trajectories.JaxSeeds``), the audio tower frozen for
3 steps and the text tower for 2, weight decay 0.01 and ``logit_scale``
trained: loss, grad norm, ``clip_accuracy`` and ``logit_scale`` at each
step (loss rtol 1e-3, step 1 1e-4, grad norm 5e-3, logit_scale 1e-5),
and afterwards every parameter against JAX's (rtol 1e-3, atol 1e-5), the
frozen tower's too: AdamW steps every leaf, weight decay included, as
optax does. The key biases are left out: their true gradient is 0 (a
shift of every logit of a query) and their computed one rounding noise.
Both towers reduce by max, so the padding row's embeddings are not zero
(``test_torch_paired.py::test_zero_embedding_gradient``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from audio8_tpu.train import steps as jax_steps
from audio8_tpu.train.optim import TrainState as JaxState
from audio8_tpu.train.optim import create_lrs as jax_lrs
from audio8_tpu.train.optim import create_optimizer as jax_opt
from audio8_tpu_torch.models.convert import params_from_jax
from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                          create_optimizer)
from audio8_tpu_torch.train.steps import make_paired_steps

from tests.test_torch_dropout_trajectories import JaxSeeds
from tests.test_torch_paired import batch, models
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

LR, CLIP, WD = 5e-4, 25.0, 0.01


def run_trajectory(dropout, jdt, tdt, monkeypatch=None, steps=10,
                   init_temp=0.07, reductions=("sha_max", "2ha_max"),
                   padding=True):
    """Both sides' steps from one init; returns the per-step readings
    and the two final parameter sets."""
    # max reductions: the padding row's embeddings are not zero
    jm, jl, params, module = models(dropout, jdt, tdt, init_temp=init_temp,
                                    audio=reductions[0], text=reductions[1])
    b = batch(1, padding)
    jtx = jax_opt(jax_lrs(LR, steps, sched_type="constant", warmup_steps=0),
                  weight_decay=WD)
    jstate = JaxState.create(jax.tree.map(jnp.asarray, params), jtx)
    jgrad, jupdate, _ = jax_steps.make_paired_steps(jm, jl, jtx, clip=CLIP)
    state = TrainState(module, create_optimizer(
        create_lrs(LR, steps, sched_type="constant", warmup_steps=0),
        weight_decay=WD))
    grad_fn, update_fn, _ = make_paired_steps(module, clip=CLIP)
    seeds = JaxSeeds(monkeypatch) if dropout else None
    jb_ = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    out = {k: [] for k in ("j_loss", "loss", "j_gnorm", "gnorm", "j_acc",
                           "acc", "j_scale", "scale")}
    for step in range(steps):
        flags = dict(freeze_audio=step < 3, freeze_text=step < 2)
        key = jax.random.fold_in(jax.random.PRNGKey(7), step)
        jloss, jmet, jg, jn_rows, _ = jgrad(jstate.params, jb_, key, **flags)
        gen = torch.Generator()
        if seeds is not None:
            gen, _ = seeds.take()
        jstate, jn = jupdate(jstate, jg, jn_rows)
        loss, met, g, n_rows, _ = grad_fn(tb, gen, **flags)
        if seeds is not None:
            assert gen.remaining == 0  # as many draws, in the same order
        state, n = update_fn(state, g, n_rows)
        out["j_loss"].append(float(jloss))
        out["loss"].append(float(loss))
        out["j_gnorm"].append(float(jn))
        out["gnorm"].append(float(n))
        out["j_acc"].append(float(jmet["clip_accuracy"]))
        out["acc"].append(float(met["clip_accuracy"]))
        out["j_scale"].append(float(jmet["logit_scale"]))
        out["scale"].append(float(met["logit_scale"]))
    final = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    return out, final, dict(module.state_dict()), params


def test_f32_trajectory_with_dropout_and_freezes(monkeypatch):
    r, want, got, init = run_trajectory(0.1, jnp.float32, torch.float32,
                                        monkeypatch)
    np.testing.assert_allclose(r["loss"], r["j_loss"], rtol=1e-3)
    np.testing.assert_allclose(r["loss"][0], r["j_loss"][0], rtol=1e-4)
    np.testing.assert_allclose(r["gnorm"], r["j_gnorm"], rtol=5e-3)
    np.testing.assert_allclose(r["scale"], r["j_scale"], rtol=1e-5)
    assert r["acc"] == r["j_acc"]
    assert r["j_scale"][-1] != r["j_scale"][0]  # the temperature trained
    start = params_from_jax(init)
    for name, w in want.items():
        if name.endswith(("k_proj.bias", "w_K.bias")):
            # a key bias shifts a query's logits by one constant: its
            # true gradient is 0, its computed one rounding noise that
            # AdamW normalises to steps of size lr on either side
            continue
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=name)
    # a frozen leaf stepped too (weight decay): the audio tower's layer
    # norm moved during its frozen steps as JAX's did
    name = "model.audio_encoder.encoder.encoder.layers.0.fc1.weight"
    assert not torch.equal(start[name], got[name])


