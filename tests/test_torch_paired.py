"""The port's paired model (``DualEncoderModel`` + ``SymmetricCLIPLoss``)
and ``make_paired_steps`` against the JAX package's on the CPU, on one
init and seeded numpy inputs.

* the forward: both towers' embeddings (f32 within 1e-5 of max(1,
  max|ref|), bf16 within 2^-5), the loss module on JAX's embeddings
  (rtol 1e-5: it computes in f32 from either dtype), and in f32 the
  loss and its metrics end to end (rtol 1e-5), with the BoW and the rpr
  transformer text tower and a padding row left out as anchor and
  negative. In bf16 the towers agree to 1-2 ulps (measured: audio 0.125
  at 15.25, text 0.016 at 2.27), and the loss at ``init_temp`` 0.07
  (logits scaled by 14.3) of this random 8-wide model moves 2.4% with
  them, so the bf16 loss is held through the module, not end to end;
* (``test_torch_paired_steps.py``) a 10-step float32 trajectory with
  every dropout at 0.1 (JAX's jitted
  seeds recorded and replayed, ``test_torch_dropout_trajectories.
  JaxSeeds``), the audio tower frozen for 3 steps and the text tower for
  2, weight decay 0.01 and ``logit_scale`` trained: loss, grad norm,
  ``clip_accuracy`` and ``logit_scale`` each step (loss rtol 1e-3, step
  1 1e-4, grad norm 5e-3, logit_scale 1e-5), and afterwards every
  parameter against JAX's (rtol 1e-3, atol 1e-5), the frozen tower's
  too: AdamW steps every leaf, weight decay included, as optax does.
  The key biases are left out: their true gradient is 0 (a shift of
  every logit of a query) and their computed one rounding noise;
* (``test_torch_paired_bf16.py``) the bf16 trajectory, dropout off;
* ``params_from_jax`` with the JAX AdamW state: the step count and the
  moments (``logit_scale``'s, a transposed projection's) equal JAX's
  leaves under the port's names;
* a documented deviation: a zero embedding (a padding row under a
  sum or mean reduction, with the projections' zero initial biases)
  gives JAX's loss a NaN gradient (the norm's gradient at 0) and the
  port's a finite one, zero on that row. The trajectories use max
  reductions, whose padding rows are not zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.config import PooledConfig as JaxPooledConfig
from audio8_tpu.config import TextEncoderConfig as JaxTextConfig
from audio8_tpu.models.dual_encoder import DualEncoderModel as JaxDual
from audio8_tpu.models.dual_encoder import SymmetricCLIPLoss as JaxCLIP
from audio8_tpu_torch.config import PooledConfig, TextEncoderConfig
from audio8_tpu_torch.models.convert import params_from_jax
from audio8_tpu_torch.models.dual_encoder import (DualEncoderModel,
                                                  PairedModule,
                                                  SymmetricCLIPLoss)

from tests.test_torch_decoder import assert_close
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

FX = ((32, 10, 5), (32, 3, 2))
V = 14
AUDIO = dict(d_model=32, num_heads=2, num_layers=1, d_ff=64,
             custom_conv_features=FX, timestep_masking=0.0,
             channel_masking=0.0, freeze_fx=False, reduction_type="sha",
             reduction_d_k=8)
TEXT = dict(vocab_size=V, d_model=16, num_heads=2, num_layers=2, d_ff=32,
            rpr_k=3, reduction_type="2ha_mean", reduction_d_k=8)
OUT_DIM, STACK = 8, (12,)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def batch(seed, padding: bool = True):
    """Four rows, the last a padding row (zero signal and lengths) unless
    ``padding`` is False."""
    rng = np.random.default_rng(seed)
    sig = rng.normal(size=(4, 2400)).astype(np.float32)
    sl = np.array([2400, 1900, 1300, 0], np.int32)
    sig[np.arange(2400)[None, :] >= sl[:, None]] = 0.0
    tl = np.array([6, 3, 5, 0], np.int32)
    ids = rng.integers(4, V, size=(4, 6)).astype(np.int32)
    ids[np.arange(6)[None, :] >= tl[:, None]] = 1
    if not padding:
        sig, sl, ids, tl = sig[:3], sl[:3], ids[:3], tl[:3]
    return {"signal": sig, "signal_lengths": sl, "token_ids": ids,
            "token_lengths": tl}


def models(dropout, jdt, tdt, text_type="transformer", init_temp=0.07,
           **reductions):
    """JAX model, loss and params {'model', 'loss'}; the port's
    ``PairedModule`` on those params. ``reductions``: ``audio`` and
    ``text`` reduction types over the defaults."""
    b = batch(0)
    audio = dict(AUDIO, dropout=dropout)
    text = dict(TEXT, dropout=dropout, encoder_type=text_type)
    if "audio" in reductions:
        audio["reduction_type"] = reductions["audio"]
    if "text" in reductions:
        text["reduction_type"] = reductions["text"]
    jm = JaxDual(audio_config=JaxPooledConfig(**audio),
                 text_config=JaxTextConfig(**text), stacking_layers=STACK,
                 output_dim=OUT_DIM, dtype=jdt)
    jl = JaxCLIP(init_temperature=init_temp)
    mp = jax.jit(jm.init)(jax.random.PRNGKey(0), b["signal"],
                          b["signal_lengths"], b["token_ids"],
                          b["token_lengths"])["params"]
    dummy = jnp.zeros((2, OUT_DIM))
    lp = jl.init(jax.random.PRNGKey(1), dummy, dummy)["params"]
    params = jax.tree.map(np.asarray, {"model": dict(mp), "loss": dict(lp)})
    module = PairedModule(
        DualEncoderModel(PooledConfig(**audio), TextEncoderConfig(**text),
                         STACK, OUT_DIM, tdt),
        SymmetricCLIPLoss(init_temp))
    module.load_state_dict(params_from_jax(params), strict=True)
    return jm, jl, params, module


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("text_type", ["transformer", "bow"])
def test_forward_and_loss_match_jax(text_type, dt):
    jdt, tdt = DTYPES[dt]
    jm, jl, params, module = models(0.0, jdt, tdt, text_type)
    b = batch(1)
    rows = (b["signal_lengths"] > 0).astype(np.float32)
    ja, jt = jm.apply({"params": params["model"]}, *b.values())
    jloss, jmet = jl.apply({"params": params["loss"]}, ja, jt, rows)
    with torch.no_grad():
        ta, tt = module.model(*(torch.from_numpy(v) for v in b.values()))
        tloss, tmet = module.loss(ta, tt, torch.from_numpy(rows))
        as_t = [torch.from_numpy(np.asarray(e, np.float32)).to(tdt)
                for e in (ja, jt)]
        mloss, mmet = module.loss(*as_t, torch.from_numpy(rows))
    assert_close(ta, ja, dt)
    assert_close(tt, jt, dt)
    ends = [(mloss, mmet)] + ([(tloss, tmet)] if dt == "f32" else [])
    for loss, met in ends:
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        for k in ("clip_accuracy", "logit_scale"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                       rtol=1e-5)


def test_zero_embedding_gradient():
    """JAX's ``jnp.linalg.norm`` has a NaN gradient at 0, and the row
    mask multiplies it by 0, which keeps the NaN; torch's
    ``vector_norm`` has gradient 0 there. The padding row's embedding is
    exactly zero under a mean reduction at init."""
    rng = np.random.default_rng(4)
    a = rng.normal(size=(3, OUT_DIM)).astype(np.float32)
    t = rng.normal(size=(3, OUT_DIM)).astype(np.float32)
    a[2], t[2] = 0.0, 0.0
    rows = np.array([1.0, 1.0, 0.0], np.float32)
    jl = JaxCLIP(init_temperature=0.07)
    lp = jl.init(jax.random.PRNGKey(1), a, t)["params"]
    jg = jax.grad(lambda x: jl.apply({"params": lp}, x, t, rows)[0])(a)
    assert np.isnan(np.asarray(jg)[2]).all()
    ta = torch.from_numpy(a).requires_grad_()
    loss, _ = SymmetricCLIPLoss(0.07)(ta, torch.from_numpy(t),
                                      torch.from_numpy(rows))
    loss.backward()
    assert torch.isfinite(ta.grad).all() and (ta.grad[2] == 0).all()
    np.testing.assert_allclose(ta.grad[:2].numpy(), np.asarray(jg)[:2],
                               rtol=1e-5, atol=1e-7)


def test_params_from_jax_carries_the_adam_state():
    """After one JAX AdamW step on the paired tree, ``params_from_jax``
    with the optimizer state gives the step count and moments under the
    port's names (``logit_scale``'s included), which a ``TrainState``
    over the ``PairedModule`` takes."""
    from audio8_tpu.train.optim import TrainState as JaxState
    from audio8_tpu.train.optim import create_lrs as jax_lrs
    from audio8_tpu.train.optim import create_optimizer as jax_opt
    from audio8_tpu_torch.models.convert import _adam_state
    from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                              create_optimizer)

    _, _, params, module = models(0.0, jnp.float32, torch.float32)
    tx = jax_opt(jax_lrs(1e-3, 10, sched_type="constant", warmup_steps=0))
    jstate = JaxState.create(jax.tree.map(jnp.asarray, params), tx)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.5, p.dtype),
                         jstate.params)
    jstate, _ = jstate.apply_gradients(grads, tx)
    state_dict, (count, mu, nu) = params_from_jax(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.opt_state))
    module.load_state_dict(state_dict, strict=True)
    state = TrainState(module, create_optimizer(
        create_lrs(1e-3, 10, sched_type="constant", warmup_steps=0)))
    state.load_opt_state(count, mu, nu)
    assert state.step == count == 1
    adam = _adam_state(jstate.opt_state)
    for name, moments, jax_moments in (("mu", state.opt_state.mu, adam.mu),
                                       ("nu", state.opt_state.nu, adam.nu)):
        got = moments[state.names.index("loss.logit_scale")]
        want = float(jax_moments["loss"]["logit_scale"])
        assert float(got) == want and want > 0, name
        w = "model.text_proj.out.weight"
        np.testing.assert_array_equal(
            moments[state.names.index(w)].numpy(),
            np.asarray(jax_moments["model"]["text_proj"]["out"]["kernel"]).T)
    np.testing.assert_allclose(
        float(module.loss.logit_scale.detach()),
        float(jstate.params["loss"]["logit_scale"]), rtol=1e-6)
