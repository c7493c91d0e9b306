"""One bfloat16 gradient of the port's ``make_paired_steps`` against the
JAX package's on the CPU, in the setting the trainer runs by default:
max reductions, a padding row, ``--init_temp 1.0``, dropout off (the
models and batch of ``test_torch_paired.py``). In bf16, max pooling's
winners may swap at 1-ulp differences, which moves a leaf's gradient to
other frames, so the gradient is held by norms. Held:

* the embeddings within 2^-5 of max(1, max|ref|), the loss within 5e-3;
* the whole gradient's norm within 2^-5;
* ``logit_scale``'s gradient within 2^-7 exp(logit_scale): each row's
  term of it is a difference of cosines, at most 2 exp(logit_scale);
* each leaf's gradient norm within 4 times the larger of 2^-5 of its
  norm and the distance between JAX's own bf16 and f32 gradients of the
  leaf, which shows how far bf16 noise moves that leaf.

Key biases are left out (their true gradient is 0). Measured over batch
seeds 1-8 (seed 1 is tested): loss 5e-5 to 1.6e-3, gradient norm 0.10%
to 2.8%, ``logit_scale`` gradient 1.3e-4 to 1.8e-3, leaf norms up to 3.2
times their bound's base.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from audio8_tpu.train import steps as jax_steps
from audio8_tpu.train.optim import create_lrs as jax_lrs
from audio8_tpu.train.optim import create_optimizer as jax_opt
from audio8_tpu_torch.models.convert import params_from_jax
from audio8_tpu_torch.train.steps import make_paired_steps

from tests.test_torch_decoder import assert_close
from tests.test_torch_paired import batch, models
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

BF16_LOSS_RTOL = 5e-3  # tests/test_torch_bf16.py's
BF16 = 2.0 ** -5


def _grads(jdt, tdt):
    """One unfrozen gradient of each side on batch 1 (a padding row),
    max reductions, ``init_temp`` 1.0, dropout off: (JAX's loss,
    embeddings and gradients under the port's names; the port's)."""
    jm, jl, params, module = models(0.0, jdt, tdt, init_temp=1.0,
                                    audio="max", text="max")
    b = batch(1)
    flags = dict(freeze_audio=False, freeze_text=False)
    jgrad, _, _ = jax_steps.make_paired_steps(jm, jl, jax_opt(jax_lrs(
        5e-4, 10, sched_type="constant", warmup_steps=0)))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jloss, _, jg, _, _ = jgrad(jax.tree.map(jnp.asarray, params), jb,
                               jax.random.PRNGKey(7), **flags)
    jemb = jax.jit(jm.apply)({"params": params["model"]}, *jb.values())
    jax_side = (float(jloss), jemb, {k: v.float() for k, v in params_from_jax(
        jax.tree.map(lambda x: np.asarray(x, np.float32), jg)).items()})
    if tdt is None:
        return jax_side, None
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    grad_fn, _, _ = make_paired_steps(module)
    loss, _, g, _, _ = grad_fn(tb, torch.Generator(), **flags)
    with torch.no_grad():
        emb = module.model(*tb.values())
    scale = float(module.loss.logit_scale)
    return jax_side, (float(loss), emb, {k: v.float() for k, v in g.items()},
                      scale)


def test_bf16_gradient_with_max_reductions_and_a_padding_row():
    (jloss, jemb, jg), (loss, emb, g, scale) = _grads(jnp.bfloat16,
                                                     torch.bfloat16)
    (_, _, jg32), _ = _grads(jnp.float32, None)
    for got, want in zip(emb, jemb):
        assert_close(got, want, "bf16")
    np.testing.assert_allclose(loss, jloss, rtol=BF16_LOSS_RTOL)
    names = [n for n in jg if not n.endswith(("k_proj.bias", "w_K.bias"))]

    def norm(d):
        return float(torch.sqrt(sum((d[n] ** 2).sum() for n in names)))

    np.testing.assert_allclose(norm(g), norm(jg), rtol=BF16)
    s = "loss.logit_scale"
    assert abs(float(g[s] - jg[s])) <= 2.0 ** -7 * np.exp(scale)
    for n in names:
        want = float(jg[n].norm())
        base = max(BF16 * want, float((jg[n] - jg32[n]).norm()))
        assert abs(float(g[n].norm()) - want) <= 4.0 * base, n
