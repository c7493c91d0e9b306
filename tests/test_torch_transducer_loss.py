"""The port's RNN-T loss (``ops/transducer.py``) against the JAX
package's ``transducer_loss`` on the CPU, on the same seeded inputs:

* both backward routes (autograd through the wavefront, and the fused
  occupancy backward) in all three reductions, weighted per row so each
  row's cotangent differs: loss rtol 1e-5, gradients rtol 1e-4 with
  atol 1e-5; ragged rows, an empty transcript, one frame, no frames;
* degenerate rows (no frames; labels past the lattice's reach at
  ``max_symbols``-sized frames) give finite values and zero gradients,
  and each live frame's blank occupancies sum to 1;
* U = 200: the loss at rtol 1e-5; the gradients within four times the
  relative gap between JAX's own two routes there (their float32 alpha
  and beta sums over 200 labels, about -500 in log space, part the
  occupancies by about 1.9e-4 relative; the port's association of the
  same sums parts them from JAX's by up to 4.3e-4);
* a bf16 input: the lattice runs in float32 and the gradient comes back
  in bf16, as in JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.ops.transducer import transducer_loss as jax_loss
from audio8_tpu_torch.ops.transducer import (transducer_loss,
                                             transducer_loss_from_logits)
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()


def _inputs(seed, b, t, u, v, t_len=None, u_len=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, u + 1, v)).astype(np.float32)
    lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    y = rng.integers(1, v, size=(b, u)).astype(np.int32)
    t_len = np.asarray(t_len if t_len is not None else [t] * b, np.int32)
    u_len = np.asarray(u_len if u_len is not None else [u] * b, np.int32)
    w = rng.uniform(0.25, 2.0, size=b).astype(np.float32)
    return lp, y, t_len, u_len, w


def _jax(lp, y, t_len, u_len, w, fused, reduction="none", blank=0):
    def f(x):
        out = jax_loss(x, jnp.asarray(t_len), jnp.asarray(y),
                       jnp.asarray(u_len), blank=blank, reduction=reduction,
                       fused=fused)
        return jnp.sum(out * w) if reduction == "none" else out

    val, grad = jax.value_and_grad(f)(jnp.asarray(lp))
    per = jax_loss(jnp.asarray(lp), jnp.asarray(t_len), jnp.asarray(y),
                   jnp.asarray(u_len), blank=blank, reduction="none",
                   fused=fused)
    return float(val), np.asarray(grad), np.asarray(per)


def _port(lp, y, t_len, u_len, w, fused, reduction="none", blank=0,
          dtype=torch.float32):
    x = torch.tensor(lp, dtype=dtype, requires_grad=True)
    out = transducer_loss(x, torch.from_numpy(t_len), torch.from_numpy(y),
                          torch.from_numpy(u_len), blank=blank,
                          reduction=reduction, fused=fused)
    val = (out * torch.from_numpy(w)).sum() if reduction == "none" else out
    val.backward()
    with torch.no_grad():
        per = transducer_loss(x, torch.from_numpy(t_len),
                              torch.from_numpy(y), torch.from_numpy(u_len),
                              blank=blank, reduction="none", fused=fused)
    return float(val.detach()), x.grad, per.numpy()


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
def test_loss_and_grads_match_jax(fused, reduction):
    # ragged frames and labels: an empty transcript, one frame, no frames
    args = _inputs(0, 6, 7, 5, 6, t_len=[7, 5, 6, 1, 3, 0],
                   u_len=[5, 3, 0, 1, 5, 2])
    j_val, j_grad, j_per = _jax(*args, fused, reduction)
    val, grad, per = _port(*args, fused, reduction)
    np.testing.assert_allclose(per, j_per, rtol=1e-5, atol=1e-6)
    assert val == pytest.approx(j_val, rel=1e-5)
    np.testing.assert_allclose(grad.numpy(), j_grad, rtol=1e-4, atol=1e-5)
    assert per[5] == 0.0 and np.abs(grad.numpy()[5]).max() == 0.0


def test_blank_other_than_zero_and_from_logits():
    lp, y, t_len, u_len, w = _inputs(1, 2, 4, 3, 5, t_len=[4, 3],
                                     u_len=[3, 2])
    y = np.where(y == 1, 2, y).astype(np.int32)
    for fused in (False, True):
        j_val, j_grad, _ = _jax(lp, y, t_len, u_len, w, fused, "sum",
                                blank=1)
        val, grad, _ = _port(lp, y, t_len, u_len, w, fused, "sum", blank=1)
        assert val == pytest.approx(j_val, rel=1e-5)
        np.testing.assert_allclose(grad.numpy(), j_grad, rtol=1e-4,
                                   atol=1e-5)
    logits = np.random.default_rng(2).normal(size=lp.shape).astype(
        np.float32) * 3
    got = transducer_loss_from_logits(
        torch.from_numpy(logits), torch.from_numpy(t_len),
        torch.from_numpy(y), torch.from_numpy(u_len), reduction="none")
    want = transducer_loss(torch.log_softmax(torch.from_numpy(logits), -1),
                           torch.from_numpy(t_len), torch.from_numpy(y),
                           torch.from_numpy(u_len), reduction="none")
    assert torch.equal(got, want)


@pytest.mark.parametrize("fused", [False, True])
def test_degenerate_rows_are_finite_with_zero_grads(fused):
    """A row with no frames, and a row of one frame whose labels exceed
    what ``max_symbols`` emissions per frame could reach (the loss itself
    has no cap: it still scores them), beside a full row."""
    lp, y, t_len, u_len, w = _inputs(3, 3, 4, 6, 5, t_len=[4, 0, 1],
                                     u_len=[3, 6, 6])
    j_val, j_grad, j_per = _jax(lp, y, t_len, u_len, w, fused, "sum")
    val, grad, per = _port(lp, y, t_len, u_len, w, fused, "sum")
    assert np.isfinite(val) and torch.isfinite(grad).all()
    assert per[1] == 0.0 and grad[1].abs().max() == 0.0
    np.testing.assert_allclose(per, j_per, rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), j_grad, rtol=1e-4, atol=1e-5)


def test_blank_occupancies_sum_to_one_per_live_frame():
    lp, y, t_len, u_len, _ = _inputs(4, 3, 7, 5, 6, t_len=[7, 5, 6],
                                     u_len=[5, 3, 4])
    ones = np.ones(3, np.float32)
    _, grad, _ = _port(lp, y, t_len, u_len, ones, True)
    occ = -grad.numpy()[..., 0].sum(-1)  # blank = 0
    for b in range(3):
        np.testing.assert_allclose(occ[b, :t_len[b]], 1.0, atol=1e-4)
        assert not np.any(occ[b, t_len[b]:])


def test_long_transcripts_hold_the_bound():
    args = _inputs(5, 3, 24, 200, 12, t_len=[24, 20, 11],
                   u_len=[200, 150, 37])
    ref = {f: _jax(*args, f, "none") for f in (False, True)}
    big = np.abs(ref[False][1]) > 1e-3
    gap = float((np.abs(ref[True][1] - ref[False][1])[big]
                 / np.abs(ref[False][1])[big]).max())
    assert 5e-5 < gap < 5e-4  # float32 sums over 200 labels, in JAX too
    for fused in (False, True):
        _, grad, per = _port(*args, fused)
        np.testing.assert_allclose(per, ref[fused][2], rtol=1e-5)
        np.testing.assert_allclose(grad.numpy(), ref[fused][1],
                                   rtol=4 * gap, atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_bf16_input(fused):
    lp, y, t_len, u_len, w = _inputs(6, 3, 6, 4, 8, t_len=[6, 4, 2],
                                     u_len=[4, 2, 3])
    lp16 = np.asarray(jnp.asarray(lp, jnp.bfloat16).astype(jnp.float32))
    j_val, j_grad, j_per = _jax(jnp.asarray(lp, jnp.bfloat16), y, t_len,
                                u_len, w, fused)
    val, grad, per = _port(lp16, y, t_len, u_len, w, fused,
                           dtype=torch.bfloat16)
    assert grad.dtype == torch.bfloat16
    np.testing.assert_allclose(per, j_per, rtol=1e-5)
    np.testing.assert_allclose(grad.float().numpy(),
                               j_grad.astype(np.float32), rtol=2 ** -8,
                               atol=1e-5)
