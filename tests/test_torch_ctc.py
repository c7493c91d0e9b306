"""The port's ``ctc_loss`` (on the CPU: the plain scan, differentiated by
autograd) against the JAX ``ctc_loss`` with ``impl="scan"`` and with
``impl="pallas"`` (the Pallas kernel in interpret mode), loss and
gradient, f32, within 1e-5 relative or absolute.

The batch holds a normal row, an empty target, an infeasible row (more
labels than frames; zero_infinity) and a padding row (input length 0).
The JAX scan starts every row at frame 0, so a padding row gets a finite
loss there, where the Pallas kernel and the port give NEG_INF (zeroed by
zero_infinity): padding rows are compared with the Pallas kernel only,
and with the scan through the row weights that training applies
(``train/steps.py:row_validity``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from audio8_tpu_torch.ops.ctc import ctc_loss, ctc_loss_plain

TOL = dict(rtol=1e-5, atol=1e-5)
B, T, V, U = 5, 24, 7, 6


def _case():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(B, T, V)).astype(np.float32)
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    il = np.array([T, 17, 4, 0, 20], np.int32)
    tl = np.array([6, 0, 6, 0, 3], np.int32)  # row 2: 6 labels, 4 frames
    tgt = rng.integers(1, V, size=(B, U)).astype(np.int32)
    tgt[4, :3] = [2, 2, 5]  # a repeated label needs a blank between
    return lp, il, tgt, tl


def _jax(lp, il, tgt, tl, impl, reduction="none", zero_infinity=True):
    # zero_infinity is not a static argument of the jitted function: the
    # unjitted one takes it as a Python bool
    fn = jax_ctc_loss if zero_infinity else jax_ctc_loss.__wrapped__
    kw = {} if zero_infinity else {"zero_infinity": False}
    return np.asarray(fn(
        jnp.asarray(lp), jnp.asarray(il), jnp.asarray(tgt), jnp.asarray(tl),
        blank=0, reduction=reduction, impl=impl, **kw))


def _port(lp, il, tgt, tl, reduction="none", zero_infinity=True):
    return ctc_loss(torch.from_numpy(lp), torch.from_numpy(il),
                    torch.from_numpy(tgt), torch.from_numpy(tl), blank=0,
                    reduction=reduction,
                    zero_infinity=zero_infinity).numpy()


@pytest.mark.parametrize("impl", ["scan", "pallas"])
def test_per_row_loss_matches_jax(impl):
    lp, il, tgt, tl = _case()
    got, want = _port(lp, il, tgt, tl), _jax(lp, il, tgt, tl, impl)
    rows = il > 0 if impl == "scan" else np.ones(B, bool)
    np.testing.assert_allclose(got[rows], want[rows], **TOL)
    assert got[2] == 0.0 and got[3] == 0.0  # infeasible, padding
    assert got[1] > 0.0  # empty target: all-blank path


@pytest.mark.parametrize("impl", ["scan", "pallas"])
@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_reductions_match_jax(impl, reduction):
    lp, il, tgt, tl = _case()
    keep = il > 0  # the scan's padding-row loss differs by design
    args = (lp[keep], il[keep], tgt[keep], tl[keep])
    np.testing.assert_allclose(_port(*args, reduction=reduction),
                               _jax(*args, impl, reduction=reduction), **TOL)


def test_infeasible_row_without_zero_infinity():
    lp, il, tgt, tl = _case()
    got = _port(lp, il, tgt, tl, zero_infinity=False)
    want = _jax(lp, il, tgt, tl, "scan", zero_infinity=False)
    assert got[2] > 1e29 and want[2] > 1e29
    np.testing.assert_allclose(got[[0, 1, 4]], want[[0, 1, 4]], **TOL)


@pytest.mark.parametrize("impl", ["scan", "pallas"])
def test_gradient_matches_jax(impl):
    """d(sum_b w_b loss_b)/d(logits) through log_softmax, w = row
    validity, as the training loss weights rows."""
    rng = np.random.default_rng(9)
    lp, il, tgt, tl = _case()
    logits = rng.normal(size=(B, T, V)).astype(np.float32)
    w = (il > 0).astype(np.float32)

    def f(lg):
        lpj = jax.nn.log_softmax(lg, axis=-1)
        per = jax_ctc_loss(lpj, jnp.asarray(il), jnp.asarray(tgt),
                           jnp.asarray(tl), blank=0, reduction="none",
                           impl=impl)
        return jnp.sum(per * jnp.asarray(w))

    want = np.asarray(jax.grad(f)(jnp.asarray(logits)))
    lg = torch.from_numpy(logits).requires_grad_()
    per = ctc_loss(torch.log_softmax(lg, -1), torch.from_numpy(il),
                   torch.from_numpy(tgt), torch.from_numpy(tl), blank=0,
                   reduction="none")
    (per * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(lg.grad.numpy(), want, **TOL)
    assert np.all(lg.grad.numpy()[[2, 3]] == 0.0)


def test_plain_matches_torch_ctc_loss():
    """The plain scan against torch's own CTC on feasible, non-empty rows
    (an independent implementation)."""
    lp, il, tgt, tl = _case()
    rows = [0, 4]
    x = torch.from_numpy(lp[rows])
    got = ctc_loss_plain(x, torch.from_numpy(il[rows]),
                         torch.from_numpy(tgt[rows]), torch.from_numpy(tl[rows]))
    want = torch.nn.functional.ctc_loss(
        x.transpose(0, 1), torch.from_numpy(tgt[rows]).long(),
        torch.from_numpy(il[rows]).long(), torch.from_numpy(tl[rows]).long(),
        blank=0, reduction="none")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)
