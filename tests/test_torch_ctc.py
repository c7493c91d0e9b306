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
(``train/steps.py:row_validity``).

A plain emulation of the CUDA kernel's decomposition (separate alpha and
beta sweeps in log2 units, dE in a pass of its own, a fixed-order
scatter) is held to both at odd and even T, T = 1 and 2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from audio8_tpu_torch.ops.ctc import ctc_loss, ctc_loss_plain
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

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


# The CUDA kernel's decomposition (csrc/ctc_loss.cu), emulated in plain
# float32: the alpha and the beta_hat sweeps as two separate recursions in
# log2 units (logaddexp3 as m + log2(1 + 2^(x - m) + 2^(y - m)) with the
# max's own term exactly 1), ll from alpha's final states, dE formed in a
# pass of its own, and the scatter onto the labels in a fixed order.
NEG = np.float32(-1e30)
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)


def _lae3_2(a, b, c):
    bc = np.maximum(b, c)
    m = np.maximum(a, bc)
    with np.errstate(over="ignore", invalid="ignore"):
        out = m + np.log2(np.float32(1) + np.exp2(np.minimum(a, bc) - m)
                          + np.exp2(np.minimum(b, c) - m))
    return np.where(m > NEG / 2, out, NEG).astype(np.float32)


def _sweeps(lp, il, tg, tl, blank=0):
    """(loss (B,), dloss/dlp (B, T, V)) the kernel's way, zero_infinity."""
    bsz, t_max, v = lp.shape
    u_max = tg.shape[1]
    s_n = 2 * u_max + 1
    loss = np.zeros(bsz, np.float32)
    grad = np.zeros_like(lp)
    for b in range(bsz):
        ext = np.full(s_n, blank, np.int64)
        ext[1::2] = tg[b]
        live = min(2 * int(tl[b]) + 1, s_n)
        t_end = max(0, min(int(il[b]), t_max))
        e2 = (lp[b][:, ext[:live]] * LOG2E).astype(np.float32)  # (T, live)
        skip = np.zeros(live + 2, bool)  # legal skip into s from s - 2
        for s in range(2, live):
            skip[s] = ext[s] != blank and ext[s] != ext[s - 2]
        pad = np.full(2, NEG, np.float32)
        alpha = np.full((t_max, live), NEG, np.float32)
        prev = np.full(live, NEG, np.float32)
        for t in range(t_end):
            if t == 0:
                cur = np.where(np.arange(live) <= 1, e2[0], NEG)
            else:
                p = np.concatenate([pad, prev])
                cur = _lae3_2(prev, p[1:-1],
                              np.where(skip[:live], p[:-2], NEG)) + e2[t]
            alpha[t] = prev = cur.astype(np.float32)
        u = int(tl[b])
        fin = [s for s in (2 * u, 2 * u - 1) if 0 <= s < live and
               (s == 2 * u or u > 0)]
        f = np.array([prev[s] for s in fin], np.float32)
        m = f.max()
        ll2 = (m + np.log2(np.exp2(f[f > NEG / 2] - m).sum())
               if m > NEG / 2 else NEG)
        beta = np.full((t_max, live), NEG, np.float32)
        prev = np.full(live, NEG, np.float32)
        for t in range(t_end - 1, -1, -1):
            if t == t_end - 1:
                init = np.full(live, NEG, np.float32)
                if t_end == int(il[b]):
                    init[fin] = 0.0
                cur = init + e2[t]
            else:
                p = np.concatenate([prev, pad])
                cur = _lae3_2(prev, p[1:-1],
                              np.where(skip[2:live + 2], p[2:], NEG)) + e2[t]
            beta[t] = prev = cur.astype(np.float32)
        if not ll2 > NEG / 2:
            continue  # infeasible or padding: loss and gradient 0
        loss[b] = -ll2 * LN2
        gamma = alpha[:t_end] + beta[:t_end] - e2[:t_end] - np.float32(ll2)
        de = -np.exp2(np.minimum(gamma, 0)).astype(np.float32)
        for c in range(v):  # blank's even states, then targets in order
            acc = np.zeros(t_end, np.float32)
            if c == blank:
                for s in range(0, live, 2):
                    acc += de[:, s]
            for s in range(1, live, 2):
                if ext[s] == c:
                    acc += de[:, s]
            grad[b, :t_end, c] = acc
    return loss, grad


def _sweep_case(t_max):
    """A full row, an empty target, an infeasible row, a padding row, a
    row of input length far below T and a repeated label (infeasible when
    T < 3)."""
    rng = np.random.default_rng(11 + t_max)
    v = 7
    logits = rng.normal(size=(6, t_max, v)).astype(np.float32)
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    il = np.array([t_max, t_max, min(t_max, 4), 0, max(1, t_max // 6),
                   t_max], np.int32)
    tl = np.array([min(3, t_max), 0, 6, 2, 1, 2], np.int32)
    tg = rng.integers(1, v, size=(6, 6)).astype(np.int32)
    tg[5, :2] = [3, 3]
    return lp, il, tg, tl


@pytest.mark.parametrize("t_max", [1, 2, 23, 24])
def test_kernel_decomposition_matches_jax_and_plain(t_max):
    """The emulated alpha and beta sweeps, dE pass and fixed-order scatter
    against JAX ``ctc_loss(impl="pallas")`` (interpret mode) and the port's
    ``ctc_loss_plain`` (autograd): per-row loss and d(sum_b w_b loss_b)/d
    log_probs, f32, within 1e-5, odd and even T, T = 1 and 2."""
    lp, il, tg, tl = _sweep_case(t_max)
    w = np.linspace(0.5, 1.5, len(il)).astype(np.float32)
    loss, grad = _sweeps(lp, il, tg, tl)
    grad = grad * w[:, None, None]

    def f(x):
        per = jax_ctc_loss(x, jnp.asarray(il), jnp.asarray(tg),
                           jnp.asarray(tl), blank=0, reduction="none",
                           impl="pallas")
        return jnp.sum(per * jnp.asarray(w)), per

    (_, want), want_g = jax.value_and_grad(f, has_aux=True)(jnp.asarray(lp))
    np.testing.assert_allclose(loss, np.asarray(want), **TOL)
    np.testing.assert_allclose(grad, np.asarray(want_g), **TOL)

    x = torch.from_numpy(lp).requires_grad_()
    per = ctc_loss(x, torch.from_numpy(il), torch.from_numpy(tg),
                   torch.from_numpy(tl), blank=0, reduction="none")
    (per * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(loss, per.detach().numpy(), **TOL)
    np.testing.assert_allclose(grad, x.grad.numpy(), **TOL)
    assert loss[2] == 0.0 and loss[3] == 0.0  # infeasible, padding
    assert np.all(grad[[2, 3]] == 0.0)
    assert np.all(grad[4, max(1, t_max // 6):] == 0.0)  # past input_length
