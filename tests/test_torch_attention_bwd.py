"""The attention core's gradient: the port's ``attention_core`` (on the
CPU: the plain forward and the plain backward that follows the TPU
kernel's ``_bwd_kernel``) against ``jax.vjp`` of the Pallas
``attention_core`` in interpret mode, f32, within 1e-5 x max(1,
max|ref|). Covers masked and unmasked keys, probability dropout at rate
0.1 (the mask regenerated from the seed) and a zero-length row, whose
uniform 1/T_pad probabilities give non-zero dq and dk there as in the
TPU kernel."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.ops.pallas.attention_kernel import attention_core as jax_core
from audio8_tpu_torch.ops.attention import (attention_core,
                                            attention_core_bwd_plain,
                                            attention_core_plain)
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

SHAPE = (3, 2, 37, 16)  # T_pad = 128


def _inputs(masked: bool):
    rng = np.random.default_rng(1)
    q, k, v, do = (rng.normal(size=SHAPE).astype(np.float32)
                   for _ in range(4))
    kv = None
    if masked:
        t = SHAPE[2]
        kv = np.arange(t)[None, :] < np.array([t, 20, 0])[:, None]
    return q, k, v, do, kv


def _jax_grads(q, k, v, do, kv, rate, seed):
    kvj = None if kv is None else jnp.asarray(kv)

    def f(q_, k_, v_):
        return jax_core(q_, k_, v_, kvj, 0.25, rate,
                        jnp.asarray(seed, jnp.uint32))

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port_grads(q, k, v, do, kv, rate, seed):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    kvt = None if kv is None else torch.from_numpy(kv)
    out = attention_core(qt, kt, vt, kvt, 0.25, rate, seed)
    return [g.numpy() for g in torch.autograd.grad(
        out, (qt, kt, vt), torch.from_numpy(do))]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_grads_match_jax_vjp(masked, rate):
    q, k, v, do, kv = _inputs(masked)
    seed = 3_000_000_000  # seed + b*H + h wraps past 2**32
    want = _jax_grads(q, k, v, do, kv, rate, seed)
    got = _port_grads(q, k, v, do, kv, rate, seed)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        tol = 1e-5 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=name)


def test_zero_length_row_gets_gradients():
    """The TPU kernel does not zero ds at masked columns: an empty row's
    dq and its keys' dk are non-zero, and the port keeps that."""
    q, k, v, do, kv = _inputs(masked=True)
    dq, dk, _ = _port_grads(q, k, v, do, kv, 0.0, 0)
    assert np.abs(dq[2]).max() > 1e-3 and np.abs(dk[2]).max() > 1e-3


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_backward_is_the_forward_vjp(rate):
    """Without masked keys the explicit plain backward equals autograd
    through the plain forward (two routes to the same derivative). With
    them it does not, by design: autograd zeroes ds at masked columns,
    the TPU kernel's VJP does not."""
    q, k, v, do, _ = _inputs(masked=False)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    kvt = None
    out = attention_core_plain(qt, kt, vt, kvt, 0.25, rate, 11)
    want = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    with torch.no_grad():
        got = attention_core_bwd_plain(qt, kt, vt, kvt, 0.25, rate, 11,
                                       torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)
