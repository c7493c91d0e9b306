"""The port's Mixture-of-Experts FFN (``audio8_tpu_torch/nn/moe.py``)
against the JAX ``MoEFFN`` on shared weights, on the CPU.

* ``tests/test_moe.py`` on the port: the per-token numpy reference
  (top-1 and top-2), identical experts equal to the dense FFN, and a
  capacity of 1 dropping every token but one to an exact 0.
* The layer against JAX's for top-1 and top-2 at capacity factors 1e-9,
  1.0 and 2.0, in f32 and bf16, on tokens with forced argmax ties (two
  equal router columns) and a block of padded (zero) frames: the output,
  the aux loss and the gradients of ``sum(y * r) + aux`` with respect to
  x and every parameter. The aux within 1e-6 relative (the f32 router
  under either dtype; the means sum in another order than XLA's). f32:
  the output and gradients within 1e-6 of the largest magnitude (the
  expert products sum in another order than XLA's, and XLA's top-2
  contraction fuses one product at some shapes); bf16: within 2e-2 of
  it (a bf16 product rounds one ulp apart where the two packages' GEMMs
  sum in another order, and the ulp carries through gelu and the second
  product: the largest difference seen was one ulp at the top binade).
* The routing: the capacity formula, ties to the first expert, slots in
  row-major order, a top-2 token whose first choice overflowed taking
  weight 1, a token with nothing kept giving exactly 0 (no ``bo``).
* The aux collection (``AuxLosses``): nesting, and the sum in the
  order of JAX's leaves of the ``losses`` collection.
* ``torch.export`` traces the layer with a symbolic batch (the
  capacity a symbolic expression of B * T), and the program gives the
  live forward's output and aux bitwise at other batch sizes too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.nn.moe import MoEFFN as JaxMoE
from audio8_tpu_torch.nn.moe import (AuxLosses, MoEFFN, capacity, combine,
                                     dispatch, record_aux, route)
from tests.test_moe import _reference_moe
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

D, F, E = 64, 128, 4


def jax_params(seed: int, x: np.ndarray, e: int = E, top_k: int = 1,
               cf: float = 2.0, d: int = D, f: int = F):
    """A JAX init with random biases, as numpy."""
    m = JaxMoE(d_ff=f, d_model=d, num_experts=e, top_k=top_k,
               capacity_factor=cf)
    p = jax.tree.map(np.array, m.init(jax.random.PRNGKey(seed),
                                      jnp.asarray(x))["params"])
    rng = np.random.default_rng(seed + 100)
    p["bi"] = (rng.normal(size=p["bi"].shape) * 0.1).astype(np.float32)
    p["bo"] = (rng.normal(size=p["bo"].shape) * 0.1).astype(np.float32)
    return p


def port_moe(p, top_k: int, cf: float, dtype=torch.float32) -> MoEFFN:
    e, d, f = p["wi"].shape
    m = MoEFFN(d, f, e, top_k, cf, dtype)
    with torch.no_grad():
        m.router.weight.copy_(torch.from_numpy(p["router"]["kernel"].T
                                               .copy()))
        for k in ("wi", "bi", "wo", "bo"):
            getattr(m, k).copy_(torch.from_numpy(p[k]))
    return m


def _inputs(seed: int, b: int = 2, t: int = 24):
    """Tokens with a padded (all-zero) block at the end of the last row,
    and the weights r of the objective ``sum(y * r)``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, D)).astype(np.float32)
    x[-1, t - 6:] = 0.0
    return x, rng.normal(size=(b, t, D)).astype(np.float32)


# ------------------------------------------------------ tests/test_moe.py


@pytest.mark.parametrize("top_k", [1, 2])
def test_matches_per_token_reference(top_k):
    x, _ = _inputs(0, b=1)
    p = jax_params(0, x, top_k=top_k)
    with torch.no_grad():
        y, _ = port_moe(p, top_k, 2.0)(torch.from_numpy(x))
    want = _reference_moe(p, x[0], e=E, top_k=top_k, cap_factor=2.0)
    np.testing.assert_allclose(y[0].numpy(), want, atol=1e-4)


def test_identical_experts_equal_dense_ffn():
    from scipy.stats import norm

    x, _ = _inputs(1, t=8)
    p = jax_params(1, x, e=2, top_k=2, cf=4.0)
    for k in ("wi", "bi", "wo", "bo"):
        p[k] = np.stack([p[k][0]] * 2)
    with torch.no_grad():
        y, _ = port_moe(p, 2, 4.0)(torch.from_numpy(x))
    h = x.reshape(-1, D) @ p["wi"][0] + p["bi"][0]
    want = (h * norm.cdf(h)) @ p["wo"][0] + p["bo"][0]
    np.testing.assert_allclose(y.numpy(), want.reshape(x.shape), atol=1e-4)


def test_capacity_drops_overflow_tokens_to_exact_zero():
    rng = np.random.default_rng(2)
    x = (np.abs(rng.normal(size=(1, 8, D))) + 0.1).astype(np.float32)
    p = jax_params(2, x, cf=1e-9)
    p["router"]["kernel"] = np.zeros_like(p["router"]["kernel"])
    p["router"]["kernel"][0, 0] = 100.0  # every token -> expert 0
    with torch.no_grad():
        y, _ = port_moe(p, 1, 1e-9)(torch.from_numpy(x))
    kept = (y[0] != 0).any(-1).numpy()
    assert kept.tolist() == [True] + [False] * 7  # the first token only
    assert (y[0, 1:] == 0).all()  # no bo on a dropped token


# -------------------------------------------------------------- vs JAX


def _jax_run(p, x, r, top_k, cf, jdt):
    m = JaxMoE(d_ff=F, d_model=D, num_experts=E, top_k=top_k,
               capacity_factor=cf, dtype=jdt)

    def f(params, xx):
        y, mut = m.apply({"params": params}, xx.astype(jdt),
                         mutable=["losses"])
        aux = jax.tree_util.tree_leaves(mut)[0]
        obj = jnp.sum(y.astype(jnp.float32) * r) + aux
        return obj, (y, aux)

    (_, (y, aux)), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jax.tree.map(jnp.asarray, p),
                                          jnp.asarray(x))
    return (np.asarray(y.astype(jnp.float32)), float(aux),
            jax.tree.map(np.asarray, grads))


def _port_run(p, x, r, top_k, cf, dtype):
    m = port_moe(p, top_k, cf, dtype)
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = m(xt.to(dtype))
    (torch.sum(y.float() * torch.from_numpy(r)) + aux).backward()
    grads = {"x": xt.grad.numpy(),
             "router": m.router.weight.grad.numpy().T}
    for k in ("wi", "bi", "wo", "bo"):
        grads[k] = getattr(m, k).grad.numpy()
    return y.detach().float().numpy(), float(aux.detach()), grads


def _close(got, want, rel):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("cf", [1e-9, 1.0, 2.0])
@pytest.mark.parametrize("top_k", [1, 2])
def test_layer_and_grads_match_jax(top_k, cf, dtype):
    x, r = _inputs(3)
    p = jax_params(3, x, top_k=top_k, cf=cf)
    # forced ties: expert 2's router column equals expert 1's, so every
    # token that prefers either ties and goes to expert 1
    p["router"]["kernel"][:, 2] = p["router"]["kernel"][:, 1]
    bf16 = dtype == "bf16"
    jy, jaux, (jgp, jgx) = _jax_run(
        p, x, r, top_k, cf, jnp.bfloat16 if bf16 else jnp.float32)
    y, aux, g = _port_run(p, x, r, top_k, cf,
                          torch.bfloat16 if bf16 else torch.float32)
    # the router runs in f32 under either dtype; the means sum in another
    # order than XLA's
    np.testing.assert_allclose(aux, jaux, rtol=1e-6)
    _close(y, jy, 2e-2 if bf16 else 1e-6)
    gtol = 2e-2 if bf16 else 1e-6
    _close(g["x"], jgx, gtol)
    _close(g["router"], jgp["router"]["kernel"], gtol)
    for k in ("wi", "bi", "wo", "bo"):
        _close(g[k], jgp[k], gtol)


# ------------------------------------------------------------- routing


def test_capacity_formula():
    assert capacity(48, 4, 1, 1.25) == 15
    assert capacity(48, 4, 2, 1.25) == 30
    assert capacity(48, 4, 1, 1e-9) == 1
    assert capacity(10, 2, 2, 4.0) == 10  # at most S
    assert capacity(16 * 255, 8, 1, 1.25) == 638


def test_route_ties_slots_overflow_and_renormalisation():
    # tokens 0-3 tie between experts 0 and 1 and take 0; cap 2
    probs = torch.tensor([[0.4, 0.4, 0.2]] * 4 + [[0.1, 0.2, 0.7]])
    slots, weights = route(probs, 2, cap=2)
    # pass 1: tokens 0, 1 keep expert 0's slots 0, 1; 2, 3 overflow
    # (position cap); token 4 takes expert 2's slot 0
    assert [p.tolist() for _, p in slots] == [[0, 1, 2, 2, 0],
                                              [0, 1, 2, 2, 2]]
    assert slots[0][0].tolist() == [0, 0, 0, 0, 2]
    # pass 2: expert 1 for 0-3 (slots 0, 1 kept, 2, 3 overflow); token
    # 4's second choice is expert 1 too and finds it full
    assert slots[1][0].tolist() == [1, 1, 1, 1, 1]
    w0, w1 = (w.tolist() for w in weights)
    assert w0[:2] == [0.5, 0.5] and w1[:2] == [0.5, 0.5]
    assert w0[2:4] == [0.0, 0.0] and w1[2:4] == [0.0, 0.0]
    assert w0[4] == 1.0 and w1[4] == 0.0  # the kept gate alone: weight 1


def test_second_choice_kept_alone_gets_weight_one():
    probs = torch.tensor([[0.6, 0.1, 0.3], [0.7, 0.2, 0.1]])
    slots, weights = route(probs, 2, cap=1)
    assert slots[0][0].tolist() == [0, 0]
    assert slots[0][1].tolist() == [0, 1]  # token 1 overflows expert 0 ...
    assert slots[1][0].tolist() == [2, 1]  # ... and keeps expert 1
    assert weights[0].tolist()[1] == 0.0 and weights[1].tolist()[1] == 1.0


def test_dispatch_and_combine_are_gathers():
    x = torch.arange(12.0).view(4, 3)
    # E 2, cap 2: token 2 dropped (position 2)
    slots = [(torch.tensor([0, 1, 0, 0]), torch.tensor([0, 0, 2, 1]))]
    xe = dispatch(x, slots, 2, 2)
    assert xe.tolist() == [[[0, 1, 2], [9, 10, 11]], [[3, 4, 5], [0, 0, 0]]]
    y = combine(xe, slots, [torch.tensor([1.0, 0.5, 0.0, 2.0])])
    assert y.tolist() == [[0, 1, 2], [1.5, 2, 2.5], [0, 0, 0],
                          [18, 20, 22]]


def test_aux_losses_nest_and_sum_in_jax_leaf_order():
    vals = {f"layer_{i}": torch.tensor(float(i) + 0.1) for i in (1, 3, 11)}
    with AuxLosses() as outer:
        record_aux("layer_3", vals["layer_3"])
        with AuxLosses() as inner:
            record_aux("layer_11", vals["layer_11"])
        record_aux("layer_1", vals["layer_1"])
    record_aux("layer_5", torch.tensor(9.0))  # no collection: dropped
    assert [k for k, _ in inner.values] == ["layer_11"]
    assert [k for k, _ in outer.values] == ["layer_3", "layer_1"]
    want = torch.zeros(()) + vals["layer_1"] + vals["layer_3"]
    assert outer.total().item() == want.item()
    assert AuxLosses().total().item() == 0.0


def test_layer_exports_with_static_shapes():
    x, _ = _inputs(4)
    p = jax_params(4, x, top_k=2, cf=1.25)
    m = port_moe(p, 2, 1.25).eval()

    class Wrap(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.m = m

        def forward(self, xx):
            return self.m(xx)

    xt = torch.from_numpy(x)
    batch = torch.export.Dim("b", min=1, max=64)
    prog = torch.export.export(Wrap(), (xt,), dynamic_shapes=({0: batch},),
                               strict=False)
    for xx in (xt, xt[:1], torch.cat([xt, xt, xt[:1]])):
        with torch.no_grad():
            want = m(xx)
        got = prog.module()(xx)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
