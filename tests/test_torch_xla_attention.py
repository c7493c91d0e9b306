"""The attention core's "xla" semantics: the port's ``MultiHeadAttention``
with ``fused_attention=None`` (the core kernel's plain versions on the
CPU) against the JAX ``MultiHeadAttention``'s XLA attention on the same
numpy inputs and weights, and the dispatch between the two semantics.

* float32 forward and ``jax.vjp`` gradients (x and the eight weights and
  biases) within 1e-5 x max(1, max|ref|), at T = 37 and 130 (not
  multiples of 128), with a zero-length row, with and without
  attention-probability dropout at 0.1: the JAX module's seed is
  recorded by wrapping ``audio8_tpu.nn.dropout._hash_dropout`` and fed
  to the port through ``SeedReplay``; the hash mask is bit-exact, or the
  outputs would differ by O(1);
* the zero-length row at the core: dq = 0 and dk = 0 on its keys (the
  gradient of ``jnp.where`` zeroes ds at masked columns), dv = pd^T dO;
* bfloat16 with ``bf16_softmax`` True and False against the JAX bf16
  module within ``BF16_BOUND`` (below), and the flag's logit rounding at
  the core against a reference, at a limit that ignoring it fails;
* the plain backward in both semantics against the plain forward's
  autograd;
* the dispatch table of ``nn/transformer.py`` below the gate;
* the backward wrapper's checks (dtype, shape, head dim, residuals) and
  its copy of misaligned inputs, on CPU tensors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio8_tpu.nn.dropout as jax_dropout
from audio8_tpu.nn.transformer import MultiHeadAttention as JaxMHA
from audio8_tpu_torch.nn import transformer
from audio8_tpu_torch.nn.transformer import MultiHeadAttention
from audio8_tpu_torch.ops.attention import (aligned, attention_core,
                                            attention_core_bwd_f32,
                                            attention_core_bwd_plain,
                                            attention_core_plain, validate,
                                            validate_bwd)
from audio8_tpu_torch.ops.hashrand import MASK32, SeedReplay
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

B, D, H = 3, 32, 2
TOL = 1e-5
# bfloat16: both sides round the projections, the logits (bf16_softmax),
# the probabilities and the output to bf16, at points that differ: JAX
# runs the softmax in bf16 and rounds p before dropout's scaling, the
# port's core runs it in f32. Measured on these inputs (seeds 5-7): at
# most 2^-5.4 of max(1, max|ref|) for the output and every gradient but
# dbk; bound 2^-5. dbk = sum_j dk_j = sum_i q_i sum_j ds_ij is zero in
# exact arithmetic, so both sides' values are rounding noise (measured
# up to 2^-2.7 apart): bound 2^-2.
BF16_BOUND = 2.0 ** -5
BF16_DBK_BOUND = 2.0 ** -2
NAMES = ("w_Q", "w_K", "w_V", "w_O")


def record_seeds(monkeypatch):
    """The seeds the JAX package's hash dropout is called with, in call
    order (an eager ``apply``: the seeds are concrete). ``jax.vjp`` runs
    the forward twice, under a linearize tracer and then on concrete
    arrays; the concrete call is the one recorded."""
    seen = []
    real = jax_dropout._hash_dropout

    def recording(x, rate, seed):
        if not isinstance(x, jax.core.Tracer):
            seen.append(int(seed) & MASK32)
        return real(x, rate, seed)

    monkeypatch.setattr(jax_dropout, "_hash_dropout", recording)
    return seen


def mha_pair(t, lengths, fused=None, seed=5, dtype=torch.float32,
             bf16_softmax=True, rate=0.0):
    """A port and a JAX ``MultiHeadAttention`` on one set of weights;
    returns (port, jax module, jax params, x, dy, key_valid)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(len(lengths), t, D)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    kv = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    port = MultiHeadAttention(H, D, dtype=dtype, dropout_rate=rate,
                              fused_attention=fused,
                              bf16_softmax=bf16_softmax)
    params = {}
    with torch.no_grad():
        for name, m in zip(NAMES, (port.q_proj, port.k_proj, port.v_proj,
                                   port.out_proj)):
            w = (rng.normal(size=(D, D)) / np.sqrt(D)).astype(np.float32)
            b = (rng.normal(size=(D,)) * 0.5).astype(np.float32)
            params[name] = {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}
            m.weight.copy_(torch.from_numpy(w.T))
            m.bias.copy_(torch.from_numpy(b))
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jmha = JaxMHA(num_heads=H, d_model=D, dropout_rate=rate,
                  fused_attention=fused, bf16_softmax=bf16_softmax,
                  dtype=jdtype)
    return port, jmha, params, x, dy, kv


def run_jax(jmha, params, x, dy, kv, rate):
    """Forward and ``jax.vjp`` gradients (x, params) of the JAX module."""
    mask = jnp.asarray(kv)[:, None, None, :]

    def f(xj, p):
        return jmha.apply({"params": p}, xj, xj, xj, mask,
                          deterministic=rate == 0.0,
                          rngs={"dropout": jax.random.PRNGKey(3)})

    out, vjp = jax.vjp(f, jnp.asarray(x), params)
    gx, gp = vjp(jnp.asarray(dy, out.dtype))
    return out, gx, gp


def run_port(port, x, dy, kv, seeds):
    """Forward and gradients of the port module, fed ``seeds``."""
    xt = torch.from_numpy(x).requires_grad_()
    gen = SeedReplay(seeds) if seeds else None
    out = port(xt, torch.from_numpy(kv), gen)
    out.backward(torch.from_numpy(dy).to(out.dtype))
    assert gen is None or gen.remaining == 0
    grads = {}
    for name, m in zip(NAMES, (port.q_proj, port.k_proj, port.v_proj,
                               port.out_proj)):
        grads[name] = {"kernel": m.weight.grad.T, "bias": m.bias.grad}
    return out, xt.grad, grads


def assert_close(got, want, rel, what):
    got = np.asarray(torch.as_tensor(got).float().detach().numpy()
                     if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    bound = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: {err} > {bound}"


def compare(port_res, jax_res, rel, dbk_rel=None):
    out, gx, grads = port_res
    jout, jgx, jgp = jax_res
    assert_close(out, jout, rel, "out")
    assert_close(gx, jgx, rel, "dx")
    for name in NAMES:
        for leaf in ("kernel", "bias"):
            r = dbk_rel if (name, leaf) == ("w_K", "bias") and dbk_rel \
                else rel
            assert_close(grads[name][leaf], jgp[name][leaf], r,
                         f"d{name}.{leaf}")


@pytest.mark.parametrize("t", [37, 130])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_mha_matches_jax_xla_attention(monkeypatch, t, rate):
    port, jmha, params, x, dy, kv = mha_pair(t, [t, t // 2, 0], rate=rate)
    seen = record_seeds(monkeypatch)
    jax_res = run_jax(jmha, params, x, dy, kv, rate)
    assert len(seen) == (1 if rate else 0)
    compare(run_port(port, x, dy, kv, seen), jax_res, TOL)


def test_dropout_mask_is_the_jax_one(monkeypatch):
    """With the recorded seed the output agrees; with another seed it is
    O(1) away: the mask itself is the JAX package's."""
    port, jmha, params, x, dy, kv = mha_pair(37, [37, 20, 9], rate=0.1)
    seen = record_seeds(monkeypatch)
    jout = np.asarray(run_jax(jmha, params, x, dy, kv, 0.1)[0])
    with torch.no_grad():
        same = port(torch.from_numpy(x), torch.from_numpy(kv),
                    SeedReplay(seen)).numpy()
        other = port(torch.from_numpy(x), torch.from_numpy(kv),
                     SeedReplay([seen[0] + 1])).numpy()
    assert np.abs(same - jout).max() <= TOL * max(1.0, np.abs(jout).max())
    assert np.abs(other - jout).max() > 0.1


@pytest.mark.parametrize("bf16_softmax", [True, False])
def test_mha_bf16_within_stated_bound(monkeypatch, bf16_softmax):
    port, jmha, params, x, dy, kv = mha_pair(
        45, [45, 30, 0], dtype=torch.bfloat16, bf16_softmax=bf16_softmax,
        rate=0.1)
    seen = record_seeds(monkeypatch)
    jax_res = run_jax(jmha, params, x, dy, kv, 0.1)
    compare(run_port(port, x, dy, kv, seen), jax_res, BF16_BOUND,
            BF16_DBK_BOUND)


def test_bf16_softmax_rounds_the_logits():
    """bf16 inputs under "xla": with ``bf16_softmax`` the plain core's
    output and dv are those of a reference that rounds the scaled logits
    to bf16 before an f32 softmax, within a tenth of the mean distance
    between the flag's two settings (asserted nonzero), so a port that
    ignored the flag fails; the backward's dq and dk read it too."""
    rng = np.random.default_rng(3)
    shape = (3, 2, 45, 16)
    q, k, v, do = (torch.from_numpy(
        (sc * rng.normal(size=shape)).astype(np.float32)).bfloat16()
        for sc in (2.0, 2.0, 1.0, 1.0))
    kv = torch.arange(45)[None, :] < torch.tensor([45, 30, 9])[:, None]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * 0.25
    s = torch.where(kv[:, None, None, :], s.bfloat16().float(),
                    torch.tensor(-1e9))
    pd = torch.softmax(s, dim=-1).bfloat16().float()
    ref = {"out": torch.matmul(pd, v.float()).bfloat16().float(),
           "dv": torch.matmul(pd.transpose(-1, -2), do.float())}
    got = {}
    for flag in (True, False):
        sem = dict(xla=True, bf16_softmax=flag)
        dq, dk, dv = attention_core_bwd_f32(q, k, v, kv, 0.25, 0.0, 0, do,
                                            **sem)
        got[flag] = {"out": attention_core_plain(q, k, v, kv, 0.25,
                                                 **sem).float(),
                     "dq": dq, "dk": dk, "dv": dv}
    for name in ("out", "dq", "dk", "dv"):
        gap = float((got[True][name] - got[False][name]).abs().mean())
        assert gap > 0.0, name
        if name in ref:
            err = float((got[True][name] - ref[name]).abs().mean())
            assert err <= gap / 10, f"{name}: {err} vs gap {gap}"


def _core_inputs(lengths, t=37, dh=16, seed=1):
    rng = np.random.default_rng(seed)
    shape = (len(lengths), 2, t, dh)
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                   for _ in range(4))
    kv = torch.arange(t)[None, :] < torch.tensor(lengths)[:, None]
    return q, k, v, do, kv


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_zero_length_row_gets_no_dq_and_gives_no_dk(rate):
    q, k, v, do, kv = _core_inputs([37, 20, 0])
    dq, dk, dv = attention_core_bwd_plain(q, k, v, kv, 0.25, rate, 9, do,
                                          xla=True)
    assert torch.count_nonzero(dq[2]) == 0 and torch.count_nonzero(dk[2]) == 0
    # dv of the row is pd^T dO with pd its uniform 1/T (dropped) row
    keep = torch.ones(2, 37, 37, dtype=torch.bool)
    if rate:
        from audio8_tpu_torch.ops.hashrand import hash_bits, keep_threshold
        keep = (hash_bits((3, 2, 37, 37), 9) >= keep_threshold(rate))[2]
    pd = torch.where(keep, torch.full((), 1.0 / 37 / (1.0 - rate)),
                     torch.zeros(()))
    want = torch.matmul(pd.transpose(-1, -2), do[2])
    assert_close(dv[2], want.numpy(), TOL, "dv of the zero-length row")
    out = attention_core_plain(q, k, v, kv, 0.25, rate, 9, xla=True)
    assert_close(out[2], torch.matmul(pd, v[2]).numpy(), TOL,
                 "output of the zero-length row")


@pytest.mark.parametrize("xla", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_backward_is_the_forwards_gradient(xla, rate):
    """Under "kernel" a row with no valid key keeps a dq (the TPU kernel's
    ds is not zeroed), so that semantics is held to autograd on rows with
    a valid key; "xla" on a zero-length row too."""
    q, k, v, do, kv = _core_inputs([37, 20, 0] if xla else [37, 20, 5])
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    out = attention_core_plain(*leaves, kv, 0.25, rate, 4, xla=xla)
    want = torch.autograd.grad(out, leaves, do)
    got = attention_core_bwd_plain(q, k, v, kv, 0.25, rate, 4, do, xla=xla)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert_close(g, w.numpy(), TOL, name)


@pytest.mark.parametrize("fused,t,path", [
    (None, 300, "xla"), (True, 300, "kernel"), ("block", 300, "block"),
    (None, 1030, "xla"), (True, 1030, "xla"), ("block", 1030, "xla")])
def test_dispatch_table(monkeypatch, fused, t, path):
    calls = []

    def core(*a, **kw):
        calls.append("xla" if kw["xla"] else "kernel")
        return attention_core(*a, **kw)

    monkeypatch.setattr(transformer, "attention_core", core)
    blk = transformer.attention_block
    monkeypatch.setattr(transformer, "attention_block",
                        lambda *a, **kw: calls.append("block") or blk(*a,
                                                                      **kw))
    mha = MultiHeadAttention(H, D, fused_attention=fused)
    x = torch.randn(1, t, D, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        mha(x, torch.ones(1, t, dtype=torch.bool))
    assert calls == [path]


def test_wrapper_checks_before_a_launch():
    q = torch.zeros(2, 3, 40, 64)
    validate(q, q, q, None, 0.1, "k")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        validate(q.half(), q.half(), q.half(), None, 0.0, "k")
    with pytest.raises(ValueError, match="head dim 48"):
        z = torch.zeros(2, 3, 40, 48)
        validate(z, z, z, None, 0.0, "k")
    with pytest.raises(ValueError, match="want equal"):
        validate(q, q[:, :, :39], q, None, 0.0, "k")
    with pytest.raises(ValueError, match="key_valid"):
        validate(q, q, q, torch.ones(2, 41, dtype=torch.bool), 0.0, "k")
    with pytest.raises(ValueError, match="rate"):
        validate(q, q, q, None, 1.0, "k")
    stats = torch.zeros(2 * 3 * 40, 2)
    validate_bwd(q, q, q, stats)
    with pytest.raises(ValueError, match="dout"):
        validate_bwd(q, q.bfloat16(), q, stats)
    with pytest.raises(ValueError, match="o32"):
        validate_bwd(q, q, q.bfloat16(), stats)
    with pytest.raises(ValueError, match="row statistics"):
        validate_bwd(q, q, q, stats[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_misaligned_inputs_are_copied(dtype):
    a = torch.arange(2 * 16 + 1, dtype=dtype)
    off = a[1:].view(2, 16)
    assert off.data_ptr() % 16 != 0
    full = a[:32].view(2, 16)
    got_full, got_off = aligned(full, off)
    assert got_full is full
    assert got_off.data_ptr() % 16 == 0 and torch.equal(got_off, off)
