"""The port's attention block (``ops/attention_block.py``: the plain
versions and the autograd Function, which the CUDA kernels are held to on
the card) vs the JAX ``attention_block_nheads`` Pallas kernel in
interpret mode, on the same inputs made with numpy:

* forward and all nine gradients (x and the eight weights and biases,
  through ``jax.vjp``) in float32 within the JAX block test's own bounds
  (atol = rtol = 2e-5 forward, 3e-5 gradients), unmasked and masked with
  a zero-length row compared on every row, T = 37 and 130, with and
  without attention dropout (rate 0.25, fixed seed: the hash mask is
  bit-exact, or the outputs would differ by O(1));
* bfloat16 within a stated bf16 bound;
* the zero-length row: uniform over T_pad rows whose padded rows project
  to bv, unlike the core path's;
* the ``fused_attention="block"`` gate (T <= 1024, head dims) against the
  JAX ``structural_ok``, and a layer at T = 1024 vs 1025;
* ``MultiHeadAttention`` with "block" against the JAX module (the
  acoustic model with "block" from ``params_from_jax`` weights is in
  ``test_torch_wav2vec2.py``);
* above the gate (1030 frames) ``True`` and "block" fall back to the XLA
  attention in both packages: equal in f32 with attention dropout on;
* the weight gradients' reduction: S fixed K slices over the B*T_pad rows
  (padded rows, a zero-length row, rate 0.1), summed in slice order, vs
  the JAX block's dW{q,k,v} and dWo within 1e-5;
* the GEMM route each shape takes (``gemm_route``) and the K slices of
  the weight gradients at the pretraining shape.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.nn.transformer import MultiHeadAttention as JaxMHA
from audio8_tpu.ops.pallas.attention_block_kernel import \
    attention_block_nheads
from audio8_tpu.ops.pallas.attention_kernel import structural_ok
from audio8_tpu_torch.nn import transformer
from audio8_tpu_torch.nn.transformer import MultiHeadAttention
from audio8_tpu_torch.ops.attention_block import (HEAD_DIMS,
                                                  attention_block,
                                                  attention_block_bwd_plain,
                                                  attention_block_plain,
                                                  gemm_route,
                                                  weight_grad_slices)
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

FWD_TOL, GRAD_TOL = 2e-5, 3e-5  # tests/test_attention_block.py's bounds
# bfloat16: both sides round q/k/v, o_h, dxo and the gradients to bf16 at
# the same points; their f32 sums run in other orders, so a value may
# land one bf16 ulp (2^-8 relative) away and carry that into the next
# product. Bound: 2^-6 of the largest magnitude of each output.
BF16_TOL = 2.0 ** -6
NAMES = ("x", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")
B, D, H = 3, 32, 2


def _inputs(t, seed=0):
    """x, then (w, b) for q, k, v, o in the JAX layout (w is (in, out)),
    non-zero biases; and an output gradient."""
    rng = np.random.default_rng(seed)
    args = [rng.normal(size=(B, t, D))]
    for _ in range(4):
        args += [rng.normal(size=(D, D)) / np.sqrt(D),
                 rng.normal(size=(D,)) * 0.1]
    dy = rng.normal(size=(B, t, D))
    return [a.astype(np.float32) for a in args], dy.astype(np.float32)


def _key_valid(t, lengths):
    return np.arange(t)[None, :] < np.asarray(lengths)[:, None]


def _jax(args, kv, rate, seed, dy=None, dtype=jnp.float32):
    block = attention_block_nheads(H)
    jseed = None if rate == 0.0 else jnp.asarray([seed], jnp.uint32)
    jkv = None if kv is None else jnp.asarray(kv)

    def f(*a):
        return block(*a, jkv, (D // H) ** -0.5, rate, jseed)

    jargs = [jnp.asarray(a, dtype) for a in args]
    if dy is None:
        return np.asarray(f(*jargs).astype(jnp.float32)), None
    out, vjp = jax.vjp(f, *jargs)
    grads = vjp(jnp.asarray(dy, dtype))
    return (np.asarray(out.astype(jnp.float32)),
            [np.asarray(g.astype(jnp.float32)) for g in grads])


def _port(args, kv, rate, seed, dy=None, dtype=torch.float32):
    """The port on the same inputs (weights moved to the Dense layout);
    gradients come back in the JAX layout."""
    ts = [torch.from_numpy(np.ascontiguousarray(a.T if a.ndim == 2 else a))
          .to(dtype) for a in args]
    kvt = None if kv is None else torch.from_numpy(kv)
    if dy is None:
        with torch.no_grad():
            out = attention_block(*ts, kvt, H, (D // H) ** -0.5, rate, seed)
        return out.float().numpy(), None
    for a in ts:
        a.requires_grad_()
    out = attention_block(*ts, kvt, H, (D // H) ** -0.5, rate, seed)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(dy).to(dtype))
    return out.detach().float().numpy(), [
        g.float().numpy().T if g.dim() == 2 else g.float().numpy()
        for g in grads]


@pytest.mark.parametrize("t", [37, 130])
@pytest.mark.parametrize("masked", [False, True])
def test_forward_matches_jax_kernel(t, masked):
    args, _ = _inputs(t)
    kv = _key_valid(t, [t, t // 3, 0]) if masked else None
    got, _ = _port(args, kv, 0.0, 0)
    want, _ = _jax(args, kv, 0.0, 0)
    np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("t", [37, 130])
@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_grads_match_jax_kernel(t, rate):
    """Forward and all nine gradients; the batch has a full, a ragged and
    a zero-length row, every row compared."""
    args, dy = _inputs(t, seed=1)
    kv = _key_valid(t, [t, t - 11, 0])
    out, got = _port(args, kv, rate, 4_000_000_007, dy)
    want_out, want = _jax(args, kv, rate, 4_000_000_007, dy)
    np.testing.assert_allclose(out, want_out, atol=FWD_TOL, rtol=FWD_TOL)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)


def test_dropout_takes_effect_with_the_core_mask():
    args, _ = _inputs(37, seed=2)
    kv = _key_valid(37, [37, 20, 5])
    got, _ = _port(args, kv, 0.25, 1234)
    want, _ = _jax(args, kv, 0.25, 1234)
    no_drop, _ = _port(args, kv, 0.0, 0)
    np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=FWD_TOL)
    assert np.abs(got - no_drop).max() > 1e-2


def test_bf16_matches_jax_kernel():
    args, dy = _inputs(37, seed=3)
    kv = _key_valid(37, [37, 12, 0])
    out, got = _port(args, kv, 0.25, 99, dy, torch.bfloat16)
    want_out, want = _jax(args, kv, 0.25, 99, dy, jnp.bfloat16)
    for name, g, w in zip(("out",) + NAMES, [out] + got,
                          [want_out] + want):
        tol = BF16_TOL * max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g - w).max()) <= tol, name


def test_zero_length_row_averages_padded_rows():
    """A row with no valid key: every query gets the mean of v over the
    T_pad = 128 rows, whose rows past T are bv (x padded before the
    projection), through Wo; the core path (v padded with zeros after the
    projection) differs there and agrees on the valid rows."""
    t = 37
    args, _ = _inputs(t, seed=4)
    kv = _key_valid(t, [t, 9, 0])
    got, _ = _port(args, kv, 0.0, 0)
    x, wq, bq, wk, bk, wv, bv, wo, bo = args
    v = np.concatenate([x[2] @ wv + bv, np.broadcast_to(bv, (128 - t, D))])
    want = v.mean(0) @ wo + bo
    np.testing.assert_allclose(got[2], np.broadcast_to(want, (t, D)),
                               atol=1e-5, rtol=1e-5)
    core = MultiHeadAttention(H, D)
    with torch.no_grad():
        for m, (w, b) in zip((core.q_proj, core.k_proj, core.v_proj,
                              core.out_proj), zip(args[1::2], args[2::2])):
            m.weight.copy_(torch.from_numpy(w.T))
            m.bias.copy_(torch.from_numpy(b))
        ref = core(torch.from_numpy(x), torch.from_numpy(kv)).numpy()
    np.testing.assert_allclose(got[:2], ref[:2], atol=1e-5, rtol=1e-5)
    assert np.abs(got[2] - ref[2]).max() > 1e-2


@pytest.mark.parametrize("t", [1, 1024, 1025])
def test_gate_follows_jax(t):
    for dh in HEAD_DIMS:
        mha = MultiHeadAttention(2, 2 * dh, fused_attention="block")
        assert mha.block_eligible(t) == structural_ok(t, t, dh, None, None)
    assert not MultiHeadAttention(2, 2 * dh).block_eligible(t)


def _mha_pair(fused, t, seed=5):
    """A port ``MultiHeadAttention`` with ``fused_attention=fused`` and the
    JAX one, on one set of weights; returns (port, jax params, x, kv)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, t, D)).astype(np.float32)
    kv = _key_valid(t, [t, t // 2])
    params = {}
    port = MultiHeadAttention(H, D, fused_attention=fused)
    with torch.no_grad():
        for jname, m in (("w_Q", port.q_proj), ("w_K", port.k_proj),
                         ("w_V", port.v_proj), ("w_O", port.out_proj)):
            w = (rng.normal(size=(D, D)) / np.sqrt(D)).astype(np.float32)
            b = (rng.normal(size=(D,)) * 0.5).astype(np.float32)
            params[jname] = {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}
            m.weight.copy_(torch.from_numpy(w.T))
            m.bias.copy_(torch.from_numpy(b))
    return port, params, x, kv


def test_layer_gate_at_1024_and_1025(monkeypatch):
    """At 1024 frames the layer calls the block, at 1025 it takes the core
    path, as the JAX gate does."""
    calls = []

    def spy(*a, **kw):
        calls.append(a[0].shape[1])
        return attention_block(*a, **kw)

    monkeypatch.setattr(transformer, "attention_block", spy)
    for t, blocked in ((1024, True), (1025, False)):
        port, _, x, kv = _mha_pair("block", t)
        core, _, _, _ = _mha_pair(None, t)
        with torch.no_grad():
            got = port(torch.from_numpy(x), torch.from_numpy(kv))
            want = core(torch.from_numpy(x), torch.from_numpy(kv))
        assert (calls[-1:] == [t]) == blocked
        if not blocked:
            assert torch.equal(got, want)
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    assert calls == [1024]


def test_mha_block_matches_jax_module():
    port, params, x, kv = _mha_pair("block", 41)
    jmha = JaxMHA(num_heads=H, d_model=D, fused_attention="block")
    mask = jnp.asarray(kv)[:, None, None, :]
    xj = jnp.asarray(x)
    want = np.asarray(jmha.apply({"params": params}, xj, xj, xj, mask))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(kv)).numpy()
    np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=FWD_TOL)


def test_gate_deviation_above_1024(monkeypatch):
    """Past 1024 frames the JAX ``fused_attention=True`` and "block"
    layers fall back to XLA attention, and so does the port (its core in
    "xla" semantics): equal in f32 on every row, with attention dropout
    at 0.1 fed the JAX module's recorded seed, and a zero-length row."""
    import audio8_tpu.nn.dropout as jax_dropout
    from audio8_tpu_torch.ops.hashrand import MASK32, SeedReplay

    t = 1030
    seen = []
    real = jax_dropout._hash_dropout

    def recording(x, rate, seed):
        seen.append(int(seed) & MASK32)
        return real(x, rate, seed)

    monkeypatch.setattr(jax_dropout, "_hash_dropout", recording)
    for fused in (True, "block"):
        port, params, x, _ = _mha_pair(fused, t, seed=6)
        kv = _key_valid(t, [t, 0])
        port.dropout_rate = 0.1
        jmha = JaxMHA(num_heads=H, d_model=D, fused_attention=fused,
                      dropout_rate=0.1)
        xj = jnp.asarray(x)
        seen.clear()
        want = np.asarray(jmha.apply(
            {"params": params}, xj, xj, xj,
            jnp.asarray(kv)[:, None, None, :], deterministic=False,
            rngs={"dropout": jax.random.PRNGKey(2)}))
        assert len(seen) == 1  # the XLA path's Dropout, not a kernel
        with torch.no_grad():
            got = port(torch.from_numpy(x), torch.from_numpy(kv),
                       SeedReplay(seen)).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(want).max()))


def test_plain_forward_needs_no_grad_path():
    """Without a gradient the CPU call is the plain forward itself."""
    args, _ = _inputs(37, seed=7)
    ts = [torch.from_numpy(np.ascontiguousarray(a.T if a.ndim == 2 else a))
          for a in args]
    with torch.no_grad():
        a = attention_block(*ts, None, H, 0.25, 0.1, 3)
    b = attention_block_plain(*ts, None, H, 0.25, 0.1, 3)
    assert torch.equal(a, b)


def test_library_hash_covers_included_sources(tmp_path, monkeypatch):
    """The block sources include the core's sources, the block's GEMM
    header and, through it, the TMA-fed GEMM's: an edit to any of them
    gives the block a new library name, so a stale library is never
    loaded."""
    from audio8_tpu_torch.csrc import build

    assert build.local_includes("attention_block_fwd.cu") == [
        "attention_block_fwd.cu", "attention_fwd.cu",
        "attention_block_gemm.cuh", "tma_gemm.cuh", "wgmma.cuh"]
    assert build.local_includes("attention_block_bwd.cu") == [
        "attention_block_bwd.cu", "attention_bwd.cu",
        "attention_block_gemm.cuh", "wgmma.cuh", "tma_gemm.cuh"]
    assert "wgmma.cuh" in build.local_includes("attention_bwd.cu")
    for name in build.local_includes("attention_block_bwd.cu"):
        (tmp_path / name).write_bytes(
            open(f"{build.CSRC}/{name}", "rb").read())
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    for header in ("attention_block_gemm.cuh", "tma_gemm.cuh", "wgmma.cuh"):
        before = build.library_path("attention_block_bwd.cu")
        with open(tmp_path / header, "a") as f:
            f.write("// edited\n")
        assert build.library_path("attention_block_bwd.cu") != before


def test_ptxas_report_reads_registers_and_spills(tmp_path):
    """The build keeps ``ptxas -v``'s log beside each library; the report
    gives each kernel, by its demangled name and integer template
    arguments, its registers and spill bytes."""
    from audio8_tpu_torch.csrc import build

    assert "-v" in build.NVCC_FLAGS
    f32 = ("_ZN12_GLOBAL__N_124attention_bwd_f32_kernelILi64EEEvPKfS2_S2_"
           "S2_PfS3_NS_6ParamsE")
    rowdot = "_ZN12_GLOBAL__N_113rowdot_kernelIfEEvPKT_PKfPfii"
    lib = tmp_path / "attention_bwd-0123.so"
    (tmp_path / "attention_bwd-0123.log").write_text(
        "ptxas info    : 0 bytes gmem\n"
        f"ptxas info    : Compiling entry function '{f32}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {f32}\n"
        "    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers\n"
        f"ptxas info    : Compiling entry function '{rowdot}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {rowdot}\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 16 registers, 380 bytes cmem[0]\n")
    assert build.ptxas_report(str(lib)) == {
        "attention_bwd_f32_kernel<64>": {"registers": 168, "spill_stores": 4,
                                         "spill_loads": 8},
        "rowdot_kernel<f>": {"registers": 16, "spill_stores": 0,
                             "spill_loads": 0}}
    assert build.ptxas_report(str(tmp_path / "missing.so")) == {}


def test_profile_block_needs_a_training_step():
    from audio8_tpu_torch import profile

    with pytest.raises(SystemExit):
        profile.main(["--fused_attention", "block"])


@pytest.mark.parametrize("slices", [(1, 1), (2, 3), (3, 2), (7, 5)])
def test_weight_grad_slices_match_jax(slices):
    """dW{q,k,v} and dWo as one product over the B*T_pad = 384 rows cut
    into S fixed K slices of whole 64-row tiles (7 leaves one empty),
    their f32 partials summed in slice order: equal to the JAX block's
    per-(b, h) sums within 1e-5, with padded rows, a zero-length row and
    attention dropout at 0.1."""
    t, rate, seed = 37, 0.1, 3_000_000_019
    args, dy = _inputs(t, seed=8)
    kv = _key_valid(t, [t, 20, 0])
    _, want = _jax(args, kv, rate, seed, dy)
    ts = [torch.from_numpy(np.ascontiguousarray(a.T if a.ndim == 2 else a))
          for a in args]
    got = attention_block_bwd_plain(*ts, torch.from_numpy(kv), H,
                                    (D // H) ** -0.5, rate, seed,
                                    torch.from_numpy(dy), slices)
    for name, g, w in zip(NAMES, got, want):
        if name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_allclose(g.numpy().T, w, atol=1e-5, rtol=1e-5,
                                       err_msg=name)
    one = attention_block_bwd_plain(*ts, torch.from_numpy(kv), H,
                                    (D // H) ** -0.5, rate, seed,
                                    torch.from_numpy(dy))
    assert all(torch.equal(a, b) for n, a, b in zip(NAMES, got, one)
               if n not in ("wq", "wk", "wv", "wo"))


# chip_smoke.py's BLOCK_VARIANTS (d_model, heads) and wav2vec2-base, with
# the route each dtype takes
ROUTES = [((64, 4), "simt", "mma.sync"), ((64, 2), "simt", "mma.sync"),
          ((256, 2), "simt", "wgmma"), ((768, 12), "simt", "wgmma"),
          ((48, 3), "simt", "simt")]


@pytest.mark.parametrize("shape,f32,bf16", ROUTES)
def test_gemm_route_follows_the_shape(shape, f32, bf16):
    """float32 stays on the SIMT tile (full f32 sums); bf16 takes wgmma at
    head dims 64 and 128 with d_model a multiple of 64, mma.sync where
    H*dh is a multiple of 32, else SIMT (H*dh = 48: dx's 48-deep K
    segments)."""
    d, h = shape
    assert gemm_route(torch.float32, d, h, d // h) == f32
    assert gemm_route(torch.bfloat16, d, h, d // h) == bf16


def test_weight_grad_slices_fill_the_card():
    """At the pretraining shape (20, 222, 768), 12 heads: wgmma's 54
    dW{q,k,v} tiles of 128 x 256 fill 132 SMs with two slices, dWo's 18
    with seven; the SIMT tile's CTAs run in rounds of 264 (two per SM),
    where 7 slices of 108 tiles of 128 x 128 take 3 rounds of 1/7 of the
    work each (2 slices: 1 round of 1/2). The wgmma partials are then 30.7
    MB, where per-batch-row partials took 188.8 MB."""
    assert weight_grad_slices("wgmma", 20, 222, 768, 768) == (2, 7)
    assert weight_grad_slices("simt", 20, 222, 768, 768) == (7, 7)
    s_w, s_wo = weight_grad_slices("wgmma", 20, 222, 768, 768)
    assert (3 * s_w + s_wo) * 768 * 768 * 4 == 30_670_848
    assert (3 * 20 + 20) * 768 * 768 * 4 == 188_743_680
    # never more slices than the k tiles that hold real rows
    assert weight_grad_slices("wgmma", 2, 37, 64, 64) == (2, 2)
    assert weight_grad_slices("mma.sync", 2, 37, 64, 64) == (4, 4)
    assert weight_grad_slices("simt", 1, 5, 48, 48) == (1, 1)
