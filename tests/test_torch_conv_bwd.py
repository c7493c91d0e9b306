"""Backward of the port's k3s2 conv: the plain dgrad and wgrad (which the
CUDA kernels of ``csrc/conv_k3s2_bwd.cu`` are held to on the card) vs the
JAX ``_dgrad_pallas`` / ``_wgrad_pallas`` Pallas kernels (interpret mode
on the CPU backend) and vs ``jax.vjp`` of ``conv1d_k3s2``, in float32 and
bfloat16, for odd and even T_in; the port's ``conv1d_k3s2`` autograd
through them; the kernels' route rules; the wgrad wgmma route's K
slices; and the dgrad wgmma route's decomposition (two products over
shifted dy rows on a padded grid) and tiling."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.ops.pallas.conv_kernel import _dgrad_pallas, _wgrad_pallas
from audio8_tpu.ops.pallas.conv_kernel import conv1d_k3s2 as jax_conv1d_k3s2
from audio8_tpu_torch.ops.conv import (DGRAD_ROUTES, conv1d_k3s2,
                                       conv1d_k3s2_dgrad,
                                       conv1d_k3s2_dgrad_plain,
                                       conv1d_k3s2_wgrad,
                                       conv1d_k3s2_wgrad_plain, dgrad_route,
                                       t_out_of, wgrad_route, wgrad_splits,
                                       wgrad_wgmma_slices)
from audio8_tpu_torch.ops.conv import _vectors
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

# tests/test_torch_conv.py shapes (odd T_in 37, 259, 1027, 19, 41 and even
# 36) plus C_in != C_out both ways and more even T_in
SHAPES = [
    (2, 37, 128, 128),
    (1, 259, 256, 128),
    (3, 1027, 128, 256),
    (2, 36, 128, 128),
    (1, 19, 128, 128),
    (2, 41, 32, 32),
    (2, 40, 32, 48),
    (1, 4, 8, 16),
    (1, 3, 16, 8),
]
# float32: only the order of the f32 sums differs. bfloat16: both sides
# take bf16 operands with f32 sums; dgrad rounds its output to bf16
# (2^-8 relative), wgrad returns f32.
TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}


def _inputs(shape, seed=0):
    b, t, ci, co = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, ci)).astype(np.float32)
    w = (rng.normal(size=(3, ci, co)) / np.sqrt(3 * ci)).astype(np.float32)
    dy = rng.normal(size=(b, t_out_of(t), co)).astype(np.float32)
    return x, w, dy


def _close(got: torch.Tensor, want, tol: float) -> None:
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_kernels_and_vjp(shape, dtype):
    x, w, dy = _inputs(shape)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    xj, wj, dyj = (jnp.asarray(a).astype(jdt) for a in (x, w, dy))
    xt, wt, dyt = (torch.from_numpy(a).to(tdt) for a in (x, w, dy))
    dx = conv1d_k3s2_dgrad(dyt, wt, shape[1])
    dw = conv1d_k3s2_wgrad(xt, dyt)
    assert dx.dtype == tdt and dw.dtype == torch.float32
    _close(dx, _dgrad_pallas(dyj, wj, shape[1]).astype(jnp.float32),
           TOL[dtype])
    _close(dw, _wgrad_pallas(xj, dyj), TOL[dtype])
    _, vjp = jax.vjp(jax_conv1d_k3s2, xj, wj)
    vdx, vdw = vjp(dyj)
    _close(dx, vdx.astype(jnp.float32), TOL[dtype])
    _close(dw.to(tdt), vdw.astype(jnp.float32), TOL[dtype])


@pytest.mark.parametrize("shape", [(2, 37, 16, 24), (2, 36, 24, 16)])
def test_autograd_runs_the_plain_backward(shape):
    """conv1d_k3s2's custom backward on CPU tensors is the plain dgrad
    and wgrad, and agrees with autograd through the plain forward."""
    x, w, dy = _inputs(shape, seed=1)
    xt, wt = (torch.from_numpy(a).double().requires_grad_() for a in (x, w))
    y = conv1d_k3s2(xt, wt)
    gx, gw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(dy).double())
    dyd = torch.from_numpy(dy).double()
    assert torch.equal(gx, conv1d_k3s2_dgrad_plain(dyd, wt.detach(),
                                                   shape[1]))
    assert torch.equal(gw, conv1d_k3s2_wgrad_plain(xt.detach(), dyd)
                       .double())
    xr, wr = (torch.from_numpy(a).double().requires_grad_() for a in (x, w))
    t = shape[1]
    ref = torch.nn.functional.conv1d(xr.transpose(1, 2), wr.permute(2, 1, 0),
                                     stride=2).transpose(1, 2)
    rx, rw = torch.autograd.grad(ref, (xr, wr), dyd)
    assert y.shape == (shape[0], t_out_of(t), shape[3])
    torch.testing.assert_close(gx, rx, atol=1e-10, rtol=0)
    torch.testing.assert_close(gw, rw, atol=1e-5, rtol=0)


def test_wgrad_splits_cover_the_rows():
    """The row reduction's splits: every row in exactly one split, enough
    CTAs for the card at the extractor's shapes, none for a short input."""
    for rows in (1, 255, 4 * 2999, 4 * 23999, 20 * 7141):
        splits, per = wgrad_splits(rows, 512, 512, 132)
        assert per % 64 == 0 and splits * per >= rows > (splits - 1) * per
    assert wgrad_splits(4 * 23999, 512, 512, 132)[0] == 11  # 48 tiles
    assert wgrad_splits(100, 512, 512, 132)[0] == 1


# conv_k3s2_bwd.cu's wgrad route rule: (dtype, C_in, C_out) -> route
WGRAD_ROUTES = [(torch.float32, 512, 512, "simt"), (torch.float32, 40, 72, "simt"),
                (torch.bfloat16, 512, 512, "wgmma"),
                (torch.bfloat16, 128, 64, "wgmma"),
                (torch.bfloat16, 40, 72, "mma.sync"),
                (torch.bfloat16, 512, 72, "mma.sync"),
                (torch.bfloat16, 16, 24, "mma.sync")]


@pytest.mark.parametrize("dtype,c_in,c_out,route", WGRAD_ROUTES)
def test_wgrad_route_follows_the_rule(dtype, c_in, c_out, route):
    """float32 stays on the SIMT tile (full f32 sums); bf16 takes the
    TMA-fed wgmma GEMM when both channel counts are whole 64-wide boxes,
    else the mma.sync tile."""
    assert wgrad_route(dtype, c_in, c_out) == route


def _slice_stages(batch, t_in, splits, per):
    """The (b, t tile) K stages of each slice as the wgmma kernel walks
    them (``attention_block_gemm.cuh:wgmma_gemm_kernel``): slice s takes
    stages [s * per, min(stages, (s + 1) * per)), stage k being (k //
    tiles, k % tiles) with tiles = ceil(T_out / 64)."""
    tiles = -(-t_out_of(t_in) // 64)
    stages = batch * tiles
    return [[divmod(k, tiles) for k in range(s * per,
                                             min(stages, (s + 1) * per))]
            for s in range(splits)]


@pytest.mark.parametrize("batch", [4, 20])
@pytest.mark.parametrize("t_in", [47_999, 14_284, 261, 260])
def test_wgmma_slices_cover_every_stage_once(batch, t_in):
    """The wgmma route's K slices: every (b, 64-row t tile) stage in
    exactly one slice, none empty, for odd and even T_in (the (4, 15 s)
    and pretraining layers' and small ones); the slices times the 24
    output tiles of 512 -> 512 (3 taps x 4 x 2 of 128 x 256) fill the 132
    SMs once at most, and never outnumber the stages."""
    splits, per = wgrad_wgmma_slices(batch, t_in, 512, 512, 132)
    tiles = -(-t_out_of(t_in) // 64)
    slices = _slice_stages(batch, t_in, splits, per)
    flat = [st for sl in slices for st in sl]
    assert sorted(flat) == [(b, i) for b in range(batch)
                            for i in range(tiles)]
    assert len(set(flat)) == len(flat) and all(slices)
    # the kernel cuts ceil(stages / S) stages per slice
    assert per == -(-batch * tiles // splits)
    # as many slices as fill the card (132 // 24 = 5), fewer only where
    # the stages do not divide into that many whole runs
    assert splits <= min(batch * tiles, 132 // 24)
    assert per == -(-batch * tiles // min(batch * tiles, 132 // 24))


def test_wrappers_reject_mismatched_shapes():
    x, w, dy = _inputs((1, 9, 8, 8))
    with pytest.raises(ValueError, match="do not fit"):
        conv1d_k3s2_dgrad(torch.from_numpy(dy), torch.from_numpy(w), 11)
    with pytest.raises(ValueError, match="do not fit"):
        conv1d_k3s2_wgrad(torch.from_numpy(x)[:, :7], torch.from_numpy(dy))


@pytest.mark.parametrize("dtype,vec", [(torch.float32, 4), (torch.bfloat16, 8)])
def test_kernel_inputs_are_whole_aligned_vectors(dtype, vec):
    """Before a launch the backward wrappers refuse channel counts that are
    not whole 16-byte vectors and copy an input that is off a 16-byte
    boundary (the kernels read 16-byte vectors); an aligned input is
    passed through as it is."""
    a = torch.arange(4 * vec + 1, dtype=dtype)
    off = a[1:]
    assert off.data_ptr() % 16 != 0
    got_a, got_off = _vectors("k", vec, 2 * vec, a, off)
    assert got_a is a
    assert got_off.data_ptr() % 16 == 0 and torch.equal(got_off, off)
    with pytest.raises(ValueError, match=f"multiples of {vec}"):
        _vectors("k", vec + vec // 2, vec, a)
    with pytest.raises(ValueError, match=f"multiples of {vec}"):
        _vectors("k", vec, vec - 1, a)


# conv_k3s2_bwd.cu's dgrad route rule, the wgrad rule: (dtype, C_in,
# C_out) -> route, at each branch and at the 64-multiple boundary
DGRAD_RULE = [(torch.float32, 512, 512, "simt"),
              (torch.float32, 64, 64, "simt"),
              (torch.float32, 40, 72, "simt"),
              (torch.bfloat16, 512, 512, "wgmma"),
              (torch.bfloat16, 64, 192, "wgmma"),
              (torch.bfloat16, 192, 64, "wgmma"),
              (torch.bfloat16, 64, 64, "wgmma"),
              (torch.bfloat16, 576, 512, "wgmma"),
              (torch.bfloat16, 520, 512, "mma.sync"),
              (torch.bfloat16, 512, 520, "mma.sync"),
              (torch.bfloat16, 56, 64, "mma.sync"),
              (torch.bfloat16, 40, 72, "mma.sync"),
              (torch.bfloat16, 16, 24, "mma.sync")]


@pytest.mark.parametrize("dtype,c_in,c_out,route", DGRAD_RULE)
def test_dgrad_route_follows_the_rule(dtype, c_in, c_out, route):
    """float32 stays on the SIMT tile (full f32 sums); bf16 takes the
    TMA-fed wgmma GEMM when both channel counts are whole 64-wide boxes,
    else the mma.sync tile; the route names the kernel's code."""
    assert dgrad_route(dtype, c_in, c_out) == route
    assert route in DGRAD_ROUTES
    assert route == wgrad_route(dtype, c_in, c_out)


TILE_ROWS = 128  # M rows per tile of the wgmma GEMM


def _dgrad_t_pad(t_in: int) -> int:
    """T_pad of ``conv_k3s2_bwd.cu:dgrad_wgmma``: the rows t = 0 .. T_out
    (t = T_out gives the tail rows) rounded up to whole M tiles."""
    return -(-(t_out_of(t_in) + 1) // TILE_ROWS) * TILE_ROWS


def _dgrad_wgmma_emulated(dy: torch.Tensor, w: torch.Tensor,
                          t_in: int) -> torch.Tensor:
    """The wgmma route's arithmetic in plain PyTorch, as
    ``conv_k3s2_bwd.cu:dgrad_wgmma`` lays it out: per half z of dx one
    product over the rows (b, t) of the padded grid; K segment seg of half
    z reads dy[t - lag + seg] (``TmaShiftRows``, lag 1 for the even half,
    0 for the odd), zero outside [0, T_out) as TMA fills it, times tap
    (2, 0) or (1,) of ``w`` read as it lies (``TmaWeightRows``: element
    (n, k) = w[tap, n, k]); f32 sums rounded once to dy's dtype; row (b,
    t) of half z goes to dx[b, 2t + z] for t below the half's (T_in - z +
    1) // 2 rows (``HalfRowsOut``'s TMA store map). Rows never written
    stay NaN."""
    b, t_out, c_out = dy.shape
    c_in = w.shape[1]
    t_pad = _dgrad_t_pad(t_in)
    # row 1 + t of dyp is dy[t], rows 0 and past T_out zero
    dyp = torch.zeros((b, t_pad + 1, c_out), dtype=torch.float32)
    dyp[:, 1:t_out + 1] = dy.float()
    dx = torch.full((b, t_in, c_in), float("nan"), dtype=dy.dtype)
    for z, (lag, taps) in enumerate(((1, (2, 0)), (0, (1,)))):
        a = torch.cat([dyp[:, 1 - lag + seg:1 - lag + seg + t_pad]
                       for seg in range(len(taps))], dim=2)
        bk = torch.cat([w[tap].float() for tap in taps], dim=1)  # (N, K)
        out = torch.matmul(a, bk.T).to(dy.dtype)  # (B, T_pad, C_in)
        keep = torch.arange(t_pad) < (t_in - z + 1) // 2
        dx[:, (2 * torch.arange(t_pad) + z)[keep]] = out[:, keep]
    return dx


# (B, T_in, C_in, C_out) on the wgmma route: T_out below 64 (odd and even
# T_in), T_out + 1 = 128 (the tail row the tile's last; T_in 256 even,
# its zero row dx[255]), T_pad 256, C_in != C_out both ways
DGRAD_TILED = [(2, 41, 64, 128), (2, 40, 128, 64), (1, 255, 64, 64),
               (1, 256, 64, 64), (3, 261, 128, 64), (2, 260, 64, 192)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", DGRAD_TILED)
def test_dgrad_wgmma_decomposition_matches_jax(shape, dtype):
    """The emulated wgmma route vs JAX ``_dgrad_pallas`` in interpret mode
    and vs the plain dgrad, on the same inputs. float32: 1e-5 of the
    largest value (only the order of the f32 sums differs); bfloat16:
    TOL's 2^-6 (one bf16 rounding of the output on each side, operands
    equal)."""
    x, w, dy = _inputs(shape, seed=2)
    tdt = getattr(torch, dtype)
    wt, dyt = (torch.from_numpy(a).to(tdt) for a in (w, dy))
    got = _dgrad_wgmma_emulated(dyt, wt, shape[1])
    assert got.dtype == tdt and not torch.isnan(got).any()
    tol = 1e-5 if dtype == "float32" else TOL[dtype]
    wj, dyj = (jnp.asarray(a).astype(jnp.dtype(dtype)) for a in (w, dy))
    _close(got, _dgrad_pallas(dyj, wj, shape[1]).astype(jnp.float32), tol)
    _close(got, conv1d_k3s2_dgrad_plain(dyt, wt, shape[1]).float(), tol)


@pytest.mark.parametrize("batch", [4, 20])
@pytest.mark.parametrize("t_in", [47_999, 23_999, 11_999, 5_999, 14_284,
                                  7_141, 3_570, 1_784, 261, 260, 256, 255,
                                  41])
def test_dgrad_wgmma_tiles_write_every_row_once(batch, t_in):
    """The wgmma route's tiling (``dgrad_wgmma``: M = B * T_pad rows in
    128-row tiles, each warpgroup's 64 rows stored by TMA as 64 x 64 boxes
    at columns nt * 256 + 64 i < C_in = 512; ``HalfRowsOut``: box rows t0
    .. t0 + 63 of batch row b through half z's map of (T_in - z + 1) // 2
    rows, which drops the rows past it) at the (4, 15 s) and pretraining
    layers' T_in and the variants': no tile straddles two batch rows, every
    (b, row, channel) of dx is written exactly once, nothing at or past
    T_in is, and the rows written are t = 0 .. T_out."""
    t_out, t_pad = t_out_of(t_in), _dgrad_t_pad(t_in)
    assert t_pad % TILE_ROWS == 0 and t_pad >= t_out + 1
    c_in, bn = 512, 256
    counts = np.zeros((batch, 2 * t_pad), np.int64)
    columns = np.zeros(c_in, np.int64)
    for mt in range(batch * t_pad // TILE_ROWS):
        for wi in (0, 1):
            m0 = mt * TILE_ROWS + 64 * wi
            b, t0 = divmod(m0, t_pad)
            assert (m0 + 63) // t_pad == b
            t = np.arange(t0, t0 + 64)
            for z in (0, 1):
                kept = t[t < (t_in - z + 1) // 2]
                assert kept.size == 0 or kept.max() <= t_out
                counts[b, 2 * kept + z] += 1
    for nt in range(-(-c_in // bn)):
        for i in range(bn // 64):
            if nt * bn + 64 * i < c_in:
                columns[nt * bn + 64 * i:nt * bn + 64 * i + 64] += 1
    assert (counts[:, :t_in] == 1).all() and (counts[:, t_in:] == 0).all()
    assert (columns == 1).all()
