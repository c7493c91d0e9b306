"""Port's k3s2 conv (plain version, which the CUDA kernel is held to on
the card) vs the JAX ``conv1d_k3s2`` Pallas kernel (interpret mode on the
CPU backend) and vs ``lax.conv``; the forward's route rule
(``fwd_route``) and the wgmma route's padded M-tile grid."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.nn.layers import _conv1d_nwc
from audio8_tpu.ops.pallas.conv_kernel import conv1d_k3s2 as jax_conv1d_k3s2
from audio8_tpu_torch.ops.conv import (FWD_ROUTES, conv1d_k3s2,
                                       conv1d_k3s2_plain, fwd_route, t_out_of)
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

# tests/test_conv_pallas.py shapes plus C_in = 32 (the golden fixture's)
SHAPES = [
    (2, 37, 128, 128),
    (1, 259, 256, 128),
    (3, 1027, 128, 256),
    (2, 36, 128, 128),
    (1, 19, 128, 128),
    (2, 41, 32, 32),
]


def _inputs(shape, seed=0):
    b, t, ci, co = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, ci)).astype(np.float32)
    w = (rng.normal(size=(3, ci, co)) * 0.05).astype(np.float32)
    return x, w


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_kernel_and_lax_conv(shape):
    x, w = _inputs(shape)
    got = conv1d_k3s2(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want_kernel = np.asarray(jax_conv1d_k3s2(jnp.asarray(x), jnp.asarray(w)))
    want_lax = np.asarray(_conv1d_nwc(jnp.asarray(x), jnp.asarray(w), 2,
                                      "VALID"))
    assert got.shape == want_lax.shape
    np.testing.assert_allclose(got, want_kernel, atol=1e-4)
    np.testing.assert_allclose(got, want_lax, atol=1e-4)


def test_plain_matches_torch_conv1d_on_a_view():
    """A non-contiguous input (a time slice) gives the same result as
    F.conv1d in torch's (B, C, T) layout."""
    x, w = _inputs((2, 60, 32, 16), seed=3)
    xt = torch.from_numpy(x)[:, 5:50]
    got = conv1d_k3s2_plain(xt, torch.from_numpy(w))
    ref = torch.nn.functional.conv1d(
        xt.transpose(1, 2), torch.from_numpy(w).permute(2, 1, 0), stride=2)
    torch.testing.assert_close(got, ref.transpose(1, 2), atol=1e-5, rtol=0)


def test_wrapper_rejects_mixed_devices():
    x, w = _inputs((1, 9, 8, 8))
    with pytest.raises(ValueError, match="both must be CPU"):
        conv1d_k3s2(torch.from_numpy(x), torch.from_numpy(w).to("meta"))


# conv_k3s2_fwd.cu's route rule: (dtype, C_in, C_out, aligned) -> route
FWD_ROUTE_CASES = [(torch.bfloat16, 512, 512, True, "wgmma"),
                   (torch.bfloat16, 64, 128, True, "wgmma"),
                   (torch.bfloat16, 512, 72, True, "mma.sync"),
                   (torch.bfloat16, 40, 72, True, "mma.sync"),
                   (torch.bfloat16, 6, 10, True, "generic"),
                   (torch.bfloat16, 512, 512, False, "generic"),
                   (torch.float32, 512, 512, True, "simt"),
                   (torch.float32, 40, 72, True, "simt"),
                   (torch.float32, 6, 10, True, "generic"),
                   (torch.float32, 512, 512, False, "generic")]


@pytest.mark.parametrize("dtype,c_in,c_out,aligned,route", FWD_ROUTE_CASES)
def test_fwd_route_follows_the_rule(dtype, c_in, c_out, aligned, route):
    """bf16 takes the TMA-fed wgmma GEMM when both channel counts are whole
    64-wide boxes, the mma.sync tile for whole 16-byte vectors; f32 the
    SIMT tile (full f32 sums); anything misaligned the generic kernel."""
    assert fwd_route(dtype, c_in, c_out, aligned) == route
    assert route in FWD_ROUTES


TILE_ROWS = 128  # M rows per tile of the wgmma GEMM


@pytest.mark.parametrize("batch", [1, 4, 20])
@pytest.mark.parametrize("t_in", [61, 257, 599])  # T_out 30, 128, 299
def test_fwd_wgmma_tiles_cover_every_output_row_once(batch, t_in):
    """The wgmma route's M tiles walk the padded (b, T_pad) grid as
    ``conv_k3s2_fwd.cu:fwd_wgmma`` sets it up (T_pad = T_out rounded up to
    128, M = B * T_pad; ``TmaTapCols`` loads tile rows mt * 128 + i,
    ``PaddedRowOut`` writes row m = b * T_pad + r where r < T_out): every
    output row (b, t) exactly once, no tile straddling two batch rows."""
    t_out = t_out_of(t_in)
    t_pad = (t_out + TILE_ROWS - 1) // TILE_ROWS * TILE_ROWS
    m_rows = batch * t_pad
    written = []
    for mt in range(-(-m_rows // TILE_ROWS)):
        rows = [mt * TILE_ROWS + i for i in range(TILE_ROWS)]
        assert len({m // t_pad for m in rows}) == 1
        written += [divmod(m, t_pad) for m in rows
                    if m < m_rows and m % t_pad < t_out]
    assert sorted(written) == [(b, t) for b in range(batch)
                               for t in range(t_out)]
    assert len(set(written)) == len(written)
