"""The hash draws of a tensor- or sequence-parallel rank's piece: the
plain versions of kernel 4 with a strided index (a rank's frames from a
T offset, a rank's heads of (B, H, T, T) probabilities) and of kernels 2
and 2b at a rank's first head of the whole head count equal the
matching slice of the whole tensor's draw, bitwise, in both attention
semantics and with a row offset; the whole draw is JAX's
``_hash_keep_mask``. The single-base call draws what it drew before. The
attention block's halves (heads 0..H/2-1 and H/2.., the O bias zero)
sum to the whole block, forward and dx."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.nn.dropout import _hash_keep_mask
from audio8_tpu_torch.ops.attention import (_keep, attention_core_bwd_plain,
                                            attention_core_plain)
from audio8_tpu_torch.ops.attention_block import (attention_block_bwd_plain,
                                                  attention_block_plain)
from audio8_tpu_torch.ops.dropout import hash_dropout, hash_keep_mask
from audio8_tpu_torch.ops.hashrand import (MASK32, hash_bits, mix32,
                                           strided_index)
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

SEED = 3_000_000_007


def test_single_base_draw_unchanged():
    shape, base = (3, 5, 7), 2 ** 32 - 40
    idx = (torch.arange(105, dtype=torch.int64) + base) & MASK32
    want = mix32(idx ^ SEED).reshape(shape)
    assert torch.equal(hash_bits(shape, SEED, base=base), want)
    assert torch.equal(hash_bits(shape, SEED, base=base, row_len=105,
                                 row_stride=9), want)


@pytest.mark.parametrize("t,tp", [(24, 2), (23, 2), (25, 4)])
def test_frames_from_a_t_offset_are_the_whole_draw(t, tp):
    """Sequence parallelism: each rank's real frames of a (B, T, D)
    stream, rows from a row offset, T padded to a multiple of tp."""
    b0, b, b_glob, d = 2, 2, 5, 6
    whole = torch.from_numpy(np.array(_hash_keep_mask(
        (b_glob, t, d), 0.3, jnp.uint32(SEED))))
    x = torch.randn(b_glob, t, d)
    dropped = hash_dropout(x, 0.3, SEED)
    t_local = -(-t // tp)
    for rank in range(tp):
        t0 = rank * t_local
        n = min(max(t - t0, 0), t_local)
        if n == 0:
            continue
        piece = x[b0:b0 + b, t0:t0 + n]
        index = strided_index(piece.shape, (b_glob, t, d), (b0, t0, 0))
        keep = hash_keep_mask(piece.shape, 0.3, SEED, "cpu", *index)
        assert torch.equal(keep, whole[b0:b0 + b, t0:t0 + n])
        assert torch.equal(hash_dropout(piece.contiguous(), 0.3, SEED,
                                        *index),
                           dropped[b0:b0 + b, t0:t0 + n])


def test_heads_of_the_flat_probability_draw():
    """Tensor parallelism: a rank's heads of (B, H, Tq, Tk)
    probabilities, the composed attention's dropout."""
    b0, b, h, tq, tk = 1, 2, 4, 3, 5
    whole = hash_keep_mask((b0 + b, h, tq, tk), 0.2, SEED)
    for h0 in (0, 2):
        index = strided_index((b, 2, tq, tk), (b0 + b, h, tq, tk),
                              (b0, h0, 0, 0))
        assert index[1:] == ((0, 0) if h0 == 0 and h == 2 else
                             (2 * tq * tk, h * tq * tk))
        keep = hash_keep_mask((b, 2, tq, tk), 0.2, SEED, "cpu", *index)
        assert torch.equal(keep, whole[b0:, h0:h0 + 2])


def test_strided_index_refuses_a_piece_that_is_not_rows():
    with pytest.raises(ValueError, match="not rows"):
        strided_index((2, 3, 4), (2, 6, 8), (0, 1, 2))


@pytest.mark.parametrize("xla", [True, False])
@pytest.mark.parametrize("t", [5, 130])
def test_core_heads_are_the_whole_draw(xla, t):
    """Kernels 2 and 2b: heads h0.. of H draw the whole call's masks, so
    the piece's forward and gradients are the whole call's heads."""
    b0, b, h, dh = 3, 2, 4, 16
    grid = t if xla else (t + 127) // 128 * 128
    whole = _keep(b, h, grid, 0.1, SEED, xla, "cpu", b0)
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(b, h, t, dh, generator=g) for _ in range(4))
    kv = torch.arange(t)[None, :] < torch.tensor([t, t - 2])[:, None]
    args = (kv, dh ** -0.5, 0.1, SEED)
    full = attention_core_plain(q, k, v, *args, xla=xla, b0=b0)
    grads = attention_core_bwd_plain(q, k, v, *args, do, xla=xla, b0=b0)
    for h0 in (1, 2):
        keep = _keep(b, h - h0, grid, 0.1, SEED, xla, "cpu", b0, h0, h)
        assert torch.equal(keep, whole[:, h0:])
        mine = [a[:, h0:].contiguous() for a in (q, k, v, do)]
        o = attention_core_plain(*mine[:3], *args, xla=xla, b0=b0, h0=h0,
                                 heads=h)
        assert torch.equal(o, full[:, h0:])
        for got, want in zip(attention_core_bwd_plain(
                *mine[:3], *args, mine[3], xla=xla, b0=b0, h0=h0, heads=h),
                grads):
            assert torch.equal(got, want[:, h0:])


def test_block_halves_sum_to_the_whole_block():
    """Kernels 6 and 6b: each half of the heads with its rows of the
    projections and a zero O bias; the halves' outputs plus the O bias
    and their dx sum to the whole block's (f32, rtol 1e-5)."""
    b, t, d, h, b0 = 2, 20, 32, 4, 1
    g = torch.Generator().manual_seed(1)
    x = torch.randn(b, t, d, generator=g)
    w = [torch.randn(d, d, generator=g) / d ** 0.5 if i % 2 == 0 else
         0.1 * torch.randn(d, generator=g) for i in range(8)]
    dy = torch.randn(b, t, d, generator=g)
    kv = torch.arange(t)[None, :] < torch.tensor([t, 13])[:, None]
    args = (kv, h, (d // h) ** -0.5, 0.1, SEED)
    full = attention_block_plain(x, *w, *args, b0)
    full_g = attention_block_bwd_plain(x, *w, *args, dy, b0=b0)
    out, dx = torch.zeros_like(full), torch.zeros_like(x)
    for r in range(2):
        rows = slice(r * d // 2, (r + 1) * d // 2)
        mine = [w[0][rows], w[1][rows], w[2][rows], w[3][rows], w[4][rows],
                w[5][rows], w[6][:, rows].contiguous(), torch.zeros(d)]
        local = (kv, h // 2, (d // h) ** -0.5, 0.1, SEED)
        out += attention_block_plain(x, *mine, *local, b0, r * h // 2, h)
        got = attention_block_bwd_plain(x, *mine, *local, dy, b0=b0,
                                        h0=r * h // 2, heads=h)
        dx += got[0]
        for i, j in ((1, 0), (2, 1), (7, 6)):  # dwq, dbq, dwo: their rows
            want = full_g[j + 1]
            want = want[:, rows] if j == 6 else want[rows]
            torch.testing.assert_close(got[i], want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out + w[7], full, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dx, full_g[0], rtol=1e-5, atol=1e-6)
