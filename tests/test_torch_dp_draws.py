"""Row-block hash draws (data parallelism, ``parallel/sharding.py``): a
block of rows that starts at global row ``lo`` draws, bit for bit, the
rows ``lo ..`` of the global batch's draw, for ``hash_bits``, the span
masks, the negatives, the Gumbel noise and the plain versions of kernels
4 (dropout), 2 and 2b (the attention core forward and backward, in both
semantics) and 6/6b (the attention block). The global draws are the JAX
package's where it has the function; a base past the 2**32 flat-index
wrap is held to an independent numpy uint32 emulation."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio8_tpu.ops.hashrand as jax_hashrand
from audio8_tpu.models.wav2vec2 import \
    sample_negative_indices as jax_negatives
from audio8_tpu.nn.dropout import _hash_dropout as jax_hash_dropout
from audio8_tpu.ops.masks import span_mask as jax_span_mask
from audio8_tpu_torch.models.wav2vec2 import sample_negative_indices
from audio8_tpu_torch.ops.attention import (attention_core_bwd_plain,
                                            attention_core_plain)
from audio8_tpu_torch.ops.attention_block import (attention_block_bwd_plain,
                                                  attention_block_plain)
from audio8_tpu_torch.ops.dropout import fused_dropout, hash_dropout
from audio8_tpu_torch.ops.hashrand import (MASK32, hash_bits, hash_gumbel,
                                           hash_uniform, row_base)
from audio8_tpu_torch.ops.masks import span_mask
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

SEED = 0x9E3779B9


def np_mix32(idx: np.ndarray, seed: int) -> np.ndarray:
    """The murmur mix in numpy uint32 (wrapping products)."""
    x = idx.astype(np.uint32) ^ np.uint32(seed)
    x ^= x >> np.uint32(16)
    x = (x * np.uint32(0x7FEB352D)).astype(np.uint32)
    x ^= x >> np.uint32(15)
    x = (x * np.uint32(0x846CA68B)).astype(np.uint32)
    return x ^ (x >> np.uint32(16))


@pytest.mark.parametrize("shape,lo,rows", [((6, 5, 7), 2, 3),
                                           ((4, 33), 3, 1),
                                           ((3, 2, 2, 9), 0, 2)])
def test_hash_bits_rows_are_the_global_call_rows(shape, lo, rows):
    full = hash_bits(shape, SEED)
    local = (rows,) + shape[1:]
    block = hash_bits(local, SEED, base=row_base(local, lo))
    assert torch.equal(block, full[lo:lo + rows])
    jax_full = np.asarray(jax_hashrand.hash_bits(shape, jnp.uint32(SEED)))
    assert np.array_equal(block.numpy(), jax_full[lo:lo + rows])


@pytest.mark.parametrize("base", [2 ** 32 - 5, 3 * 2 ** 32 + 11])
def test_hash_bits_base_past_the_wrap(base):
    n = 37
    want = np_mix32((np.arange(n, dtype=np.uint64) + base) % 2 ** 32, SEED)
    assert np.array_equal(hash_bits((n,), SEED, base=base).numpy(), want)
    # dropout's kernel plain version draws the same wrapped mask
    x = torch.ones(n)
    keep = want >= np.uint32(int(0.3 * 2 ** 32))
    y = hash_dropout(x, 0.3, SEED, base & MASK32)
    assert np.array_equal((y != 0).numpy(), keep)


@pytest.mark.parametrize("lo,rows", [(0, 2), (2, 2), (3, 1)])
def test_span_mask_rows(lo, rows):
    key = jax.random.PRNGKey(3)
    seed = int(jax_hashrand.seed_from_key(key)) & MASK32
    full = np.asarray(jax_span_mask(key, 4, 57, 0.4, 5))
    block = span_mask(seed, rows, 57, 0.4, 5, row_offset=lo)
    assert np.array_equal(block.numpy(), full[lo:lo + rows])


def test_negatives_rows():
    key = jax.random.PRNGKey(5)
    seed = int(jax_hashrand.seed_from_key(key)) & MASK32
    vc = np.array([9, 2, 0, 6], np.int32)
    full = np.asarray(jax_negatives(key, 4, 9, 7, jnp.asarray(vc)))
    for lo, rows in ((1, 2), (2, 2)):
        block = sample_negative_indices(seed, rows, 9, 7,
                                        torch.from_numpy(vc[lo:lo + rows]),
                                        row_offset=lo)
        assert np.array_equal(block.numpy(), full[lo:lo + rows])


def test_gumbel_rows():
    """Bitwise the port's global draw's rows; against JAX's within the two
    libraries' ``log`` (the uniform bits are equal)."""
    shape = (4, 6, 2, 8)
    local = (2,) + shape[1:]
    block = hash_gumbel(local, SEED, base=row_base(local, 2))
    assert torch.equal(block, hash_gumbel(shape, SEED)[2:])
    assert np.array_equal(
        hash_uniform(local, SEED, base=row_base(local, 2)).numpy(),
        np.asarray(jax_hashrand.hash_uniform(shape, jnp.uint32(SEED)))[2:])
    full = np.asarray(jax_hashrand.hash_gumbel(shape, jnp.uint32(SEED)))
    np.testing.assert_allclose(block.numpy(), full[2:], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_rows(dtype):
    x = torch.randn(4, 9, 16, generator=torch.Generator().manual_seed(0))
    x = x.to(dtype)
    full = fused_dropout(x, 0.1, SEED)
    jax_full = np.asarray(jax_hash_dropout(
        jnp.asarray(x.float().numpy()), 0.1, jnp.uint32(SEED)))
    for lo in (1, 3):
        block = fused_dropout(x[lo:], 0.1, SEED, row_base(x.shape, lo))
        assert torch.equal(block, full[lo:])
        if dtype == torch.float32:
            assert np.array_equal(block.numpy(), jax_full[lo:])


def _qkv(b, h, t, dh, dtype):
    g = torch.Generator().manual_seed(1)
    return [torch.randn(b, h, t, dh, generator=g).to(dtype)
            for _ in range(4)]


@pytest.mark.parametrize("xla", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_core_rows(xla, dtype):
    """Kernels 2 and 2b: the block's rows draw the global call's masks
    ("kernel": seed + (b0 + b)*H + h; "xla": the flat (B, H, T, T) index
    from b0), forward and backward, with a zero-length key row."""
    q, k, v, dout = _qkv(4, 2, 19, 16, dtype)
    kv = torch.ones(4, 19, dtype=torch.bool)
    kv[1, 11:] = False
    kv[2] = False
    args = dict(xla=xla)
    full = attention_core_plain(q, k, v, kv, 0.25, 0.2, SEED, **args)
    full_g = attention_core_bwd_plain(q, k, v, kv, 0.25, 0.2, SEED, dout,
                                      **args)
    for lo in (1, 2, 3):
        sl = slice(lo, None)
        part = attention_core_plain(q[sl], k[sl], v[sl], kv[sl], 0.25, 0.2,
                                    SEED, b0=lo, **args)
        assert torch.equal(part, full[sl])
        grads = attention_core_bwd_plain(q[sl], k[sl], v[sl], kv[sl], 0.25,
                                         0.2, SEED, dout[sl], b0=lo, **args)
        for g, f in zip(grads, full_g):
            assert torch.equal(g, f[sl])


@pytest.mark.parametrize("xla", [False, True])
def test_attention_core_base_past_the_wrap(xla):
    """A row base whose flat index passes 2**32 under "xla" (and whose
    seed sum wraps under "kernel"): the keep mask of the plain version is
    the numpy emulation's."""
    b0, h, t = 2 ** 32 // (2 * 8 * 8) - 1, 2, 8
    q, k, v, _ = _qkv(2, h, t, 16, torch.float32)
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * 0.25, dim=-1)
    out = attention_core_plain(q, k, v, None, 0.25, 0.5, SEED, xla=xla,
                               b0=b0)
    r = np.arange(t, dtype=np.uint64)
    keep = np.zeros((2, h, t, t), bool)
    for bb in range(2):
        for hh in range(h):
            g = (b0 + bb) * h + hh
            if xla:
                idx = (g * t * t + r[:, None] * t + r[None, :]) % 2 ** 32
                bits = np_mix32(idx, SEED)
            else:
                bits = np_mix32(r[:, None] * 128 + r[None, :],
                                (SEED + g) % 2 ** 32)
            keep[bb, hh] = bits >= np.uint32(2 ** 31)
    want = torch.matmul(torch.where(torch.from_numpy(keep), p * 2.0,
                                    torch.zeros(())), v)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)


def test_attention_block_rows():
    """Kernels 6 and 6b's plain versions: the same row base."""
    g = torch.Generator().manual_seed(2)
    d, heads = 32, 2
    x = torch.randn(3, 21, d, generator=g)
    ws = [torch.randn(d, d, generator=g) * 0.1 if i % 2 == 0
          else torch.randn(d, generator=g) * 0.1 for i in range(8)]
    kv = torch.ones(3, 21, dtype=torch.bool)
    kv[2, 9:] = False
    dout = torch.randn(3, 21, d, generator=g)
    full = attention_block_plain(x, *ws, kv, heads, 0.25, 0.2, SEED)
    full_g = attention_block_bwd_plain(x, *ws, kv, heads, 0.25, 0.2, SEED,
                                       dout)
    part = attention_block_plain(x[1:], *ws, kv[1:], heads, 0.25, 0.2, SEED,
                                 b0=1)
    assert torch.equal(part, full[1:])
    part_g = attention_block_bwd_plain(x[1:], *ws, kv[1:], heads, 0.25, 0.2,
                                       SEED, dout[1:], b0=1)
    assert torch.equal(part_g[0], full_g[0][1:])
