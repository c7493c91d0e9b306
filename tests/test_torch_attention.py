"""Port's attention core (plain version, which the CUDA kernel is held to
on the card) vs the JAX ``attention_core`` Pallas kernel in interpret mode:
padding to the 128 grid, key masks, the all-invalid (zero-length) row and
the bit-exact hash-dropout mask; the forward kernel's route rule, and a
plain emulation of its 64-key tiling held to the plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.ops.pallas.attention_kernel import _hash_keep
from audio8_tpu.ops.pallas.attention_kernel import attention_core as jax_core
from audio8_tpu_torch.ops.attention import (FWD_ROUTES, NEG, attention_core,
                                            attention_core_plain,
                                            attention_route, hash_keep)
from audio8_tpu_torch.ops.hashrand import MASK32, keep_threshold, mix32
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()


def _qkv(b, h, t, dh, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, t, dh)).astype(np.float32)
            for _ in range(3)]


def _key_valid(t, lengths):
    return np.arange(t)[None, :] < np.asarray(lengths)[:, None]


def _both(q, k, v, kv, scale, rate, seed):
    got = attention_core(*(torch.from_numpy(a) for a in (q, k, v)),
                         None if kv is None else torch.from_numpy(kv),
                         scale, rate, seed).numpy()
    want = np.asarray(jax_core(
        *(jnp.asarray(a) for a in (q, k, v)),
        None if kv is None else jnp.asarray(kv), scale, rate,
        None if rate == 0.0 else jnp.asarray([seed], jnp.uint32)))
    return got, want


@pytest.mark.parametrize("t", [37, 130])
@pytest.mark.parametrize("dh", [16, 64])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_matches_jax_kernel(t, dh, masked):
    b, h = 3, 2
    q, k, v = _qkv(b, h, t, dh)
    # masked: a full row, a ragged row and a zero-length row
    kv = _key_valid(t, [t, t // 3, 0]) if masked else None
    got, want = _both(q, k, v, kv, 1.0 / np.sqrt(dh), 0.0, 0)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_zero_length_row_is_uniform_over_the_padded_grid():
    """A row with no valid key averages v over T_pad = 256 columns, not T."""
    b, h, t, dh = 1, 1, 130, 16
    q, k, v = _qkv(b, h, t, dh, seed=5)
    got, _ = _both(q, k, v, _key_valid(t, [0]), 0.25, 0.0, 0)
    want = np.broadcast_to(v.sum(axis=2, keepdims=True) / 256.0, got.shape)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("t", [37, 130])
def test_dropout_matches_jax_kernel(t):
    b, h, dh = 2, 3, 16
    q, k, v = _qkv(b, h, t, dh, seed=1)
    kv = _key_valid(t, [t, t - 11])
    got, want = _both(q, k, v, kv, 0.25, 0.1, 1234)
    np.testing.assert_allclose(got, want, atol=1e-5)
    no_drop, _ = _both(q, k, v, kv, 0.25, 0.0, 0)
    assert np.abs(got - no_drop).max() > 1e-3  # dropout took effect


def test_hash_mask_bit_exact():
    t_pad, seed, rate = 256, 0xFFFFFFFE, 0.1
    seeds = torch.tensor([(seed + g) & 0xFFFFFFFF for g in range(4)])
    got = hash_keep(t_pad, seeds, rate).numpy()
    for g in range(4):  # seed + g wraps past 2**32 for g >= 2
        want = np.asarray(_hash_keep((t_pad, t_pad),
                                     jnp.uint32(seed) + jnp.uint32(g), rate))
        np.testing.assert_array_equal(got[g], want)
    assert 0.08 < 1.0 - got.mean() < 0.12


# attention_fwd.cu's route rule, which the kernel applies:
# (dtype, head dim, 16-byte aligned) -> route
ROUTES = [(torch.float32, 64, True, "simt"), (torch.float32, 128, False, "simt"),
          (torch.bfloat16, 64, True, "wgmma"),
          (torch.bfloat16, 128, True, "wgmma"),
          (torch.bfloat16, 16, True, "mma.sync"),
          (torch.bfloat16, 32, True, "mma.sync"),
          (torch.bfloat16, 64, False, "simt"),
          (torch.bfloat16, 32, False, "simt")]


@pytest.mark.parametrize("dtype,dh,aligned,route", ROUTES)
def test_attention_route_follows_the_rule(dtype, dh, aligned, route):
    """float32 stays on the SIMT kernel (full f32 sums); aligned bf16 takes
    the TMA-fed wgmma kernel at head dims 64 and 128 (whole 64-wide
    boxes), mma.sync at 16 and 32; misaligned bf16 takes SIMT."""
    assert attention_route(dtype, dh, aligned) == route
    assert route in FWD_ROUTES


BKV = 64  # keys per tile of every route of attention_fwd.cu
LOG2E = np.float32(1.4426950408889634)


def _tiled_core(q, k, v, kv, scale, rate, seed, xla):
    """A plain-PyTorch emulation of the forward kernels' tiling (float32):
    an online softmax over 64-key tiles of the real T keys only, the
    key mask as each tile's valid bits, exp2 of the log2e-scaled logits
    and row max (each product rounded on its own), the "kernel"
    semantics' missing columns [n_tiles * 64, T_pad) added to the row sum
    at -1e9, and the dropout hash indexed from the tile coordinates
    (``drop_row`` + tile start + column) after the row sum."""
    b, h, t, dh = q.shape
    t_pad = -(-t // 128) * 128
    n_tiles = -(-t // BKV)
    neg = torch.tensor(NEG, dtype=torch.float32)
    m = torch.full((b, h, t), -np.inf)
    l = torch.zeros((b, h, t))
    acc = torch.zeros((b, h, t, dh))
    bh = torch.arange(b * h, dtype=torch.int64).view(b, h, 1)
    rows = torch.arange(t, dtype=torch.int64).view(1, 1, t)
    row0 = (((bh * t + rows) * t) if xla else (rows * t_pad + 0 * bh)) \
        & MASK32
    seeds = (seed + (0 * bh if xla else bh)) & MASK32
    for kt in range(n_tiles):
        c = kt * BKV + torch.arange(BKV)
        inside = c < t
        cc = torch.clamp(c, max=t - 1)
        valid = inside if kv is None else inside & kv[:, cc]
        valid = valid.view(-1 if kv is not None else 1, 1, 1, BKV)
        s = torch.matmul(q, k[:, :, cc].transpose(-1, -2)) * scale
        pad = torch.where(inside, neg, torch.tensor(
            -np.inf if xla else NEG)).view(1, 1, 1, BKV)
        s = torch.where(valid, s, pad)
        m_new = torch.maximum(m, s.amax(-1))
        m2 = m_new * LOG2E
        alpha = torch.exp2(m * LOG2E - m2)
        e = torch.exp2(s * LOG2E - m2[..., None])
        l = l * alpha + e.sum(-1)
        if rate > 0.0:
            idx = (row0[..., None] + c.view(1, 1, 1, BKV)) & MASK32
            keep = mix32(idx ^ seeds[..., None]) >= keep_threshold(rate)
            e = torch.where(keep, e, torch.zeros(()))
        vt = torch.where(inside[:, None], v[:, :, cc], torch.zeros(()))
        acc = acc * alpha[..., None] + torch.matmul(e, vt)
        m = m_new
    if not xla:
        l = l + (t_pad - n_tiles * BKV) * torch.exp2(neg * LOG2E - m * LOG2E)
    return acc / (1.0 - rate) / l[..., None]


@pytest.mark.parametrize("t", [1, 63, 64, 65, 129, 222])
@pytest.mark.parametrize("xla", [False, True])
def test_tiled_emulation_matches_plain(t, xla):
    """The kernels' tiling (:func:`_tiled_core`) computes what
    ``attention_core_plain`` computes, in both semantics, with a full, a
    ragged and a zero-length row (uniform over T_pad keys under "kernel",
    over T under "xla"), without and with dropout 0.1. float32 on both
    sides; they differ by the exp2 rounding (about 1e-7 relative per
    probability) and the order of the sums, so 1e-5 of the output's
    scale."""
    b, h, dh = 3, 2, 16
    q, k, v = (torch.from_numpy(a) for a in _qkv(b, h, t, dh, seed=t))
    kv = torch.from_numpy(_key_valid(t, [t, max(1, t // 3), 0]))
    for rate, seed in ((0.0, 0), (0.1, 0xFFFFFFF0)):
        got = _tiled_core(q, k, v, kv, dh ** -0.5, rate, seed, xla)
        want = attention_core_plain(q, k, v, kv, dh ** -0.5, rate, seed,
                                    xla=xla)
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, atol=1e-5 * scale, rtol=0)
    # no valid key: the mean of v over the softmax's keys
    n = t if xla else -(-t // 128) * 128
    uniform = _tiled_core(q, k, v, kv, dh ** -0.5, 0.0, 0, xla)[2]
    torch.testing.assert_close(
        uniform, v[2].sum(1, keepdim=True).expand_as(uniform) / n,
        atol=1e-6, rtol=0)
