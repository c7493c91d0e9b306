"""Port's attention core (plain version, which the CUDA kernel is held to
on the card) vs the JAX ``attention_core`` Pallas kernel in interpret mode:
padding to the 128 grid, key masks, the all-invalid (zero-length) row and
the bit-exact hash-dropout mask."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.ops.pallas.attention_kernel import _hash_keep
from audio8_tpu.ops.pallas.attention_kernel import attention_core as jax_core
from audio8_tpu_torch.ops.attention import attention_core, hash_keep


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
