"""Port's k3s2 conv (plain version, which the CUDA kernel is held to on
the card) vs the JAX ``conv1d_k3s2`` Pallas kernel (interpret mode on the
CPU backend) and vs ``lax.conv``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.nn.layers import _conv1d_nwc
from audio8_tpu.ops.pallas.conv_kernel import conv1d_k3s2 as jax_conv1d_k3s2
from audio8_tpu_torch.ops.conv import conv1d_k3s2, conv1d_k3s2_plain

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
