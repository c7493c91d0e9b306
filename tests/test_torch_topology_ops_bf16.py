"""The bf16 rounding orders of the new topologies' ops against their JAX
twins, where a torch op that rounds once would differ from JAX's two or
more roundings:

* the conformer's sigmoid, GLU and swish: XLA expands ``jax.nn.sigmoid``
  into ``1 / (1 + exp(-x))`` rounding each op to bf16, and its gradient
  into ``g * (y * (1 - y))`` op by op; the port's forward and
  gradient equal JAX's bit for bit on every bf16 value in [-8, 8]
  (``torch.sigmoid`` and ``F.silu`` differ on about a third);
* the extractor's conv bias, added after the conv's own rounding: on
  small integers (sums exact in f32 in any order) the port's k=3,
  stride-2 ``Conv1D`` with bias equals JAX's bit for bit, and not one
  rounding of the product plus the bias;
* packed Q/K/V: one product over the three weights, then the bias, each
  rounded: bit for bit JAX's ``jnp.dot(x, w) + b`` and the three
  unpacked ``Dense`` layers on exact sums;
* the layer-mode extractor norm (f32 statistics, then the cast) and
  WavLM's gated bias added to bf16 logits, module against module, within
  one bf16 ulp of the norm and the bf16 attention bound of
  ``test_torch_xla_attention.py`` (2^-5 of max(1, |JAX|)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from audio8_tpu.nn.layers import Conv1D as JaxConv1D
from audio8_tpu.nn.layers import LayerNorm as JaxLayerNorm
from audio8_tpu.nn.transformer import MultiHeadAttention as JaxMHA
from audio8_tpu.nn.transformer import RelativePositionBias
from audio8_tpu_torch.nn.conformer import activation, sigmoid
from audio8_tpu_torch.nn.layers import Conv1D, LayerNorm
from audio8_tpu_torch.nn.transformer import (MultiHeadAttention,
                                             relative_position_bias)
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

BF16 = torch.bfloat16


def _grid():
    x = np.linspace(-8, 8, 20001).astype(np.float32)
    g = np.random.default_rng(0).normal(size=x.shape).astype(np.float32)
    return x, g


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def test_sigmoid_and_swish_round_as_jax():
    x, g = _grid()
    xb, gb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    for jfn, tfn in ((jax.nn.sigmoid, sigmoid),
                     (jax.nn.silu, activation("swish"))):
        want, vjp = jax.vjp(jfn, xb)
        (want_dx,) = vjp(gb)
        xt = torch.from_numpy(x).to(BF16).requires_grad_()
        y = tfn(xt)
        (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g).to(BF16))
        np.testing.assert_array_equal(_bits(y.detach()),
                                      np.asarray(want.astype(jnp.float32)))
        np.testing.assert_array_equal(_bits(dx),
                                      np.asarray(want_dx.astype(jnp.float32)))
    once = torch.nn.functional.silu(torch.from_numpy(x).to(BF16))
    jax_silu = np.asarray(jax.nn.silu(xb).astype(jnp.float32))
    assert (_bits(once) != jax_silu).mean() > 0.1  # the check can tell


def test_glu_rounds_as_jax():
    rng = np.random.default_rng(1)
    a, gate = (rng.normal(size=(64, 96)).astype(np.float32) * 3
               for _ in range(2))
    want = jnp.asarray(a, jnp.bfloat16) * jax.nn.sigmoid(
        jnp.asarray(gate, jnp.bfloat16))
    got = torch.from_numpy(a).to(BF16) * sigmoid(torch.from_numpy(gate).to(
        BF16))
    np.testing.assert_array_equal(_bits(got),
                                  np.asarray(want.astype(jnp.float32)))


def test_conv_bias_after_the_rounded_conv():
    rng = np.random.default_rng(2)
    x = rng.integers(-15, 16, size=(2, 41, 64)).astype(np.float32)
    kernel = rng.integers(-15, 16, size=(3, 64, 64)).astype(np.float32)
    bias = (rng.normal(size=64) * 64).astype(np.float32)
    jconv = JaxConv1D(features=64, kernel_size=3, stride=2, use_bias=True,
                      dtype=jnp.bfloat16)
    want = np.asarray(jconv.apply({"params": {"kernel": kernel,
                                              "bias": bias}},
                                  jnp.asarray(x)).astype(jnp.float32))
    conv = Conv1D(64, 64, 3, 2, dtype=BF16, use_bias=True)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel).permute(2, 1, 0))
        conv.bias.copy_(torch.from_numpy(bias))
        got = _bits(conv(torch.from_numpy(x)))
        once = torch.nn.functional.conv1d(
            torch.from_numpy(x).transpose(1, 2), conv.weight, conv.bias,
            stride=2).transpose(1, 2).to(BF16).float().numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(once, want)


def test_packed_qkv_rounds_as_jax():
    """JAX's packed Q/K/V (one product over the concatenated weights,
    then the concatenated bias) is the port's unpacked projections bit
    for bit in bf16, so the port computes ``packed_qkv`` unpacked."""
    rng = np.random.default_rng(3)
    d = 64
    x = rng.integers(-15, 16, size=(2, 7, d)).astype(np.float32)
    mha = MultiHeadAttention(4, d, BF16)
    params = {}
    with torch.no_grad():
        for m, jname in zip(mha.projections(), ("w_Q", "w_K", "w_V", "w_O")):
            w = rng.integers(-15, 16, size=(d, d)).astype(np.float32)
            b = (rng.normal(size=d) * 64).astype(np.float32)
            m.weight.copy_(torch.from_numpy(w.T))
            m.bias.copy_(torch.from_numpy(b))
            params[jname] = (w, b)
        got = [_bits(t) for t in mha.qkv(torch.from_numpy(x))]
    w = jnp.concatenate([jnp.asarray(params[n][0], jnp.bfloat16)
                         for n in ("w_Q", "w_K", "w_V")], axis=1)
    b = jnp.concatenate([jnp.asarray(params[n][1], jnp.bfloat16)
                         for n in ("w_Q", "w_K", "w_V")])
    qkv = np.asarray((jnp.dot(jnp.asarray(x, jnp.bfloat16), w) + b).astype(
        jnp.float32))
    for i, g in enumerate(got):
        want = qkv[..., i * d:(i + 1) * d].reshape(2, 7, 4, 16).transpose(
            0, 2, 1, 3)
        np.testing.assert_array_equal(g, want)


def test_layer_mode_norm_within_an_ulp_of_jax():
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(3, 50, 32)) * 4 + 1).astype(np.float32)
    scale = (1 + 0.3 * rng.normal(size=32)).astype(np.float32)
    bias = (0.3 * rng.normal(size=32)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(JaxLayerNorm(dtype=jnp.bfloat16).apply(
        {"params": {"scale": scale, "bias": bias}}, xb).astype(jnp.float32))
    ln = LayerNorm(32, BF16)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
        got = _bits(ln(torch.from_numpy(np.array(xb.astype(jnp.float32)))
                       .to(BF16)))
    np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=2.0 ** -8)
    assert (got == want).mean() > 0.99


def test_wavlm_gated_bias_on_bf16_logits():
    """A gated attention layer (fairseq names) against JAX's
    ``MultiHeadAttention(gated_rel_pos=True)`` fed JAX's
    ``RelativePositionBias``, bf16 with ``bf16_softmax``, key mask with a
    short row."""
    rng = np.random.default_rng(5)
    b, t, d, h, buckets = 2, 40, 64, 4, 32
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    kv = np.arange(t)[None, :] < np.array([t, 23])[:, None]
    jmha = JaxMHA(num_heads=h, d_model=d, gated_rel_pos=True,
                  dtype=jnp.bfloat16)
    xb = jnp.asarray(x, jnp.bfloat16)
    params = jax.tree.map(np.asarray, jmha.init(
        jax.random.PRNGKey(0), xb, xb, xb, None,
        position_bias=jnp.zeros((1, h, t, t)))["params"])
    params["gru_rel_pos_const"] = (1 + 0.3 * rng.normal(size=(1, h, 1, 1))
                                   ).astype(np.float32)
    embed = rng.normal(size=(buckets, h)).astype(np.float32)
    rpb = RelativePositionBias(num_heads=h, num_buckets=buckets,
                               max_distance=64, dtype=jnp.bfloat16)
    pos = rpb.apply({"params": {"rel_attn_embed": {"embedding": embed}}},
                    t, t)
    want = np.asarray(jmha.apply({"params": params}, xb, xb, xb,
                                 jnp.asarray(kv)[:, None, None, :],
                                 position_bias=pos).astype(jnp.float32))
    mha = MultiHeadAttention(h, d, BF16, gated_rel_pos=True,
                             rel_pos_buckets=buckets)
    with torch.no_grad():
        for name, jname in zip(mha.proj_names, ("w_Q", "w_K", "w_V", "w_O")):
            getattr(mha, name).weight.copy_(torch.from_numpy(
                params[jname]["kernel"].T))
            getattr(mha, name).bias.copy_(torch.from_numpy(
                params[jname]["bias"]))
        lin = params["gru_rel_pos_linear"]
        mha.gru_rel_pos_linear.weight.copy_(torch.from_numpy(lin["kernel"].T))
        mha.gru_rel_pos_linear.bias.copy_(torch.from_numpy(lin["bias"]))
        mha.gru_rel_pos_const.copy_(torch.from_numpy(
            params["gru_rel_pos_const"]))
        mha.rel_attn_embed.weight.copy_(torch.from_numpy(embed))
        bias = relative_position_bias(mha.rel_attn_embed.weight, t, buckets,
                                      64, BF16)
        np.testing.assert_array_equal(_bits(bias), np.asarray(
            pos.astype(jnp.float32)))
        got = _bits(mha(torch.from_numpy(np.array(
            xb.astype(jnp.float32))).to(BF16), torch.from_numpy(kv),
            position_bias=bias))
    bound = 2.0 ** -5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=bound, rtol=0)
