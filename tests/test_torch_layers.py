"""Port layers vs the flax layers of ``audio8_tpu.nn`` on the same
parameters: Dense, Conv1D, LayerNorm, GroupNorm (masked statistics and
plain), PositionalConv, and the post-norm encoder layer with the fused
attention core. float32 on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.nn import layers as jl
from audio8_tpu.nn.transformer import TransformerEncoderLayer as JLayer
from audio8_tpu_torch.nn import layers as tl
from audio8_tpu_torch.nn.transformer import TransformerEncoderLayer
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

ATOL = 1e-5


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _run(module, params, *args):
    return np.asarray(module.apply({"params": params}, *args))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_dense(rng):
    x = _rand(rng, 2, 5, 8)
    params = {"kernel": _rand(rng, 8, 16), "bias": _rand(rng, 16)}
    want = _run(jl.Dense(16), params, jnp.asarray(x))
    d = tl.Dense(8, 16)
    d.load_state_dict({"weight": _t(params["kernel"].T),
                       "bias": _t(params["bias"])})
    np.testing.assert_allclose(d(_t(x)).detach().numpy(), want, atol=ATOL)


@pytest.mark.parametrize("k,s,c_in", [(3, 2, 16), (10, 5, 1), (2, 2, 16)])
def test_conv1d(rng, k, s, c_in):
    x = _rand(rng, 2, 53, c_in)
    kernel = _rand(rng, k, c_in, 12, scale=0.2)
    want = _run(jl.Conv1D(features=12, kernel_size=k, stride=s),
                {"kernel": kernel}, jnp.asarray(x))
    c = tl.Conv1D(c_in, 12, k, s)
    c.load_state_dict({"weight": _t(np.transpose(kernel, (2, 1, 0)))})
    np.testing.assert_allclose(c(_t(x)).detach().numpy(), want, atol=ATOL)


def test_layer_norm(rng):
    x = _rand(rng, 2, 7, 16, scale=3.0) + 1.5
    params = {"scale": _rand(rng, 16), "bias": _rand(rng, 16)}
    want = _run(jl.LayerNorm(), params, jnp.asarray(x))
    ln = tl.LayerNorm(16)
    ln.load_state_dict({"weight": _t(params["scale"]),
                        "bias": _t(params["bias"])})
    np.testing.assert_allclose(ln(_t(x)).detach().numpy(), want, atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_group_norm(rng, masked):
    x = _rand(rng, 3, 11, 8, scale=2.0) + 0.7
    params = {"scale": _rand(rng, 8), "bias": _rand(rng, 8)}
    mask = None
    if masked:  # full, ragged and empty rows
        mask = np.arange(11)[None, :] < np.array([11, 4, 0])[:, None]
    want = _run(jl.GroupNorm(num_groups=4), params, jnp.asarray(x),
                None if mask is None else jnp.asarray(mask))
    gn = tl.GroupNorm(4, 8)
    gn.load_state_dict({"weight": _t(params["scale"]),
                        "bias": _t(params["bias"])})
    got = gn(_t(x), None if mask is None else _t(mask)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    if masked:  # padding does not move a row's statistics
        short = gn(_t(x[1:2, :4]), _t(mask[1:2, :4])).detach().numpy()
        np.testing.assert_allclose(got[1:2, :4], short, atol=ATOL)


@pytest.mark.parametrize("kernel_size", [8, 7])
def test_positional_conv(rng, kernel_size):
    x = _rand(rng, 2, 19, 16)
    params = {"weight_v": _rand(rng, kernel_size, 4, 16, scale=0.3),
              "weight_g": np.abs(_rand(rng, kernel_size, 1, 1)) + 0.5,
              "bias": _rand(rng, 16)}
    want = _run(jl.PositionalConv(features=16, kernel_size=kernel_size,
                                  groups=4), params, jnp.asarray(x))
    pc = tl.PositionalConv(16, kernel_size, 4)
    pc.load_state_dict({
        "weight_v": _t(np.transpose(params["weight_v"], (2, 1, 0))),
        "weight_g": _t(np.transpose(params["weight_g"], (2, 1, 0))),
        "bias": _t(params["bias"])})
    got = pc(_t(x)).detach().numpy()
    assert got.shape == want.shape == (2, 19, 16)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_encoder_layer_with_fused_attention_core(rng):
    d, h, ff, t = 32, 4, 64, 21
    x = _rand(rng, 2, t, d)
    kv = np.arange(t)[None, :] < np.array([t, 9])[:, None]
    jlayer = JLayer(num_heads=h, d_model=d, d_ff=ff, dropout_rate=0.0,
                    fused_attention=True)
    params = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = np.asarray(jlayer.apply({"params": params}, jnp.asarray(x),
                                   jnp.asarray(kv)[:, None, None, :]))
    layer = TransformerEncoderLayer(h, d, ff)
    sd = {}
    for jn, tn in (("w_Q", "q_proj"), ("w_K", "k_proj"), ("w_V", "v_proj"),
                   ("w_O", "out_proj")):
        sd[f"self_attn.{tn}.weight"] = _t(params["self_attn"][jn]["kernel"]).T
        sd[f"self_attn.{tn}.bias"] = _t(params["self_attn"][jn]["bias"])
    for jn, tn in (("expand", "fc1"), ("contract", "fc2")):
        sd[f"{tn}.weight"] = _t(params["ffn"][jn]["kernel"]).T
        sd[f"{tn}.bias"] = _t(params["ffn"][jn]["bias"])
    for jn, tn in (("ln_attn", "self_attn_layer_norm"),
                   ("ln_ffn", "final_layer_norm")):
        sd[f"{tn}.weight"] = _t(params[jn]["scale"])
        sd[f"{tn}.bias"] = _t(params[jn]["bias"])
    layer.load_state_dict(sd)
    got = layer(_t(x), _t(kv)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
