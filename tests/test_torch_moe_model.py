"""Mixture-of-Experts acoustic models of the port against the JAX package
on the CPU, at d 64, f 128, 4 layers, E 4 (layers 1 and 3 MoE).

* The acoustic model's log-probs on a ragged batch (a row of zeros
  included) on weights carried across (``params_from_jax``), top-1 and
  top-2, in f32 within 1e-5 and in bf16 within 0.15 (the bf16 bound of
  ``test_torch_topologies_bf16.py``'s dense models; one bf16 ulp of an
  expert product can move a token's routing in a later layer only at a
  near tie, which these weights do not have).
* The conformer ignores the MoE fields in both packages: a dense tree
  and a dense port model, the same log-probs.
* The ``torch.export`` entry of a MoE model (symbolic batch) equals the
  live forward bitwise at three batch sizes.
* int8: the quantized Dense count equals JAX's, two fewer per MoE layer
  than the dense model (the router, E < 64 wide, and the experts stay
  float).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.config import AcousticConfig as JaxConfig
from audio8_tpu.models.wav2vec2 import Wav2Vec2AcousticModel as JaxModel
from audio8_tpu.ops.quant import quantize_dense_tree
from audio8_tpu.utils import Offsets as JaxOffsets
from audio8_tpu_torch import export as E
from audio8_tpu_torch.config import AcousticConfig
from audio8_tpu_torch.models.convert import params_from_jax
from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
from audio8_tpu_torch.ops.quant import quantize_model_params
from audio8_tpu_torch.utils import Offsets
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

FX = ((32, 10, 5), (32, 3, 2))
V = 12
SIZE = dict(num_labels=V, d_model=64, num_heads=4, num_layers=4, d_ff=128,
            custom_conv_features=FX)
EVAL = dict(dropout=0.0, timestep_masking=0.0, channel_masking=0.0)
MOE = dict(moe_experts=4, moe_capacity_factor=1.25)


@pytest.fixture(autouse=True)
def _fairseq_offsets():
    saved = (Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK,
             list(Offsets.VALUES))
    Offsets.remap_fairseq_ctc()
    JaxOffsets.remap_fairseq_ctc()
    yield
    Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK = saved[:4]
    Offsets.VALUES[:] = saved[4]


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 2400)).astype(np.float32)
    lengths = np.array([2400, 1500, 0], np.int32)
    x[np.arange(2400)[None, :] >= lengths[:, None]] = 0.0
    return x, lengths


def jax_init(cfg: dict, seed: int = 0):
    """A JAX init with random biases, so every leaf moves the output."""
    x, lengths = _batch()
    model = JaxModel(config=JaxConfig(**cfg))
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.asarray(x),
                                 jnp.asarray(lengths))["params"]
    params = jax.tree.map(np.array, params)
    rng = np.random.default_rng(seed + 1)
    for i in range(cfg["num_layers"]):
        ffn = params["encoder"]["encoder"]["transformer"][f"layer_{i}"]["ffn"]
        for k in ("bi", "bo"):
            if k in ffn:
                ffn[k] = (rng.normal(size=ffn[k].shape) * 0.1).astype(
                    np.float32)
    return params


@pytest.fixture(scope="module")
def moe_params():
    """One JAX init of the MoE model (top-k does not change the tree)."""
    return jax_init(dict(SIZE, **EVAL, **MOE))


def port_model(cfg: dict, params, dtype=torch.float32):
    model = Wav2Vec2AcousticModel(AcousticConfig(**cfg), dtype)
    model.load_state_dict(params_from_jax(params), strict=True)
    return model.eval()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_acoustic_forward_matches_jax(moe_params, top_k, dtype):
    cfg = dict(SIZE, **EVAL, **MOE, moe_top_k=top_k)
    params = moe_params
    tree = params["encoder"]["encoder"]["transformer"]
    assert [i for i in range(4) if "wi" in tree[f"layer_{i}"]["ffn"]] \
        == [1, 3]
    bf16 = dtype == "bf16"
    jmodel = JaxModel(config=JaxConfig(**cfg),
                      dtype=jnp.bfloat16 if bf16 else jnp.float32)
    x, lengths = _batch(1)
    want, wmask = jax.jit(lambda p, a, n: jmodel.apply({"params": p}, a, n))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x),
        jnp.asarray(lengths))
    model = port_model(cfg, params,
                       torch.bfloat16 if bf16 else torch.float32)
    assert [i for i, layer in enumerate(model.encoder.encoder.layers)
            if layer.moe is not None] == [1, 3]
    with torch.no_grad():
        got, mask = model(torch.from_numpy(x), torch.from_numpy(lengths))
    assert np.array_equal(mask.numpy(), np.asarray(wmask))
    valid = np.asarray(wmask)
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               atol=0.15 if bf16 else 1e-5, rtol=0)


def test_conformer_ignores_moe_as_jax_does():
    cfg = dict(SIZE, **EVAL, **MOE, num_layers=2, extractor_mode="layer",
               conv_bias=True, encoder_type="conformer",
               position_embeddings_type="rotary",
               conv_depthwise_kernel_size=7)
    x, lengths = _batch()
    jmodel = JaxModel(config=JaxConfig(**cfg))
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(x),
        jnp.asarray(lengths))["params"])
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert not any("wi" in jax.tree_util.keystr(p) for p, _ in leaves)
    model = port_model(cfg, params)
    assert not any(".moe." in k for k in model.state_dict())
    want, _ = jmodel.apply({"params": params}, jnp.asarray(x),
                           jnp.asarray(lengths))
    with torch.no_grad():
        got, mask = model(torch.from_numpy(x), torch.from_numpy(lengths))
    valid = mask.numpy()
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("top_k", [1, 2])
def test_export_equals_live_forward(top_k):
    cfg = AcousticConfig(**SIZE, **EVAL, **MOE, moe_top_k=top_k)
    model = Wav2Vec2AcousticModel(
        cfg, generator=torch.Generator().manual_seed(0)).eval()
    state = model.state_dict()
    program = E.export_forward(
        E.state_fn(model, lambda out: (out[0], out[1].sum(-1))),
        list(state), list(state.values()), 2400, torch.device("cpu"))
    x, lengths = _batch(3)
    for rows in ([0, 1, 2], [1], [0, 1, 2, 0, 1]):
        sig, lens = torch.from_numpy(x[rows]), torch.from_numpy(lengths[rows])
        lp, frames = program.module()(list(state.values()), sig, lens)
        with torch.no_grad():
            want, mask = model(sig, lens)
        assert torch.equal(lp, want) and torch.equal(frames, mask.sum(-1))


def test_int8_count_equals_jax(moe_params):
    cfg = dict(SIZE, **EVAL, **MOE)
    _, jax_count = quantize_dense_tree(moe_params)
    model = port_model(cfg, moe_params)
    count = quantize_model_params(model)
    dense = quantize_model_params(Wav2Vec2AcousticModel(
        AcousticConfig(**SIZE, **EVAL), generator=torch.Generator()))
    assert count == jax_count == dense - 2 * 2
    assert model.encoder.encoder.layers[1].moe.router.weight.dtype \
        == torch.float32
