"""Every encoder topology of the port against the JAX package on shared
weights (``params_from_jax`` of a JAX init): the tiny acoustic model's
log-probs on a ragged batch (one row empty) in f32 within 1e-4 (bf16:
``test_torch_topologies_bf16.py``; the pretraining model:
``test_torch_topologies_pretrain.py``), the converters' key table
against each model's own weights, and WavLM's bucket table. The
cases: stable layer norm with the layer-norm extractor,
with and without conv bias (LV-60, HuBERT-large), data2vec's positional
stack, WavLM's gated position bias (post-norm group mode and pre-norm
layer mode), the conformer with rotary and relative positions, packed
Q/K/V, flash, causal chunks with and without a left limit, and the
pre-norm stack under each ``fused_attention`` setting."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.config import AcousticConfig as JaxAcousticConfig
from audio8_tpu.models.wav2vec2 import Wav2Vec2AcousticModel as JaxModel
from audio8_tpu.nn.transformer import \
    relative_position_buckets as jax_buckets
from audio8_tpu_torch.config import AcousticConfig
from audio8_tpu_torch.models.convert import encoder_table, params_from_jax
from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
from audio8_tpu_torch.nn.transformer import relative_position_buckets
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

FX = ((32, 10, 5), (32, 3, 2))
SIZE = dict(d_model=64, num_heads=4, num_layers=2, d_ff=128,
            custom_conv_features=FX)
LV60 = dict(pre_norm=True, extractor_mode="layer", conv_bias=True)
TOPOLOGIES = {
    "lv60": LV60,
    "hubert_large": dict(LV60, conv_bias=False),
    "layer_post_norm": dict(extractor_mode="layer", conv_bias=True),
    "data2vec": dict(extractor_mode="layer", pos_conv_depth=5,
                     conv_pos_kernel=19),
    "wavlm_base": dict(gated_rel_pos=True, rel_pos_buckets=32,
                       rel_pos_max_distance=64),
    "wavlm_large": dict(LV60, conv_bias=False, gated_rel_pos=True),
    "conformer_rotary": dict(extractor_mode="layer", conv_bias=True,
                             encoder_type="conformer",
                             position_embeddings_type="rotary",
                             conv_depthwise_kernel_size=7),
    "conformer_relative": dict(extractor_mode="layer", conv_bias=True,
                               encoder_type="conformer",
                               position_embeddings_type="relative",
                               conv_depthwise_kernel_size=7),
    "packed_qkv": dict(packed_qkv=True),
    "packed_qkv_lv60": dict(LV60, packed_qkv=True),
    "flash": dict(flash_attention=True, fused_attention=True),
    "causal_chunks": dict(extractor_mode="layer", causal_chunk_frames=4),
    "causal_left_chunks": dict(extractor_mode="layer", causal_chunk_frames=4,
                               causal_left_chunks=1),
    "lv60_core": dict(LV60, fused_attention=True),
    "lv60_block": dict(LV60, fused_attention="block"),
}
EVAL = dict(dropout=0.0, timestep_masking=0.0, channel_masking=0.0)


def _batch():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 4000)).astype(np.float32)
    lengths = np.array([4000, 2300, 0], np.int32)
    x[np.arange(4000)[None, :] >= lengths[:, None]] = 0.0
    return x, lengths


@pytest.fixture(scope="module")
def acoustic_weights():
    """One JAX init per topology (the attention settings share their
    topology's tree), with random affine norms, biases and gates so each
    weight changes the output."""
    cache = {}

    def get(topo):
        key = tuple(sorted((k, v) for k, v in topo.items()
                           if k not in ("fused_attention", "packed_qkv",
                                        "flash_attention",
                                        "causal_chunk_frames",
                                        "causal_left_chunks")))
        if key not in cache:
            cfg = JaxAcousticConfig(num_labels=10, **SIZE, **EVAL, **topo)
            params = jax.jit(JaxModel(config=cfg).init)(
                jax.random.PRNGKey(0), jnp.zeros((1, 4000)))["params"]
            cache[key] = _perturb(jax.tree.map(np.asarray, params))
        return cache[key]

    return get


def _perturb(tree, seed=1):
    """Zero-initialised leaves (biases, LayerNorm offsets, position
    biases, the folded BatchNorm) and the unit ones (scales, the WavLM
    constant) get random values: a weight the port read from the wrong
    place would then change the output."""
    rng = np.random.default_rng(seed)

    def go(node, path=()):
        if isinstance(node, dict):
            return {k: go(v, path + (k,)) for k, v in node.items()}
        leaf = path[-1]
        if leaf in ("bias", "pos_bias_u", "pos_bias_v", "bn_bias"):
            return (node + 0.1 * rng.standard_normal(node.shape)
                    ).astype(np.float32)
        if leaf in ("scale", "bn_scale", "gru_rel_pos_const"):
            return (node * (1.0 + 0.2 * rng.standard_normal(node.shape))
                    ).astype(np.float32)
        return node

    return go(tree)


def _port_acoustic(topo, params, dtype=torch.float32):
    model = Wav2Vec2AcousticModel(AcousticConfig(num_labels=10, **SIZE,
                                                 **EVAL, **topo), dtype)
    model.load_state_dict(params_from_jax(params), strict=True)
    return model.eval()


def _jax_acoustic(topo, params, x, lengths, dtype=jnp.float32):
    model = JaxModel(config=JaxAcousticConfig(num_labels=10, **SIZE, **EVAL,
                                              **topo), dtype=dtype)
    lp, mask = jax.jit(model.apply)({"params": params}, jnp.asarray(x),
                                    jnp.asarray(lengths))
    return np.asarray(lp), np.asarray(mask)


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_acoustic_f32_matches_jax(acoustic_weights, name):
    topo = TOPOLOGIES[name]
    params = acoustic_weights(topo)
    x, lengths = _batch()
    want, mask = _jax_acoustic(topo, params, x, lengths)
    model = _port_acoustic(topo, params)
    with torch.inference_mode():
        lp, pmask = model(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_array_equal(pmask.numpy(), mask)
    np.testing.assert_allclose(lp.numpy()[mask], want[mask], atol=1e-4)


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_table_names_every_port_weight(name):
    """The topology table (fairseq names) and the port model's own state
    dict are the same set of keys: nothing the model holds is left out of
    the converters, nothing the converters write has no place."""
    topo = TOPOLOGIES[name]
    cfg = AcousticConfig(num_labels=10, **SIZE, **EVAL, **topo)
    model = Wav2Vec2AcousticModel(cfg)
    body = {k[len("encoder."):] for k in model.state_dict()
            if k.startswith("encoder.")}
    table = {k for k, _, _ in encoder_table(dataclasses.asdict(cfg),
                                            len(FX), SIZE["num_layers"])}
    assert body == table


def test_relative_position_buckets_match_jax():
    for t, buckets, dist in ((1, 320, 800), (7, 320, 800), (64, 32, 64),
                             (1499, 320, 800), (1500, 320, 800)):
        np.testing.assert_array_equal(relative_position_buckets(
            t, t, buckets, dist), jax_buckets(t, t, buckets, dist))
    np.testing.assert_array_equal(relative_position_buckets(5, 1500, 320, 800),
                                  jax_buckets(5, 1500, 320, 800))
