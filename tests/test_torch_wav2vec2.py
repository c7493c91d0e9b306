"""The port's ``Wav2Vec2AcousticModel`` vs the JAX model on the same
weights (moved across with ``params_from_jax``): a tiny model with one k3s2
extractor layer, a batch of ragged ``input_lengths`` (one row empty), with
the JAX side on its XLA attention, on its fused Pallas core and on its
fused attention block (``fused_attention="block"``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.config import AcousticConfig
from audio8_tpu.models.wav2vec2 import Wav2Vec2AcousticModel as JaxModel
from audio8_tpu.models.wav2vec2 import downsample_lengths as jax_downsample
from audio8_tpu_torch.models.convert import (from_fairseq_ctc_state,
                                             params_from_jax,
                                             to_fairseq_ctc_state)
from audio8_tpu_torch.models.wav2vec2 import (Wav2Vec2AcousticModel,
                                              downsample_lengths)
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

CFG = AcousticConfig(num_labels=10, d_model=64, num_heads=4, num_layers=2,
                     d_ff=128, dropout=0.0, timestep_masking=0.0,
                     channel_masking=0.0,
                     custom_conv_features=((32, 10, 5), (32, 3, 2),
                                           (32, 2, 2)))


@pytest.fixture(scope="module")
def weights():
    x = np.zeros((1, 4000), np.float32)
    params = jax.jit(JaxModel(config=CFG).init)(jax.random.PRNGKey(0),
                                                jnp.asarray(x))["params"]
    return jax.tree.map(np.asarray, params)


def _jax_log_probs(weights, x, lengths=None, dtype=jnp.float32, **over):
    model = JaxModel(config=dataclasses.replace(CFG, **over), dtype=dtype)
    args = (jnp.asarray(x),) if lengths is None else (
        jnp.asarray(x), jnp.asarray(lengths))
    lp, mask = jax.jit(model.apply)({"params": weights}, *args)
    return np.asarray(lp), None if mask is None else np.asarray(mask)


def _batch():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 4000)).astype(np.float32)
    lengths = np.array([4000, 2500, 999, 0], np.int32)
    x[np.arange(4000)[None, :] >= lengths[:, None]] = 0.0
    return x, lengths


@pytest.mark.parametrize("fused", [None, True, "block"])
def test_log_probs_match_jax(weights, fused):
    """One ``params_from_jax`` state dict feeds every setting: "block"
    reads the same q/k/v/out projections as the core."""
    x, lengths = _batch()
    lp_j, mask_j = _jax_log_probs(weights, x, lengths, fused_attention=fused)
    model = Wav2Vec2AcousticModel(dataclasses.replace(
        CFG, fused_attention=fused))
    model.load_state_dict(params_from_jax(weights), strict=True)
    with torch.inference_mode():
        lp, mask = model(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_array_equal(mask.numpy(), mask_j)
    assert lp.dtype == torch.float32 and lp.shape == lp_j.shape
    np.testing.assert_allclose(lp.numpy()[mask_j], lp_j[mask_j], atol=1e-4)


def test_no_lengths_matches_jax(weights):
    x, _ = _batch()
    lp_j, _ = _jax_log_probs(weights, x)
    model = Wav2Vec2AcousticModel(CFG)
    model.load_state_dict(params_from_jax(weights))
    with torch.inference_mode():
        lp, mask = model(torch.from_numpy(x))
    assert mask is None
    np.testing.assert_allclose(lp.numpy(), lp_j, atol=1e-4)


def test_bf16_matches_jax_bf16(weights):
    """bf16 compute with f32 params in both packages. They round at
    different points (PyTorch's fused linear+bias, erf GELU in f32), so
    the bound is a bf16-scale one: 0.1 in log-prob, where the two bf16
    models sit 0.04 from their own f32 outputs."""
    x, lengths = _batch()
    lp_j, mask_j = _jax_log_probs(weights, x, lengths, dtype=jnp.bfloat16)
    model = Wav2Vec2AcousticModel(CFG, dtype=torch.bfloat16)
    model.load_state_dict(params_from_jax(weights))
    with torch.inference_mode():
        lp, _ = model(torch.from_numpy(x), torch.from_numpy(lengths))
    assert lp.dtype == torch.float32  # log-probs leave the head in f32
    np.testing.assert_allclose(lp.numpy()[mask_j], lp_j[mask_j], atol=0.1)


def test_downsample_lengths_matches_jax():
    lengths = np.array([0, 1, 319, 320, 4000, 48_000, 480_000])
    for t_samples, t_frames in ((480_000, 1499), (4000, 12), (320, 0)):
        want = np.asarray(jax_downsample(jnp.asarray(lengths), t_samples,
                                         t_frames))
        got = downsample_lengths(torch.from_numpy(lengths), t_samples,
                                 t_frames).numpy()
        np.testing.assert_array_equal(got, want)


def test_fairseq_names_round_trip(weights):
    sd = params_from_jax(weights)
    fs = to_fairseq_ctc_state(sd)
    assert "w2v_encoder.w2v_model.encoder.layers.1.fc2.weight" in fs
    assert "w2v_encoder.proj.bias" in fs
    back, ignored = from_fairseq_ctc_state(
        {**fs, "w2v_encoder.w2v_model.quantizer.vars": torch.zeros(1)})
    assert ignored == ["w2v_encoder.w2v_model.quantizer.vars"]
    assert back.keys() == sd.keys()


def test_seeded_init_is_reproducible():
    a = Wav2Vec2AcousticModel(CFG, generator=torch.Generator().manual_seed(3))
    b = Wav2Vec2AcousticModel(CFG, generator=torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.state_dict()["encoder.feature_extractor.conv_layers.1.0.weight"]
    assert w.std() > 0


@pytest.mark.parametrize("field,value", [("fused_attention", "flash")])
def test_unported_features_raise(field, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Wav2Vec2AcousticModel(dataclasses.replace(CFG, **{field: value}))


@pytest.mark.parametrize("field,value", [
    ("pre_norm", True), ("extractor_mode", "layer"), ("conv_bias", True),
    ("pos_conv_depth", 5), ("gated_rel_pos", True),
    ("encoder_type", "conformer"), ("causal_chunk_frames", 8),
    ("packed_qkv", True), ("flash_attention", True), ("moe_experts", 4)])
def test_ported_features_build_and_run(field, value):
    """The topologies that raised before this slice build and give
    finite log-probs of the right shape (their values against JAX:
    ``test_torch_topologies.py``, the MoE FFN's
    ``test_torch_moe_model.py``)."""
    model = Wav2Vec2AcousticModel(dataclasses.replace(CFG, **{field: value}),
                                  generator=torch.Generator().manual_seed(0))
    x, lengths = _batch()
    with torch.inference_mode():
        lp, mask = model(torch.from_numpy(x), torch.from_numpy(lengths))
    assert lp.shape[:2] == mask.shape and lp.shape[2] == CFG.num_labels
    assert torch.isfinite(lp).all()


@pytest.mark.parametrize("topology", [
    dict(gated_rel_pos=True),
    dict(encoder_type="conformer", position_embeddings_type="rotary"),
    dict(encoder_type="conformer", position_embeddings_type="relative")])
def test_inference_then_training_at_one_length(topology):
    """The per-length position tables are cached: a table first built by
    a forward under ``torch.inference_mode`` must still serve a training
    step at the same length, which saves it for backward."""
    from audio8_tpu_torch.nn.conformer import _device_table
    from audio8_tpu_torch.nn.transformer import _bucket_ids

    _bucket_ids.cache_clear()
    _device_table.cache_clear()
    model = Wav2Vec2AcousticModel(dataclasses.replace(CFG, **topology),
                                  generator=torch.Generator().manual_seed(0))
    x, lengths = (torch.from_numpy(a) for a in _batch())
    with torch.inference_mode():
        model(x, lengths)
    lp, mask = model(x, lengths, generator=torch.Generator().manual_seed(1),
                     freeze=False)
    (lp * mask[..., None]).sum().backward()
    grads = {n: p.grad for n, p in model.named_parameters()
             if n.startswith("encoder.encoder.layers.")}
    assert all(g is not None and torch.isfinite(g).all()
               for g in grads.values())
