"""The pretraining model (``Wav2Vec2Model``) of the encoder topologies
against the JAX package on shared weights at the JAX model's mask seed:
the masked-slot context, the targets and the perplexity in evaluation,
within 1e-4 (``tests/test_torch_topologies.py`` has the acoustic model).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.config import PretrainConfig as JaxPretrainConfig
from audio8_tpu.models.wav2vec2 import Wav2Vec2Model as JaxPretrainModel
from audio8_tpu_torch.config import PretrainConfig
from audio8_tpu_torch.models.convert import params_from_jax
from audio8_tpu_torch.models.wav2vec2 import PretrainSeeds, Wav2Vec2Model
from tests.test_torch_threads import cap_torch_threads
from tests.test_torch_topologies import SIZE, TOPOLOGIES, _perturb

cap_torch_threads()


@pytest.mark.parametrize("name", ["lv60", "data2vec", "wavlm_base",
                                  "conformer_relative", "causal_chunks"])
def test_pretrain_model_matches_jax(name):
    """``Wav2Vec2Model`` at the JAX model's mask seed: the masked-slot
    context, the targets and the perplexity in evaluation."""
    from audio8_tpu.ops import hashrand as jax_hashrand

    topo = TOPOLOGIES[name]
    kw = dict(SIZE, num_vq_vars=8, num_vq_groups=2, final_dim=32, dropout=0.0,
              dropout_input=0.0, dropout_features=0.0, **topo)
    jmodel = JaxPretrainModel(config=JaxPretrainConfig(**kw))
    x = np.random.default_rng(3).normal(size=(2, 4000)).astype(np.float32)
    rngs = {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(5)}
    params = _perturb(jax.tree.map(np.asarray, jmodel.init(
        rngs, jnp.asarray(x))["params"]))
    seeds = []
    orig = jax_hashrand.seed_from_key

    def record(key):
        s = orig(key)
        seeds.append(int(np.asarray(s)) & 0xFFFFFFFF)
        return s

    jax_hashrand.seed_from_key = record
    try:
        out_j = jmodel.apply({"params": params}, jnp.asarray(x),
                             rngs={"mask": jax.random.PRNGKey(5)})
    finally:
        jax_hashrand.seed_from_key = orig
    model = Wav2Vec2Model(PretrainConfig(**kw))
    model.load_state_dict(params_from_jax(params), strict=True)
    with torch.inference_mode():
        out = model(torch.from_numpy(x), PretrainSeeds(seeds[0], 0, 0))
    for got, want in zip(out, out_j):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                                   atol=1e-4)
