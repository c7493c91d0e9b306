"""The encoder topologies in bf16 (f32 params, bf16 compute) against the
JAX package on shared weights: the tiny acoustic model's log-probs on a
ragged batch within 0.1, the bf16 bound of ``test_torch_wav2vec2.py``
(the two packages round at different points; each bf16 model sits a few
1e-2 from its own f32 output). The conv bias after kernel 3's plain
version, the layer-mode norm, WavLM's bias added to bf16 logits, packed
Q/K/V and the conformer's GLU and swish each take JAX's rounding order
(``tests/test_torch_topologies.py`` has the f32 cases).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_threads import cap_torch_threads
from tests.test_torch_topologies import (  # noqa: F401 - a fixture
    TOPOLOGIES, _batch, _jax_acoustic, _port_acoustic, acoustic_weights)

cap_torch_threads()


@pytest.mark.parametrize("name", ["lv60", "data2vec", "wavlm_large",
                                  "conformer_rotary", "conformer_relative",
                                  "packed_qkv_lv60", "causal_chunks"])
def test_acoustic_bf16_matches_jax(acoustic_weights, name):
    topo = TOPOLOGIES[name]
    params = acoustic_weights(topo)
    x, lengths = _batch()
    want, mask = _jax_acoustic(topo, params, x, lengths, jnp.bfloat16)
    model = _port_acoustic(topo, params, torch.bfloat16)
    with torch.inference_mode():
        lp, _ = model(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_allclose(lp.numpy()[mask], want[mask], atol=0.1)
