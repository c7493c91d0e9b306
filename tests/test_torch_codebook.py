"""The quantizer's codebook utilities (``models/wav2vec2.py:
GumbelVectorQuantizer``) against the JAX package's on the same ``vars``,
on the CPU: ``codebook_indices`` and ``to_codebook_index`` equal,
``codebook`` bitwise; ``sample_from_codebook`` draws from a
``torch.Generator`` (JAX's ``jax.random.randint`` stream is not
reproduced), so it is held to its shape, to rows of ``codebook()`` and
to a seeded generator's repeatability."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.models.wav2vec2 import GumbelVectorQuantizer as JaxQuantizer
from audio8_tpu_torch.models.wav2vec2 import GumbelVectorQuantizer
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()


def _pair(num_vars, num_groups, vq_dim=12, input_dim=16):
    jq = JaxQuantizer(input_dim=input_dim, num_vars=num_vars,
                      num_groups=num_groups, vq_dim=vq_dim)
    params = jq.init(jax.random.PRNGKey(num_vars),
                     jnp.zeros((1, 2, input_dim)))["params"]
    q = GumbelVectorQuantizer(input_dim, num_vars, num_groups, vq_dim)
    with torch.no_grad():
        q.vars.copy_(torch.from_numpy(np.asarray(params["vars"])))
    return jq.bind({"params": params}), q


@pytest.mark.parametrize("num_vars,num_groups", [(5, 2), (3, 3), (7, 1)])
def test_codebook_matches_jax(num_vars, num_groups):
    jq, q = _pair(num_vars, num_groups, vq_dim=6 * num_groups)
    np.testing.assert_array_equal(q.codebook_indices().numpy(),
                                  jq.codebook_indices())
    got = q.codebook()
    assert got.shape == (num_vars ** num_groups, 6 * num_groups)
    np.testing.assert_array_equal(got.detach().numpy(),
                                  np.asarray(jq.codebook()))
    idx = np.random.default_rng(0).integers(0, num_vars,
                                            size=(3, 4, num_groups))
    np.testing.assert_array_equal(
        q.to_codebook_index(torch.from_numpy(idx)).numpy(),
        np.asarray(jq.to_codebook_index(jnp.asarray(idx))))
    # the composite index is the row of its codeword in codebook()
    flat = q.to_codebook_index(torch.from_numpy(idx)).reshape(-1)
    rows = q.vars.detach().reshape(num_groups, num_vars, -1)[
        torch.arange(num_groups), torch.from_numpy(idx).reshape(
            -1, num_groups)].reshape(len(flat), -1)
    assert torch.equal(got.detach()[flat], rows)


def test_sample_from_codebook_rows_and_shape():
    _, q = _pair(4, 2)
    table = q.codebook().detach()
    sample = q.sample_from_codebook(3, 5, torch.Generator().manual_seed(1))
    assert sample.shape == (3, 5, 12)
    for row in sample.reshape(-1, 12):
        assert (table == row).all(dim=1).any()
    again = q.sample_from_codebook(3, 5, torch.Generator().manual_seed(1))
    assert torch.equal(sample, again)
    with pytest.raises(ValueError, match="codebook size"):
        q.sample_from_codebook(1, 16, torch.Generator())
