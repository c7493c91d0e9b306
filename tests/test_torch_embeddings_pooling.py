"""The port's embeddings and reductions against the JAX package's on the
CPU, on shared weights and seeded numpy inputs.

* every ``Reduction`` type (``2ha``, ``2ha_max``, ``2ha_mean``, ``sha``,
  ``sha_max``, ``sha_mean``, ``max``, ``mean``, ``none``) in float32
  (within 1e-5 of max(1, max|ref|)) and bfloat16 (within 2^-5 of it:
  the attention types round the projections, probabilities and output
  at points that differ by summation order), over rows padded to
  different lengths, and the reductions' dropout with JAX's seeds;
* ``LookupTableEmbeddings``, ``LearnedPositionalEmbeddings`` (with an
  offset), their tied ``attend`` and ``WeightTieDense``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio8_tpu.nn.dropout as jax_dropout
from audio8_tpu.nn import embeddings as jax_emb
from audio8_tpu.nn.pooling import Reduction as JaxReduction
from audio8_tpu_torch.nn import embeddings
from audio8_tpu_torch.nn.pooling import Reduction, make_reduction
from audio8_tpu_torch.ops.hashrand import MASK32, SeedReplay

from tests.test_torch_decoder import assert_close, load_by_name
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

TYPES = ("2ha", "2ha_max", "2ha_mean", "sha", "sha_max", "sha_mean", "max",
         "mean", "none")
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 7, 16)).astype(np.float32)
    valid = np.arange(7)[None, :] < np.array([7, 4, 1])[:, None]
    return x, valid


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("rt", TYPES)
def test_reduction_matches_jax(rt, dt):
    jdt, tdt = DTYPES[dt]
    x, valid = _inputs(1)
    jx = jnp.asarray(x, jdt)
    jm = JaxReduction(reduction_type=rt, d_model=16, d_k=8, dtype=jdt)
    variables = jm.init(jax.random.PRNGKey(0), jx, jnp.asarray(valid))
    params = jax.tree.map(np.asarray, dict(variables.get("params", {})))
    want = jm.apply({"params": params}, jx, jnp.asarray(valid))
    tm = Reduction(rt, 16, 8, dtype=tdt)
    load_by_name(tm, params)
    tx = torch.from_numpy(x).to(tdt)
    with torch.no_grad():
        got = tm(tx, torch.from_numpy(valid))
    if rt == "none":
        assert got[0] is tx and (got[1].numpy() == valid).all()
        return
    assert got.dtype == tdt and got.shape == (3, 16)
    assert_close(got, want, dt)


@pytest.mark.parametrize("rt", ["2ha", "sha_mean"])
def test_reduction_dropout_matches_jax(rt, monkeypatch):
    """The attention reductions drop their probabilities with one seed
    per head, drawn in JAX's order."""
    seeds = []
    real = jax_dropout._hash_dropout

    def recording(x, rate, seed):
        seeds.append(int(np.asarray(seed)) & MASK32)
        return real(x, rate, seed)

    monkeypatch.setattr(jax_dropout, "_hash_dropout", recording)
    x, valid = _inputs(2)
    jm = JaxReduction(reduction_type=rt, d_model=16, d_k=8,
                      dropout_rate=0.2)
    params = jax.tree.map(np.asarray, dict(jm.init(
        jax.random.PRNGKey(0), x, jnp.asarray(valid))["params"]))
    want = jm.apply({"params": params}, x, jnp.asarray(valid), False,
                    rngs={"dropout": jax.random.PRNGKey(3)})
    tm = make_reduction(rt, 16, 8, dropout_rate=0.2)
    load_by_name(tm, params)
    replay = SeedReplay(seeds)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(valid), replay)
    assert replay.remaining == 0 and len(seeds) == (2 if rt == "2ha" else 1)
    assert_close(got, want, "f32")


def test_reduction_refuses_unknown_type():
    with pytest.raises(ValueError, match="Unknown reduction"):
        Reduction("3ha", 16)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_embeddings_match_jax(dt):
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 11, size=(2, 5)).astype(np.int32)
    jl = jax_emb.LearnedPositionalEmbeddings(vocab_size=11, features=8,
                                             max_len=16, dtype=jdt)
    params = jax.tree.map(np.asarray, dict(
        jl.init(jax.random.PRNGKey(0), ids)["params"]))
    tl = embeddings.LearnedPositionalEmbeddings(11, 8, 16, tdt)
    load_by_name(tl, params)
    tids = torch.from_numpy(ids)
    for offset in (0, 3):
        want = jl.apply({"params": params}, ids, offset)
        assert_close(tl(tids, offset), want, dt)
    x = rng.normal(size=(2, 5, 8)).astype(np.float32)
    want = jl.apply({"params": params}, jnp.asarray(x, jdt),
                    method=jax_emb.LearnedPositionalEmbeddings.attend)
    got = tl.attend(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    assert_close(got, want, dt)
    table = params["word"]["embedding"]
    want = jax_emb.WeightTieDense().apply({}, jnp.asarray(x, jdt), table)
    got = embeddings.WeightTieDense()(torch.from_numpy(x).to(tdt),
                                      torch.from_numpy(np.array(table)))
    assert_close(got, want, dt)

    jt = jax_emb.LookupTableEmbeddings(vocab_size=11, features=8, dtype=jdt)
    params = jax.tree.map(np.asarray, dict(
        jt.init(jax.random.PRNGKey(1), ids)["params"]))
    tt = embeddings.LookupTableEmbeddings(11, 8, tdt)
    load_by_name(tt, params)
    got = tt(tids)
    assert got.dtype == tdt
    assert_close(got, jt.apply({"params": params}, ids), dt)
