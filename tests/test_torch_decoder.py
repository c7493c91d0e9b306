"""The port's attention cases beyond the encoder's, its decoder and its
``Seq2Seq`` against the JAX package on the CPU, on shared weights and
seeded numpy inputs.

* ``MultiHeadAttention`` under a causal mask, as cross attention
  (T_q != T_k, key-validity mask), with ``rpr_k`` on and off and with
  ``rpr_value_on``, through the KV cache, and ``compute_kv`` +
  ``attend_kv``: float32 within 1e-5 of max(1, max|ref|), bfloat16
  within 2^-5 (``BF16_BOUND`` of ``test_torch_xla_attention.py``: both
  sides round the projections, logits, probabilities and output, at
  points that differ by summation order);
* the composition's attention-probability dropout: the flat (B, H, T_q,
  T_k) hash keep mask equals JAX's ``_hash_keep_mask`` bit for bit, and
  the module fed JAX's recorded seed gives JAX's output;
* the decoder's cached ``step`` rows equal its teacher-forced rows
  (1e-5), on both sides;
* ``Seq2Seq``: the teacher-forced log-probs (f32 1e-4, bf16 2^-5 of
  max(1, max|ref|)), and the greedy and beam tokens equal to JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio8_tpu.nn.dropout as jax_dropout
from audio8_tpu.config import DecoderConfig as JaxDecoderConfig
from audio8_tpu.config import EncoderConfig as JaxEncoderConfig
from audio8_tpu.models.seq2seq import Seq2Seq as JaxSeq2Seq
from audio8_tpu.nn.transformer import MultiHeadAttention as JaxMHA
from audio8_tpu.nn.transformer import subsequent_mask as jax_subsequent
from audio8_tpu.ops.masks import sequence_mask as jax_sequence_mask
from audio8_tpu.utils import Offsets as JaxOffsets
from audio8_tpu_torch.config import DecoderConfig, EncoderConfig
from audio8_tpu_torch.models.convert import (_by_name_assignments,
                                             params_from_jax)
from audio8_tpu_torch.models.seq2seq import Seq2Seq, top_k_stable
from audio8_tpu_torch.models.text import sequence_mask
from audio8_tpu_torch.nn.transformer import (MultiHeadAttention,
                                             subsequent_mask)
from audio8_tpu_torch.ops.dropout import hash_keep_mask
from audio8_tpu_torch.ops.hashrand import MASK32, SeedReplay
from audio8_tpu_torch.utils import Offsets
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

TOL = 1e-5
BF16_BOUND = 2.0 ** -5
FX = ((32, 10, 5), (32, 3, 2))
V = 12
ENC = dict(d_model=32, num_heads=2, num_layers=1, d_ff=64,
           custom_conv_features=FX, dropout=0.0, timestep_masking=0.0,
           channel_masking=0.0)
DEC = dict(vocab_size=V, d_model=32, num_heads=2, num_layers=2, d_ff=64,
           dropout=0.0, max_len=64)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _fairseq_offsets():
    saved = (Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK,
             list(Offsets.VALUES))
    Offsets.remap_fairseq_ctc()
    JaxOffsets.remap_fairseq_ctc()
    yield
    Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK = saved[:4]
    Offsets.VALUES[:] = saved[4]


def load_by_name(module: torch.nn.Module, params) -> None:
    """A JAX subtree into a port module that carries the JAX names."""
    state = {}
    for path, key, tf in _by_name_assignments(params, (), ""):
        node = params
        for p in path:
            node = node[p]
        state[key] = torch.from_numpy(np.array(tf(np.asarray(node,
                                                             np.float32))))
    module.load_state_dict(state, strict=True)


def assert_close(got, want, dt):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    bound = (TOL if dt == "f32" else BF16_BOUND) * max(1.0,
                                                      np.abs(want).max())
    assert np.abs(got - want).max() <= bound, np.abs(got - want).max()


CASES = {
    "causal": dict(t_k=None, mask="causal"),
    "cross": dict(t_k=11, mask="keys"),
    "rpr": dict(t_k=None, mask="keys", rpr_k=3),
    "rpr_causal": dict(t_k=None, mask="causal", rpr_k=2),
    "rpr_value": dict(t_k=None, mask="keys", rpr_k=3, rpr_value_on=True),
}


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_mha_cases_match_jax(case, dt):
    c = CASES[case]
    rng = np.random.default_rng(3)
    t_q = 9
    t_k = c["t_k"] or t_q
    x = rng.normal(size=(2, t_q, 32)).astype(np.float32)
    mem = rng.normal(size=(2, t_k, 32)).astype(np.float32)
    kv = x if c["t_k"] is None else mem
    lengths = np.array([t_k, t_k - 4])
    if c["mask"] == "causal":
        jmask, tmask = jax_subsequent(t_q), subsequent_mask(t_q)
    else:
        valid = np.arange(t_k)[None, :] < lengths[:, None]
        jmask = jnp.asarray(valid)[:, None, None, :]
        tmask = torch.from_numpy(valid)[:, None, None, :]
    jdt, tdt = DTYPES[dt]
    extra = {k: c[k] for k in ("rpr_k", "rpr_value_on") if k in c}
    jm = JaxMHA(num_heads=2, d_model=32, dtype=jdt, **extra)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1), x, kv,
                                              kv, jmask)["params"])
    want = jm.apply({"params": params}, x, kv, kv, jmask)
    tm = MultiHeadAttention(2, 32, tdt, names="jax", **extra)
    load_by_name(tm, params)
    with torch.no_grad():
        key = None if c["t_k"] is None else torch.from_numpy(mem)
        got = tm(torch.from_numpy(x), key=key, value=key, mask=tmask)
    assert_close(got, want, dt)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_attend_kv_and_cache_match_jax(dt):
    """``compute_kv`` + ``attend_kv`` (f32 softmax) and one cached
    self-attention call at cache_index 3 of a (B, H, 8, dh) cache."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 1, 32)).astype(np.float32)
    mem = rng.normal(size=(2, 7, 32)).astype(np.float32)
    valid = np.arange(7)[None, :] < np.array([7, 4])[:, None]
    jdt, tdt = DTYPES[dt]
    jm = JaxMHA(num_heads=2, d_model=32, dtype=jdt)
    params = jax.tree.map(np.asarray,
                          jm.init(jax.random.PRNGKey(2), x, x, x)["params"])
    tm = MultiHeadAttention(2, 32, tdt, names="jax")
    load_by_name(tm, params)
    jmask = jnp.asarray(valid)[:, None, None, :]
    jk, jv = jm.apply({"params": params}, mem, mem, method=JaxMHA.compute_kv)
    want = jm.apply({"params": params}, x, jk, jv, jmask,
                    method=JaxMHA.attend_kv)
    with torch.no_grad():
        tk, tv = tm.compute_kv(torch.from_numpy(mem), torch.from_numpy(mem))
        got = tm.attend_kv(torch.from_numpy(x), tk, tv,
                           torch.from_numpy(valid)[:, None, None, :])
    assert_close(got, want, dt)

    cache = rng.normal(size=(2, 2, 2, 8, 16)).astype(np.float32)
    jcache = {"k": jnp.asarray(cache[0], jdt), "v": jnp.asarray(cache[1], jdt)}
    want, jc = jm.apply({"params": params}, x, x, x, None, True, jcache, 3)
    tcache = {"k": torch.from_numpy(cache[0]).to(tdt),
              "v": torch.from_numpy(cache[1]).to(tdt)}
    with torch.no_grad():
        got, tc = tm(torch.from_numpy(x), cache=tcache, cache_index=3)
    assert_close(got, want, dt)
    assert_close(tc["k"], jc["k"], dt)


def test_flat_dropout_mask_matches_jax_bitwise(monkeypatch):
    """The composition drops the probabilities with the JAX ``Dropout``'s
    flat hash mask: the keep mask over (B, H, T_q, T_k) is JAX's bit for
    bit, and the module fed the recorded seed gives JAX's output."""
    shape, rate = (2, 2, 9, 11), 0.1
    for seed in (0, 7, 2 ** 31 + 5):
        want = np.asarray(jax_dropout._hash_keep_mask(
            shape, rate, jnp.asarray(seed, jnp.uint32)))
        got = hash_keep_mask(shape, rate, seed).numpy()
        assert (want == got).all()

    seeds = []
    real = jax_dropout._hash_dropout

    def recording(x, r, seed):
        seeds.append(int(np.asarray(seed)) & MASK32)
        return real(x, r, seed)

    monkeypatch.setattr(jax_dropout, "_hash_dropout", recording)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 9, 32)).astype(np.float32)
    mem = rng.normal(size=(2, 11, 32)).astype(np.float32)
    jm = JaxMHA(num_heads=2, d_model=32, dropout_rate=rate)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3), x, mem,
                                              mem)["params"])
    want = jm.apply({"params": params}, x, mem, mem, None, False,
                    rngs={"dropout": jax.random.PRNGKey(9)})
    assert len(seeds) == 1
    tm = MultiHeadAttention(2, 32, dropout_rate=rate, names="jax")
    load_by_name(tm, params)
    replay = SeedReplay(seeds)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), None, replay,
                 key=torch.from_numpy(mem), value=torch.from_numpy(mem))
    assert replay.remaining == 0
    assert_close(got, want, "f32")


def _batch(seed):
    rng = np.random.default_rng(seed)
    sig = rng.normal(size=(3, 2400)).astype(np.float32)
    sl = np.array([2400, 1800, 1000], np.int32)
    ids = rng.integers(4, V, size=(3, 6)).astype(np.int32)
    ids[:, 0] = Offsets.GO
    tl = np.array([6, 4, 2], np.int32)
    ids[np.arange(6)[None, :] >= tl[:, None]] = Offsets.PAD
    return sig, sl, ids, tl


@pytest.fixture(scope="module")
def seq2seq_models():
    """JAX and port models of each dtype on one JAX init (a module
    fixture: it must leave both packages' ``Offsets`` as it found them,
    since the per-test restores run inside it)."""
    sig, sl, ids, tl = _batch(0)
    out = {}
    for dt, (jdt, tdt) in DTYPES.items():
        jm = JaxSeq2Seq(encoder_config=JaxEncoderConfig(**ENC),
                        decoder_config=JaxDecoderConfig(**DEC), dtype=jdt)
        if "params" not in out:
            out["params"] = jax.tree.map(np.asarray, jm.init(
                jax.random.PRNGKey(0), sig, sl, ids, tl)["params"])
        tm = Seq2Seq(EncoderConfig(**ENC), DecoderConfig(**DEC), tdt)
        tm.load_state_dict(params_from_jax(out["params"]), strict=True)
        out[dt] = (jm, tm)
    return out


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_seq2seq_forward_matches_jax(seq2seq_models, dt):
    jm, tm = seq2seq_models[dt]
    sig, sl, ids, tl = _batch(1)
    want = jm.apply({"params": seq2seq_models["params"]}, sig, sl, ids, tl)
    with torch.no_grad():
        got = tm(torch.from_numpy(sig), torch.from_numpy(sl),
                 torch.from_numpy(ids), torch.from_numpy(tl))
    assert_close(got, want, "f32" if dt == "f32" else "bf16")
    assert got.dtype == torch.float32


def test_cached_step_equals_teacher_forced(seq2seq_models):
    """The decoder's KV-cached steps give the teacher-forced rows, on
    both sides, over one memory (cross K/V projected once)."""
    jm, tm = seq2seq_models["f32"]
    params = {"params": seq2seq_models["params"]}
    sig, sl, ids, _ = _batch(2)
    t = ids.shape[1]
    full = np.ones((3, t), bool)
    mem, pad = jm.apply(params, sig, sl, False,
                        method=lambda m, x, l, tr: m.encoder(x, l, tr))
    jfull = jm.apply(params, mem, pad, ids, jnp.asarray(full),
                     method=lambda m, *a: m.decoder(*a))
    with torch.no_grad():
        tmem, tpad = tm.encoder(torch.from_numpy(sig), torch.from_numpy(sl))
        tfull = tm.decoder(tmem, tpad, torch.from_numpy(ids),
                           torch.from_numpy(full))
        assert_close(tfull, jfull, "f32")
        cross = tm.decoder.compute_cross_kv(tmem)
        cache = tm.decoder.init_cache(3, t)
        for i in range(t):
            lp, cache = tm.decoder.step(tmem, tpad,
                                        torch.from_numpy(ids[:, i:i + 1]),
                                        cache, cross)
            assert_close(lp, jfull[:, i], "f32")
    assert cache["index"] == t


def test_decode_tokens_match_jax(seq2seq_models):
    """Greedy and beam-3 tokens and lengths equal JAX's (f32)."""
    jm, tm = seq2seq_models["f32"]
    params = {"params": seq2seq_models["params"]}
    sig, sl, _, _ = _batch(3)
    ts, tl = torch.from_numpy(sig), torch.from_numpy(sl)
    jt, jl = jm.apply(params, sig, sl, 12, method=JaxSeq2Seq.decode)
    t, l = tm.decode(ts, tl, 12)
    assert (np.asarray(jt) == t.numpy()).all()
    assert (np.asarray(jl) == l.numpy()).all()
    for beam in (2, 3):
        jt, jl = jm.apply(params, sig, sl, beam, 12,
                          method=JaxSeq2Seq.decode_beam)
        t, l = tm.decode_beam(ts, tl, beam, 12)
        assert (np.asarray(jt) == t.numpy()).all()
        assert (np.asarray(jl) == l.numpy()).all()


def test_top_k_breaks_ties_as_jax():
    x = np.array([[1.0, 3.0, 3.0, 0.5, 3.0, 2.0],
                  [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 4)
    tv, ti = top_k_stable(torch.from_numpy(x), 4)
    assert (np.asarray(ji) == ti.numpy()).all()
    assert (np.asarray(jv) == tv.numpy()).all()


def test_sequence_mask_matches_jax():
    lengths = np.array([0, 3, 5])
    want = np.asarray(jax_sequence_mask(jnp.asarray(lengths), 5))
    assert (sequence_mask(torch.from_numpy(lengths), 5).numpy() == want).all()
