"""The port's causal text LM against the JAX package's on the CPU.

* ``cli/train_lm.py:pack_token_stream`` gives the JAX blocks bitwise
  (shuffled, and in file order).
* ``CausalTextLM`` (pre-norm rpr stack under the causal mask, the tied
  f32 output) on JAX weights carried by ``params_from_jax``: the
  log-probs and ``sequence_logp`` within 1e-5 in float32 and within 2^-5
  of the largest reference value in bfloat16; a later token changes no
  earlier position's log-probs.

The step trajectories are in ``test_torch_text_lm_steps.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu import utils as jax_utils
from audio8_tpu.cli.train_lm import pack_token_stream as jax_pack
from audio8_tpu.config import TextLMConfig as JaxTextLMConfig
from audio8_tpu.models.text import CausalTextLM as JaxCausalTextLM
from audio8_tpu.models.text import TextVectorizer as JaxVectorizer
from audio8_tpu_torch.cli.train_lm import pack_token_stream
from audio8_tpu_torch.config import TextLMConfig
from audio8_tpu_torch.models.convert import params_from_jax
from audio8_tpu_torch.models.text import CausalTextLM, TextVectorizer
from audio8_tpu_torch.utils import Offsets
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

DEFAULT_OFFSETS = (0, 1, 2, 3, ["<PAD>", "<GO>", "<EOS>", "<UNK>"])


@pytest.fixture(autouse=True)
def default_offsets():
    """Both packages' process-global ``Offsets`` at their defaults for the
    test (an earlier ``cli.test`` in the worker may have remapped either),
    then as they were."""
    registries = (Offsets, jax_utils.Offsets)
    saved = [(o.PAD, o.GO, o.EOS, o.UNK, list(o.VALUES))
             for o in registries]
    for o in registries:
        o.PAD, o.GO, o.EOS, o.UNK = DEFAULT_OFFSETS[:4]
        o.VALUES[:] = DEFAULT_OFFSETS[4]
    yield
    for o, s in zip(registries, saved):
        o.PAD, o.GO, o.EOS, o.UNK = s[:4]
        o.VALUES[:] = s[4]


LETTERS = list("ABCDEFGH") + ["|"]
CFG = dict(vocab_size=4 + len(LETTERS), d_model=32, num_heads=2,
           num_layers=2, d_ff=64, dropout=0.1, rpr_k=4, block_len=16)


def write_text(path, seed: int, lines: int = 30) -> None:
    """Letter transcripts, '|' between words, as ``.ltr`` files hold."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(lines):
            words = ["".join(rng.choice(LETTERS[:-1], size=rng.integers(
                1, 6))) for _ in range(rng.integers(1, 4))]
            f.write(" ".join(" | ".join(" ".join(w) for w in words)) + " |\n")
            if rng.random() < 0.2:
                f.write("\n")  # blank lines are skipped


def vocab():
    return {v: i for i, v in enumerate(["<PAD>", "<GO>", "<EOS>", "<UNK>"]
                                       + LETTERS)}


@pytest.mark.parametrize("shuffle,seed", [(True, 0), (True, 3),
                                          (False, 0)])
def test_pack_token_stream_is_jax_bitwise(tmp_path, shuffle, seed):
    files = [str(tmp_path / "a.ltr"), str(tmp_path / "b.ltr")]
    write_text(files[0], 1)
    write_text(files[1], 2, lines=7)
    got = pack_token_stream(files, TextVectorizer(vocab()), 16, seed,
                            shuffle=shuffle)
    want = jax_pack(files, JaxVectorizer(vocab()), 16, seed,
                    shuffle=shuffle)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def jax_lm(dtype=jnp.float32):
    model = JaxCausalTextLM(config=JaxTextLMConfig(**CFG), dtype=dtype)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 16), jnp.int32))["params"]
    return model, jax.tree.map(np.asarray, params)


def port_lm(params, dtype=torch.float32):
    model = CausalTextLM(TextLMConfig(**CFG), dtype)
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def ids_and_lengths(seed: int):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, CFG["vocab_size"], size=(3, 13)).astype(np.int32)
    ids[:, 0] = 1  # GO
    lengths = np.array([13, 9, 4], np.int32)
    ids[np.arange(13)[None, :] >= lengths[:, None]] = 0  # PAD
    return ids, lengths


@pytest.mark.parametrize("jdt,tdt,tol", [
    (jnp.float32, torch.float32, 1e-5),
    (jnp.bfloat16, torch.bfloat16, 2.0 ** -5),
])
def test_forward_and_sequence_logp_match_jax(jdt, tdt, tol):
    jmodel, params = jax_lm(jdt)
    model = port_lm(params, tdt)
    ids, lengths = ids_and_lengths(1)
    want = np.asarray(jax.jit(lambda p, x: jmodel.apply({"params": p}, x))(
        params, jnp.asarray(ids)))
    want_seq = np.asarray(jax.jit(lambda p, x, n: jmodel.apply(
        {"params": p}, x, n, method=jmodel.sequence_logp))(
            params, jnp.asarray(ids), jnp.asarray(lengths)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
        got_seq = model.sequence_logp(torch.from_numpy(ids),
                                      torch.from_numpy(lengths)).numpy()
    assert got.dtype == np.float32
    scale = max(1.0, float(np.abs(want).max())) if tdt == torch.bfloat16 \
        else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)
    scale_seq = max(1.0, float(np.abs(want_seq).max()))
    np.testing.assert_allclose(got_seq, want_seq, rtol=0,
                               atol=tol * scale_seq)


def test_causal():
    _, params = jax_lm()
    model = port_lm(params)
    ids, _ = ids_and_lengths(2)
    other = ids.copy()
    other[:, 7:] = (other[:, 7:] + 1) % CFG["vocab_size"]
    with torch.no_grad():
        a = model(torch.from_numpy(ids))
        b = model(torch.from_numpy(other))
    assert torch.equal(a[:, :7], b[:, :7])
    assert not torch.equal(a[:, 7:], b[:, 7:])
