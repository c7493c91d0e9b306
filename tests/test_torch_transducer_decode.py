"""The port's RNN-T decode loops against the JAX ``Transducer``'s on the
CPU, on ``test_torch_transducer_model.py``'s weights and inputs, the JAX
decodes jitted:

* greedy and timed decode tokens, frames and lengths equal to JAX's,
  log-posteriors at 1e-4; ``decode_frames`` over windows equal to one
  whole run;
* ``decode_beam`` tokens and lengths equal to JAX's, scores within 1e-4
  relative, and a beam of 1 equal to greedy.
"""
import jax
import numpy as np
import pytest
import torch

from audio8_tpu.config import TransducerConfig as JaxConfig
from audio8_tpu.models.transducer import Transducer as JaxTransducer
from audio8_tpu.utils import Offsets as JaxOffsets
from audio8_tpu_torch.utils import Offsets
from tests.test_torch_threads import cap_torch_threads
from tests.test_torch_transducer_model import (CFG, LENGTHS, MAX_LEN,
                                               MAX_SYM, _both, _inputs,
                                               _fairseq_offsets, params)

cap_torch_threads()
__all__ = ["_fairseq_offsets", "params"]  # the fixtures this file uses


@pytest.fixture(scope="module")
def jax_decodes(params):
    JaxOffsets.remap_fairseq_ctc()
    jmodel = JaxTransducer(config=JaxConfig(**CFG))
    x, _ = _inputs()
    greedy = jax.jit(lambda p, x, n: jmodel.apply(
        {"params": p}, x, n, MAX_LEN, MAX_SYM, True,
        method=JaxTransducer.decode))(params, x, LENGTHS)
    beam = jax.jit(lambda p, x, n: jmodel.apply(
        {"params": p}, x, n, 4, MAX_LEN, MAX_SYM,
        method=JaxTransducer.decode_beam))(params, x, LENGTHS)
    return [np.asarray(a) for a in greedy], [np.asarray(a) for a in beam]


def test_greedy_and_timed_decode_match_jax(params, jax_decodes):
    _, model = _both(params)
    x, _ = _inputs()
    args = (torch.from_numpy(x), torch.from_numpy(LENGTHS), MAX_LEN,
            MAX_SYM)
    toks, n, times, lps = model.decode(*args, timed=True)
    j_toks, j_n, j_times, j_lps = jax_decodes[0]
    assert np.array_equal(n.numpy(), j_n)
    assert 0 < j_n.min() < MAX_LEN  # blanks and labels both occur
    assert np.array_equal(toks.numpy(), j_toks)
    assert np.array_equal(times.numpy(), j_times)
    np.testing.assert_allclose(lps.numpy(), j_lps, rtol=1e-4, atol=1e-5)
    plain = model.decode(*args)
    assert torch.equal(plain[0], toks) and torch.equal(plain[1], n)


def test_windowed_decode_frames_equal_whole(params):
    _, model = _both(params)
    x, _ = _inputs()
    with torch.no_grad():
        enc, frames = model.encode(torch.from_numpy(x),
                                   torch.from_numpy(LENGTHS))
        whole = model.decode_frames(
            enc, frames, torch.full((3, MAX_LEN), Offsets.PAD,
                                    dtype=torch.int32),
            torch.zeros(3, dtype=torch.int32), *model.decode_init(3),
            MAX_SYM)
        state = (torch.full((3, MAX_LEN), Offsets.PAD, dtype=torch.int32),
                 torch.zeros(3, dtype=torch.int32), *model.decode_init(3))
        w = 5
        for t0 in range(0, enc.shape[1], w):
            win = enc[:, t0:t0 + w]
            state = model.decode_frames(
                win, torch.clamp(frames - t0, 0, win.shape[1]), *state,
                MAX_SYM)
    assert torch.equal(state[0], whole[0]) and torch.equal(state[1],
                                                           whole[1])
    torch.testing.assert_close(state[2], whole[2], rtol=0, atol=0)


def test_beam_matches_jax_and_beam_one_is_greedy(params, jax_decodes):
    _, model = _both(params)
    x, _ = _inputs()
    toks, n, scores = model.decode_beam(torch.from_numpy(x),
                                        torch.from_numpy(LENGTHS), 4,
                                        MAX_LEN, MAX_SYM)
    j_toks, j_n, j_scores = jax_decodes[1]
    assert np.array_equal(n.numpy(), j_n)
    assert np.array_equal(toks.numpy(), j_toks)
    np.testing.assert_allclose(scores.numpy(), j_scores, rtol=1e-4)
    assert len({tuple(r[:k]) for r, k in zip(j_toks[0], j_n[0])}) == 4
    g_toks, g_n = model.decode(torch.from_numpy(x),
                               torch.from_numpy(LENGTHS), MAX_LEN, MAX_SYM)
    b_toks, b_n, _ = model.decode_beam(torch.from_numpy(x),
                                       torch.from_numpy(LENGTHS), 1,
                                       MAX_LEN, MAX_SYM)
    assert torch.equal(b_n[:, 0], g_n) and torch.equal(b_toks[:, 0], g_toks)


@pytest.mark.parametrize("mul", [1000003, 2654435761])
def test_rolling_hashes_wrap_as_uint32(mul):
    """The beam search's rolling hashes in int64 equal JAX's uint32
    products with wraparound (the sort order and the run heads hang on
    them)."""
    from audio8_tpu_torch.ops.hashrand import MASK32, mul32

    x = np.random.default_rng(mul).integers(0, 2 ** 32, size=4096,
                                            dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jax.numpy.asarray(x) * jax.numpy.uint32(mul) + 7)
    got = (mul32(torch.from_numpy(x.astype(np.int64)), mul) + 7) & MASK32
    assert np.array_equal(got.numpy().astype(np.uint32), want)
