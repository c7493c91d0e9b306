"""The port's batched device beam search (``ops/beam_device.py``) against
the JAX package's ``ctc_beam_search_jax`` on the CPU.

On the shapes of ``tests/test_beam_jax.py`` and a wider (2, 200, 32)
case at beam 16: identical n-best lists and scores within 1e-5, with the
space symbol and the word bonus, with frame lengths, batch rows
independent of each other, and ``PrefixBeamSearch(device=True).run``
against JAX's ``PrefixBeamSearch(device=True).run``; the port's device
search against its host library search, and a tensor input searched on
its own device. The edges, with n-best lists equal and scores bitwise:
beams wider than the vocabulary (16 and 40 over 8 symbols, 100 over 32
with a word bonus of 5), beam 1, and rows of frame length 0 and 1. Both
packages' ``Offsets`` (the blank is ``GO``) are at their defaults.
"""
import numpy as np
import pytest
import torch

from audio8_tpu.ops.beam import PrefixBeamSearch as JaxPrefixBeamSearch
from audio8_tpu.ops.beam_jax import ctc_beam_search_jax
from audio8_tpu_torch.ops.beam import PrefixBeamSearch
from audio8_tpu_torch.ops.beam_device import backtrace, beam_search, \
    ctc_beam_search
from tests.test_torch_text_lm import default_offsets  # noqa: F401
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

VOCAB = ["<s>", "<pad>", "</s>", "<unk>", "|", "a", "b", "c"]


def _log_probs(seed, b, t, v):
    x = np.random.default_rng(seed).normal(size=(b, t, v)).astype(
        np.float32) * 2.0
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


def _same(got, want):
    (nbest, scores), (j_nbest, j_scores) = got, want
    assert nbest == j_nbest
    np.testing.assert_allclose(scores, j_scores, rtol=0, atol=1e-5)


@pytest.mark.parametrize("b,t,v,beam,space,beta,seed", [
    (4, 40, 8, 6, -1, 0.0, 0),     # test_beam_jax's shapes
    (3, 30, 8, 6, 2, 1.5, 1),      # with the space symbol and the bonus
    (5, 25, 7, 4, -1, 0.0, 3),
    (2, 200, 32, 16, 4, 0.7, 5),   # 32 letters, beam 16
])
def test_nbest_and_scores_match_jax(b, t, v, beam, space, beta, seed):
    lp = _log_probs(seed, b, t, v)
    _same(ctc_beam_search(lp, beam=beam, blank=0, space=space, beta=beta),
          ctc_beam_search_jax(lp, beam=beam, blank=0, space=space,
                              beta=beta))


def test_frame_lengths_match_jax_and_truncation():
    lp = _log_probs(2, 3, 32, 6)
    lengths = np.array([32, 20, 9], np.int32)
    got = ctc_beam_search(lp, lengths, beam=4, blank=0)
    _same(got, ctc_beam_search_jax(lp, lengths, beam=4, blank=0))
    for row in range(3):
        solo, _ = ctc_beam_search(lp[row:row + 1, :lengths[row]], beam=4,
                                  blank=0)
        assert got[0][row] == solo[0]


def test_batch_rows_independent():
    lp = _log_probs(3, 5, 25, 7)
    together, scores = ctc_beam_search(lp, beam=4, blank=0)
    for row in range(5):
        alone, s = ctc_beam_search(lp[row:row + 1], beam=4, blank=0)
        assert together[row] == alone[0]
        np.testing.assert_allclose(scores[row], s[0], atol=1e-6)


def test_blank_not_first_matches_jax():
    """The blank inside the vocabulary (the JAX ``Offsets.GO`` of 1)."""
    lp = _log_probs(6, 2, 30, 8)
    _same(ctc_beam_search(lp, beam=5, blank=1, space=4, beta=0.5),
          ctc_beam_search_jax(lp, beam=5, blank=1, space=4, beta=0.5))


@pytest.mark.parametrize("n_best", [1, 3])
def test_prefix_beam_search_device_matches_jax_and_host(n_best):
    lp = _log_probs(4, 3, 30, len(VOCAB))
    lengths = np.array([30, 22, 15], np.int32)
    dev = PrefixBeamSearch(VOCAB, alpha=0.0, beta=1.0, beam=8, device=True)
    host = PrefixBeamSearch(VOCAB, alpha=0.0, beta=1.0, beam=8)
    jax_dev = JaxPrefixBeamSearch(VOCAB, alpha=0.0, beta=1.0, beam=8,
                                  device=True)
    assert dev.device is True and host.device is False
    got = dev.run(lp, lengths, n_best=n_best)
    assert got == jax_dev.run(lp, lengths, n_best=n_best)
    assert got == host.run(lp, lengths, n_best=n_best)
    ids = dev.run(lp, lengths, n_best=n_best, return_ids=True)
    assert ids == jax_dev.run(lp, lengths, n_best=n_best, return_ids=True)


def test_tensor_input_stays_on_its_device():
    """A tensor is searched where it lies, and ``beam_search`` leaves its
    outputs there."""
    lp = torch.from_numpy(_log_probs(7, 2, 20, len(VOCAB)))
    dev = PrefixBeamSearch(VOCAB, beta=0.0, beam=4, device="cpu")
    assert dev.device == torch.device("cpu")
    assert dev.run(lp, [20, 12], n_best=2) == \
        PrefixBeamSearch(VOCAB, beta=0.0, beam=4).run(lp.numpy(), [20, 12],
                                                      n_best=2)
    parents, tokens, scores = beam_search(lp, torch.tensor([20, 12]),
                                          beam=4)
    assert parents.device == lp.device and scores.shape == (2, 4)
    assert backtrace(parents.numpy(), tokens.numpy())[1] == \
        ctc_beam_search(lp.numpy()[1:, :12], beam=4)[0][0]


@pytest.mark.parametrize("b,t,v,beam,space,beta,seed", [
    (2, 30, 8, 16, -1, 0.0, 7),    # beams wider than the vocabulary
    (2, 30, 8, 40, 2, 0.0, 8),
    (1, 60, 32, 100, 4, 5.0, 9),   # 100 over 32 with a word bonus of 5
    (3, 25, 8, 1, 2, 0.5, 10),     # beam 1
])
def test_wide_and_single_beams_match_jax_bitwise(b, t, v, beam, space, beta,
                                                 seed):
    lp = _log_probs(seed, b, t, v)
    (nbest, scores), (j_nbest, j_scores) = (
        ctc_beam_search(lp, beam=beam, blank=0, space=space, beta=beta),
        ctc_beam_search_jax(lp, beam=beam, blank=0, space=space, beta=beta))
    assert nbest == j_nbest
    np.testing.assert_array_equal(scores, np.asarray(j_scores))


def test_rows_of_length_zero_and_one_match_jax_bitwise():
    lp = _log_probs(11, 3, 20, 8)
    lengths = np.array([0, 1, 20], np.int32)
    (nbest, scores), (j_nbest, j_scores) = (
        ctc_beam_search(lp, lengths, beam=6, blank=0, space=2, beta=0.5),
        ctc_beam_search_jax(lp, lengths, beam=6, blank=0, space=2,
                            beta=0.5))
    assert nbest == j_nbest
    np.testing.assert_array_equal(scores, np.asarray(j_scores))
    assert nbest[0][0] == []  # no frame: the empty hypothesis first
