"""The port's host copies of ``ops/align.py`` (word timestamps from the
greedy CTC alignment) and ``ops/vad.py`` (energy VAD) against the JAX
package's on seeded inputs: equal outputs (exact: both are the same
numpy arithmetic)."""
import numpy as np
import pytest

from audio8_tpu.ops import align as jax_align
from audio8_tpu.ops import vad as jax_vad
from audio8_tpu_torch.ops import align, vad
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

I2V = {0: "<s>", 1: "<pad>", 2: "</s>", 3: "<unk>", 4: "|", 5: "E", 6: "T",
       7: "A", 8: "'"}
FX = [(512, 10, 5)] + [(512, 3, 2)] * 4 + [(512, 2, 2)] * 2


def peaky(frames: int, seed: int) -> np.ndarray:
    """(T, V) log-probs with runs of letters, word bars and blanks."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(frames, len(I2V)))
    ids = rng.choice([0, 0, 0, 4, 5, 6, 7, 8, 3], size=frames)
    logits[np.arange(frames), np.repeat(ids[::3], 3)[:frames]] += 6.0
    return logits - np.log(np.exp(logits).sum(-1, keepdims=True))


def test_total_stride():
    assert align.total_stride(FX) == jax_align.total_stride(FX) == 320


@pytest.mark.parametrize("frames", [1, 7, 150])
@pytest.mark.parametrize("seed", [0, 1])
def test_alignment_and_words_equal(frames, seed):
    lp = peaky(frames, seed)
    assert align.greedy_alignment(lp, 0) == \
        jax_align.greedy_alignment(lp, 0)
    ours = align.timestamped_words(lp, I2V, 0, 0.02)
    assert ours == jax_align.timestamped_words(lp, I2V, 0, 0.02)
    assert align.word_timestamps(align.greedy_alignment(lp, 0), I2V,
                                 0.02) == ours


def test_alignment_refuses_non_2d():
    with pytest.raises(ValueError, match="expected"):
        align.greedy_alignment(np.zeros((2, 3, 4)), 0)


def speech_with_gaps(seed: int) -> np.ndarray:
    """Bursts of tone and noise between silences of 0.1-1.5 s."""
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(5):
        parts.append(rng.normal(size=int(rng.uniform(0.1, 1.5) * 16_000))
                     * 1e-3)
        n = int(rng.uniform(0.1, 2.0) * 16_000)
        t = np.arange(n) / 16_000
        parts.append(0.3 * np.sin(2 * np.pi * rng.uniform(100, 800) * t)
                     + 0.05 * rng.normal(size=n))
    return np.concatenate(parts).astype(np.float32)


@pytest.mark.parametrize("wav", [
    speech_with_gaps(0), speech_with_gaps(1), np.zeros(0, np.float32),
    np.ones(16_000, np.float32) * 0.1, np.full(300, 0.2, np.float32)],
    ids=["gaps0", "gaps1", "empty", "flat", "shorter_than_a_window"])
def test_vad_equal(wav):
    np.testing.assert_array_equal(vad.frame_db(wav), jax_vad.frame_db(wav))
    assert vad.speech_segments(wav, 16_000) == \
        jax_vad.speech_segments(wav, 16_000)


def test_vad_options_equal():
    wav = speech_with_gaps(2)
    kw = dict(margin_db=4.0, max_drop_db=30.0, min_speech_sec=0.5,
              min_gap_sec=0.1, pad_sec=0.0)
    segs = vad.speech_segments(wav, 16_000, **kw)
    assert segs == jax_vad.speech_segments(wav, 16_000, **kw)
    assert len(segs) > 1
