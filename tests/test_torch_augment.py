"""Training-set augmentation (``--speed_perturb``, ``--noise_manifest``)
against the JAX package, on the CPU.

* ``speed_perturb_wav`` equals JAX's bitwise at factors 0.9, 1.0, 1.1
  and 0.85 (a rational approximation with denominator 20).
* ``NoiseMixer`` over a directory and over a manifest equals JAX's on the
  same wave and ``default_rng`` seed, bitwise: noise shorter than the
  utterance (tiled), longer (cropped at a drawn offset), a silent clip,
  and ``prob`` < 1.
* The dataset's padded batches with both augmentations equal JAX's
  ``AudioTextLetterDataset`` for the same manifest and seed, past one
  epoch, read directly and through ``PrefetchLoader`` with 1 and 3
  worker threads.
"""
import numpy as np
import pytest
from scipy.io import wavfile

from audio8_tpu.data import audio as jax_audio
from audio8_tpu.data.datasets import AudioTextLetterDataset as JaxDataset
from audio8_tpu.models.text import TextVectorizer as JaxVectorizer
from audio8_tpu_torch.data import audio
from audio8_tpu_torch.data.datasets import (AudioTextLetterDataset,
                                            PrefetchLoader)
from audio8_tpu_torch.models.text import TextVectorizer, read_vocab_list
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

LETTERS = ["|", "A", "B", "C", "D"]


def _wave(seed, n):
    return (np.random.default_rng(seed).normal(size=n) * 0.1).astype(
        np.float32)


@pytest.mark.parametrize("factor", [0.9, 1.0, 1.1, 0.85])
def test_speed_perturb_matches_jax(factor):
    wav = _wave(0, 7919)
    got = audio.speed_perturb_wav(wav, factor)
    assert got.dtype == np.float32
    assert abs(len(got) - len(wav) / factor) <= 1
    np.testing.assert_array_equal(got, jax_audio.speed_perturb_wav(wav,
                                                                   factor))


@pytest.fixture
def noise_dir(tmp_path):
    d = tmp_path / "noise"
    d.mkdir()
    rng = np.random.default_rng(1)
    for name, n, amp in (("short.wav", 900, 3000), ("long.wav", 40000, 800),
                         ("silent.wav", 500, 0)):
        wavfile.write(str(d / name), 16000,
                      (rng.normal(size=n) * amp).astype(np.int16))
    (d / "notes.txt").write_text("not audio")
    with open(tmp_path / "noise.tsv", "w") as f:
        f.write(str(d) + "\n")
        for name in ("short.wav", "long.wav"):
            f.write(f"{name}\t0\n")
    return tmp_path


@pytest.mark.parametrize("source", ["noise", "noise.tsv"])
@pytest.mark.parametrize("prob", [1.0, 0.5])
def test_noise_mixer_matches_jax(noise_dir, source, prob):
    path = str(noise_dir / source)
    ours = audio.NoiseMixer(path, snr_db=(0.0, 10.0), prob=prob)
    theirs = jax_audio.NoiseMixer(path, snr_db=(0.0, 10.0), prob=prob)
    assert ours.files == theirs.files
    changed = 0
    for seed in range(12):
        wav = _wave(seed, 3000 + 700 * seed)
        got = ours(wav, np.random.default_rng(seed))
        want = theirs(wav, np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)
        assert len(got) == len(wav)
        changed += not np.array_equal(got, wav)
    assert 0 < changed < 12 or (changed == 12 and prob == 1.0
                                and source == "noise.tsv")


def test_noise_mixer_refuses_an_empty_source(tmp_path):
    with pytest.raises(ValueError, match="no noise files"):
        audio.NoiseMixer(str(tmp_path))


@pytest.fixture
def corpus(noise_dir):
    rng = np.random.default_rng(0)
    root = noise_dir
    (root / "dict.ltr.txt").write_text("".join(f"{c} 1\n" for c in LETTERS))
    with open(root / "train.tsv", "w") as tf, \
            open(root / "train.ltr", "w") as lf:
        tf.write(str(root) + "\n")
        for i in range(11):
            n = int(rng.integers(3000, 20000))
            wavfile.write(str(root / f"{i}.wav"), 16000,
                          (rng.normal(size=n) * 3000).astype(np.int16))
            tf.write(f"{i}.wav\t{n}\n")
            lf.write(" ".join(rng.choice(LETTERS, size=int(rng.integers(
                1, 9)))) + " |\n")
    return root


@pytest.mark.parametrize("workers", [0, 1, 3])
def test_augmented_batches_match_jax(corpus, workers):
    vocab = {v: i for i, v in enumerate(read_vocab_list(
        str(corpus / "dict.ltr.txt")))}
    noise = str(corpus / "noise")
    kw = dict(pad_to_multiple=4000, text_pad_multiple=8, seed=3,
              read_workers=2, speed_perturb=(0.9, 1.0, 1.1))
    tsv = str(corpus / "train.tsv")
    theirs = iter(JaxDataset(tsv, JaxVectorizer(vocab), 40000,
                             lane_align=False,
                             noise_mixer=jax_audio.NoiseMixer(noise), **kw))
    dataset = AudioTextLetterDataset(tsv, TextVectorizer(vocab), 40000,
                                     noise_mixer=audio.NoiseMixer(noise),
                                     **kw)
    ours = iter(PrefetchLoader(dataset, num_workers=workers, prefetch=2)
                if workers else dataset)
    sizes = dict(zip(dataset.files, dataset.sizes))
    stretched = 0
    for _ in range(9):  # past one epoch: the reshuffle must match too
        a, b = next(ours), next(theirs)
        assert a["files"] == b["files"] and a["num_real"] == b["num_real"]
        for k in ("signal", "signal_lengths", "token_ids", "token_lengths"):
            assert np.array_equal(a[k], b[k]), k
        stretched += sum(int(a["signal_lengths"][i] != sizes[f])
                         for i, f in enumerate(a["files"]))
    assert stretched > 0  # some rows were read at another speed
    if workers:
        ours.close()
