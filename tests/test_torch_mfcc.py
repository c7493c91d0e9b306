"""HuBERT's target pipeline in the port against the JAX package on the CPU.

* ``data/mfcc.py``: ``mfcc``, ``kmeans`` (k-means++ seeding, Lloyd steps,
  empty clusters re-seeded at the worst-fit point) and
  ``assign_clusters`` (past one 65 536-row chunk) give the JAX package's
  arrays bit for bit, clips shorter than a window included.
* A clip's MFCC frame count is the conv stack's output length, and the
  port's HuBERT model gives that many frames for it, so a ``.km`` written
  on the MFCC grid matches T' for every clip length.
* ``AudioTextLetterDataset(tgt_type=TGT_KM)`` reads the ``.km`` ids and
  pads them -1, yielding the JAX dataset's batches.
"""
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from audio8_tpu.data import mfcc as jax_mfcc
from audio8_tpu.data.datasets import AudioTextLetterDataset as JaxDataset
from audio8_tpu_torch.config import (CONV_FEATURES, HubertPretrainConfig,
                                     conv_output_length)
from audio8_tpu_torch.data import mfcc
from audio8_tpu_torch.data.datasets import AudioTextLetterDataset
from audio8_tpu_torch.models.hubert import HubertPretrainModel, HubertSeeds
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

LENGTHS = (0, 1, 399, 400, 401, 719, 720, 4000, 16_000, 41_359)


@pytest.mark.parametrize("n", LENGTHS)
def test_mfcc_bitwise(n):
    x = np.random.default_rng(n).normal(size=n).astype(np.float32)
    got, want = mfcc.mfcc(x), jax_mfcc.mfcc(x)
    assert got.dtype == want.dtype == np.float32
    frames = max(conv_output_length(n, CONV_FEATURES[16]), 0)
    assert got.shape == want.shape == (frames, 39)
    assert np.array_equal(got, want)
    plain = mfcc.mfcc(x, with_deltas=False, n_mfcc=20, n_mels=40)
    assert np.array_equal(plain, jax_mfcc.mfcc(x, with_deltas=False,
                                               n_mfcc=20, n_mels=40))


@pytest.mark.parametrize("k,n_iter,dup", [(5, 10, False), (8, 4, True),
                                          (1, 3, False)])
def test_kmeans_and_assign_bitwise(k, n_iter, dup):
    rng = np.random.default_rng(k)
    feats = rng.normal(size=(600, 13)).astype(np.float32)
    if dup:  # few distinct points: empty clusters, re-seeded
        feats = np.repeat(feats[:4], 150, axis=0)
    for seed in (0, 3):
        got = mfcc.kmeans(feats, k, n_iter=n_iter, seed=seed)
        want = jax_mfcc.kmeans(feats, k, n_iter=n_iter, seed=seed)
        assert got.dtype == np.float32 and np.array_equal(got, want)
        assert np.array_equal(mfcc.assign_clusters(feats, got),
                              jax_mfcc.assign_clusters(feats, want))


def test_assign_clusters_past_one_chunk():
    rng = np.random.default_rng(9)
    feats = rng.normal(size=(70_000, 3))
    cents = rng.normal(size=(7, 3)).astype(np.float32)
    got = mfcc.assign_clusters(feats, cents)
    assert got.dtype == np.int32
    assert np.array_equal(got, jax_mfcc.assign_clusters(feats, cents))


def test_mfcc_grid_is_the_models_frame_grid():
    """Every clip length's MFCC frame count is the HuBERT model's T' for
    that clip (the full 16 kHz conv stack, one channel per layer)."""
    cfg = HubertPretrainConfig(
        d_model=16, num_heads=2, num_layers=1, d_ff=16, num_clusters=4,
        final_dim=4, timestep_masking=0.0, conv_pos_kernel=4,
        custom_conv_features=tuple((1, k, s) for _, k, s in
                                   CONV_FEATURES[16]))
    model = HubertPretrainModel(cfg, generator=torch.Generator()
                                .manual_seed(0))
    for n in (400, 401, 719, 720, 4000, 41_359):
        with torch.no_grad():
            logits, _, _ = model(torch.zeros(1, n), seeds=HubertSeeds(0))
        assert logits.shape[1] == len(mfcc.mfcc(np.zeros(n))), n


@pytest.fixture
def km_manifest(tmp_path):
    rng = np.random.default_rng(4)
    with open(tmp_path / "train.tsv", "w") as tf, \
            open(tmp_path / "train.km", "w") as kf:
        tf.write(str(tmp_path) + "\n")
        for i in range(9):
            n = int(rng.integers(3000, 12000))
            wavfile.write(str(tmp_path / f"u{i}.wav"), 16000,
                          (rng.normal(size=n) * 3000).astype(np.int16))
            tf.write(f"u{i}.wav\t{n}\n")
            # the MFCC grid's count, one short and one long row
            u = conv_output_length(n, CONV_FEATURES[16]) + (i % 3) - 1
            kf.write(" ".join(str(v) for v in rng.integers(0, 50, u)) + "\n")
    return str(tmp_path / "train.tsv")


@pytest.mark.parametrize("shuffle", [True, False])
def test_km_dataset_batches_match_jax(km_manifest, shuffle):
    kw = dict(shuffle=shuffle, is_infinite=False, max_dst_length=2048,
              pad_to_multiple=4000, read_workers=1)
    theirs = list(JaxDataset(km_manifest, None, 24000,
                             tgt_type=JaxDataset.TGT_KM, **kw))
    ours = list(AudioTextLetterDataset(
        km_manifest, None, 24000, tgt_type=AudioTextLetterDataset.TGT_KM,
        **kw))
    assert len(ours) == len(theirs) > 1
    for a, b in zip(ours, theirs):
        for key in ("signal", "signal_lengths", "token_ids",
                    "token_lengths"):
            assert np.array_equal(a[key], b[key]), key
        assert a["token_ids"].dtype == np.int32
        assert (a["token_ids"] == -1).any()
