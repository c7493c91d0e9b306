"""Host-side MFCC features and k-means for HuBERT cluster targets (the
port's copy of ``audio8_tpu/data/mfcc.py``, with its names and defaults).

The first HuBERT iteration clusters MFCC features of the raw audio (arXiv
2106.07447 §3.2). Frames are taken on the acoustic conv stack's grid:
window 400 samples (25 ms) and hop 320 (20 ms) at 16 kHz, so a clip gives
``conv_output_length`` frames and each target id lines up with one encoder
frame, with no label-rate resampling.

numpy in float64: these are host tools of ``cli.cluster_targets``, not
kernels, and they give the JAX package's features, centroids and ids bit
for bit.
"""
from __future__ import annotations

import numpy as np

# the 16 kHz conv stack's receptive field / stride (config.CONV_FEATURES)
WIN = 400
HOP = 320


def _frames(x: np.ndarray, win: int = WIN, hop: int = HOP) -> np.ndarray:
    n = (len(x) - win) // hop + 1
    if n <= 0:
        return np.zeros((0, win), x.dtype)
    idx = np.arange(win)[None, :] + hop * np.arange(n)[:, None]
    return x[idx]


def _mel_filterbank(n_mels: int, n_fft: int, sr: int) -> np.ndarray:
    """Triangular mel filterbank (HTK mel scale), (n_mels, n_fft//2+1)."""
    mel = lambda f: 2595.0 * np.log10(1.0 + f / 700.0)
    imel = lambda m: 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    pts = imel(np.linspace(mel(0.0), mel(sr / 2.0), n_mels + 2))
    bins = np.floor((n_fft + 1) * pts / sr).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1))
    for i in range(n_mels):
        lo, mid, hi = bins[i], bins[i + 1], bins[i + 2]
        if mid > lo:
            fb[i, lo:mid] = (np.arange(lo, mid) - lo) / (mid - lo)
        if hi > mid:
            fb[i, mid:hi] = (hi - np.arange(mid, hi)) / (hi - mid)
    return fb


def _delta(x: np.ndarray, order: int = 2) -> np.ndarray:
    """Regression deltas over +-``order`` frames (edge-padded)."""
    denom = 2.0 * sum(i * i for i in range(1, order + 1))
    pad = np.pad(x, ((order, order), (0, 0)), mode="edge")
    out = np.zeros_like(x)
    for i in range(1, order + 1):
        out += i * (pad[order + i:len(pad) - order + i]
                    - pad[order - i:len(pad) - order - i])
    return out / denom


def mfcc(x: np.ndarray, sr: int = 16_000, n_mfcc: int = 13,
         n_mels: int = 23, n_fft: int = 512,
         with_deltas: bool = True) -> np.ndarray:
    """(T,) float audio -> (frames, 39) MFCC + delta + delta-delta.

    frames == ``conv_output_length(T, CONV_FEATURES[16])``: the conv-grid
    window/hop make targets frame-aligned with the encoder by
    construction.
    """
    x = np.asarray(x, np.float64)
    f = _frames(x)
    if not len(f):
        return np.zeros((0, n_mfcc * 3 if with_deltas else n_mfcc),
                        np.float32)
    f = f * np.hanning(WIN)
    spec = np.abs(np.fft.rfft(f, n=n_fft, axis=-1)) ** 2
    mel = spec @ _mel_filterbank(n_mels, n_fft, sr).T
    logmel = np.log(np.maximum(mel, 1e-10))
    # orthonormal DCT-II over the mel axis
    k = np.arange(n_mels)
    dct = np.cos(np.pi * (k[None, :] + 0.5) * np.arange(n_mfcc)[:, None]
                 / n_mels) * np.sqrt(2.0 / n_mels)
    dct[0] *= np.sqrt(0.5)
    feats = logmel @ dct.T
    if with_deltas:
        feats = np.concatenate([feats, _delta(feats), _delta(_delta(feats))],
                               axis=-1)
    return feats.astype(np.float32)


def kmeans(feats: np.ndarray, k: int, n_iter: int = 20,
           seed: int = 0) -> np.ndarray:
    """Plain Lloyd k-means (numpy), k-means++ init -> (k, d) centroids.

    Sized for the HuBERT target pipeline: feats is a subsample of a few
    hundred thousand frames; the tool fits once per corpus offline.
    """
    rng = np.random.default_rng(seed)
    feats = np.asarray(feats, np.float64)
    n = len(feats)
    # k-means++ seeding
    centroids = [feats[rng.integers(n)]]
    d2 = np.full(n, np.inf)
    for _ in range(1, k):
        d2 = np.minimum(d2, ((feats - centroids[-1]) ** 2).sum(-1))
        p = d2 / d2.sum() if d2.sum() > 0 else None
        centroids.append(feats[rng.choice(n, p=p)])
    c = np.stack(centroids)
    for _ in range(n_iter):
        assign = assign_clusters(feats, c)
        for j in range(k):
            sel = feats[assign == j]
            if len(sel):
                c[j] = sel.mean(0)
            else:  # re-seed empty cluster at the worst-fit point
                far = ((feats - c[assign]) ** 2).sum(-1).argmax()
                c[j] = feats[far]
    return c.astype(np.float32)


def assign_clusters(feats: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """Nearest-centroid ids, chunked so the (n, k) distance matrix stays
    small."""
    feats = np.asarray(feats, np.float64)
    cents = np.asarray(centroids, np.float64)
    c2 = (cents ** 2).sum(-1)
    out = np.empty(len(feats), np.int32)
    for lo in range(0, len(feats), 65536):
        chunk = feats[lo:lo + 65536]
        d = c2[None, :] - 2.0 * chunk @ cents.T
        out[lo:lo + 65536] = d.argmin(-1)
    return out
