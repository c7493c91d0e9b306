"""Energy-based voice activity detection for transcription, a host numpy
copy of ``audio8_tpu/ops/vad.py``.

``--vad true`` on ``cli.transcribe`` transcribes only the speech spans:
no device work on silence and no letters hallucinated from it, while
word timestamps stay global through the segments' offsets. The frame
grid is the feature extractor's (hop = total stride, window = receptive
field). The threshold adapts per file: the noise floor (10th percentile
frame dB) plus a margin, clamped to at most 25 dB below the peak.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def frame_db(wav: np.ndarray, window: int = 400, hop: int = 320,
             eps: float = 1e-10) -> np.ndarray:
    """Per-frame RMS energy in dBFS on the encoder's frame grid."""
    wav = np.asarray(wav, np.float32).reshape(-1)
    n_frames = max(1 + (len(wav) - window) // hop, 0) if len(wav) >= window \
        else 0
    if n_frames == 0:
        return np.full((1,), 20 * np.log10(
            float(np.sqrt(np.mean(np.square(wav)) if len(wav) else 0.0))
            + eps), np.float32)
    idx = np.arange(window)[None, :] + hop * np.arange(n_frames)[:, None]
    rms = np.sqrt(np.mean(np.square(wav[idx]), axis=1))
    return (20 * np.log10(rms + eps)).astype(np.float32)


def speech_segments(wav: np.ndarray, sample_rate: int = 16_000,
                    margin_db: float = 8.0, max_drop_db: float = 25.0,
                    min_speech_sec: float = 0.2, min_gap_sec: float = 0.3,
                    pad_sec: float = 0.15, window: int = 400,
                    hop: int = 320) -> List[Tuple[int, int]]:
    """Speech spans as ``[(start_sample, end_sample), ...]``.

    Frames above ``noise_floor + margin_db`` (clamped to at most
    ``peak - max_drop_db``) are speech; gaps shorter than
    ``min_gap_sec`` merge, spans shorter than ``min_speech_sec`` drop,
    and ``pad_sec`` of context is kept on both sides of every span.
    Returns the whole file as one span when nothing clears the
    threshold margin (flat/synthetic audio is "all speech", not "all
    silence").
    """
    wav = np.asarray(wav, np.float32).reshape(-1)
    if len(wav) == 0:
        return []
    db = frame_db(wav, window=window, hop=hop)
    floor = float(np.percentile(db, 10))
    peak = float(db.max())
    if peak - floor < margin_db:
        return [(0, len(wav))]  # no dynamic range to separate on
    thresh = min(floor + margin_db, peak - max_drop_db)
    active = db > thresh

    # frame runs -> sample spans
    spans: List[List[int]] = []
    start = None
    for i, a in enumerate(active):
        if a and start is None:
            start = i
        elif not a and start is not None:
            spans.append([start, i])
            start = None
    if start is not None:
        spans.append([start, len(active)])
    if not spans:
        return [(0, len(wav))]

    # merge close spans, drop tiny ones, pad, convert to samples
    min_gap = max(int(min_gap_sec * sample_rate / hop), 0)
    merged = [spans[0]]
    for s, e in spans[1:]:
        if s - merged[-1][1] <= min_gap:
            merged[-1][1] = e
        else:
            merged.append([s, e])
    min_len = max(int(min_speech_sec * sample_rate / hop), 1)
    pad = int(pad_sec * sample_rate)
    out: List[Tuple[int, int]] = []
    for s, e in merged:
        if e - s < min_len:
            continue
        a = max(s * hop - pad, 0)
        b = min(e * hop + window + pad, len(wav))
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out or [(0, len(wav))]
