"""Word-level timestamps and confidences from CTC frame alignments, a
host numpy copy of ``audio8_tpu/ops/align.py``.

The greedy CTC path carries an alignment: the frame where each collapsed
token first fires. Frame k covers ``[k * stride / sr, (k + 1) * stride /
sr)`` seconds, where ``stride`` is the conv stack's total stride (320 at
16 kHz: 20 ms frames). The alignment marks where a letter's posterior
peaks, which can trail its acoustic onset by a frame or two.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def total_stride(conv_features: Sequence) -> int:
    s = 1
    for _, _, stride in conv_features:
        s *= stride
    return s


def greedy_alignment(log_probs: np.ndarray, blank: int
                     ) -> List[Tuple[int, int, float]]:
    """(T', V) frame log-probs -> emitted tokens with frame indices.

    Standard CTC greedy collapse (argmax, drop repeats, drop blank —
    ops/ctc.py semantics) but keeping, per emitted token, the frame
    where its run starts and its log-posterior at that frame.
    """
    lp = np.asarray(log_probs)
    if lp.ndim != 2:
        raise ValueError(f"expected (T', V) log-probs, got {lp.shape}")
    ids = np.argmax(lp, axis=-1)
    out: List[Tuple[int, int, float]] = []
    prev = blank
    for t, i in enumerate(ids):
        i = int(i)
        if i != blank and i != prev:
            out.append((i, t, float(lp[t, i])))
        prev = i
    return out


def word_timestamps(alignment: Sequence[Tuple[int, int, float]],
                    index2vocab: Dict[int, str], frame_seconds: float,
                    word_sep: str = "|") -> List[dict]:
    """Letter alignment -> ``[{word, start, end, confidence}, ...]``.

    Letter-vocab semantics (the ``postproc_letters`` convention,
    ops/metrics.py): tokens are single characters, ``word_sep`` closes a
    word. ``start``/``end`` are seconds; ``confidence`` is the geometric
    mean of the word's letter posteriors.
    """
    words: List[dict] = []
    cur: List[Tuple[str, int, float]] = []

    def flush(end_frame: Optional[int] = None):
        if not cur:
            return
        text = "".join(ch for ch, _, _ in cur)
        first, last = cur[0][1], cur[-1][1]
        conf = math.exp(sum(lp for _, _, lp in cur) / len(cur))
        words.append({
            "word": text,
            "start": round(first * frame_seconds, 3),
            "end": round(((end_frame if end_frame is not None else last) + 1)
                         * frame_seconds, 3),
            "confidence": round(min(conf, 1.0), 4),
        })
        cur.clear()

    for tok, frame, lp in alignment:
        ch = index2vocab.get(tok, "")
        if ch == word_sep:
            flush(end_frame=frame - 1 if cur else None)
        elif len(ch) == 1 and ch.isprintable():
            cur.append((ch, frame, lp))
        # specials (<pad>, <unk>, ...) never carry timing
    flush()
    return words


def timestamped_words(log_probs: np.ndarray, index2vocab: Dict[int, str],
                      blank: int, frame_seconds: float,
                      word_sep: str = "|") -> List[dict]:
    """One-call convenience: frame log-probs -> word dicts."""
    return word_timestamps(greedy_alignment(log_probs, blank), index2vocab,
                           frame_seconds, word_sep)
