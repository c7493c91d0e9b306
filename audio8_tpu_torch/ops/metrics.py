"""WER/CER metrics and transcript post-processing
(``audio8_tpu/ops/metrics.py``): greedy frames -> collapse -> edit
distance against the targets, for characters and words, and the word
errors of a beam transcript. Host-side; the edit
distance runs in the port's host library (``csrc/editdistance.cc``),
and :func:`edit_distance_plain` is the plain version the tests hold it
to.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Sequence

import numpy as np

from audio8_tpu_torch.csrc.native import edit_distance
from audio8_tpu_torch.ops.ctc import greedy_collapse
from audio8_tpu_torch.utils import Offsets


def edit_distance_plain(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance with two-row DP."""
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
        prev = cur
    return prev[-1]


def postproc_letters(sentence: Iterable[str]) -> str:
    """Letter targets: join, drop spaces, '|' -> word boundary."""
    s = "".join(sentence)
    return s.replace(" ", "").replace("|", " ").strip()


def postproc_bpe(sentence: Iterable[str]) -> str:
    """BPE targets: join with spaces, strip '@@ ' continuations."""
    s = " ".join(sentence)
    return s.replace("@@ ", "").strip()


def _target_units(target_row: np.ndarray) -> List[int]:
    keep = (target_row != Offsets.PAD) & (target_row != Offsets.EOS)
    return [int(x) for x in target_row[keep]]


def ctc_metrics(log_probs: np.ndarray, targets: np.ndarray,
                input_lengths: np.ndarray, index2vocab: Dict[int, str],
                postproc_fn: Callable = postproc_letters) -> Dict[str, int]:
    """Greedy-decode WER/CER numerators and denominators for one batch.
    ``log_probs``: (B, T, V), or (B, T) int frames already argmaxed;
    ``input_lengths``: output-frame counts."""
    frames = np.argmax(log_probs, axis=-1) if log_probs.ndim == 3 \
        else log_probs
    blank = Offsets.GO
    m = dict(c_errors=0, c_total=0, w_errors=0, wv_errors=0, w_total=0)
    for fr, t_row, inp_l in zip(frames, targets, input_lengths):
        pred = greedy_collapse(fr[: int(inp_l)], blank)
        targ = _target_units(np.asarray(t_row))
        m["c_errors"] += edit_distance(pred, targ)
        m["c_total"] += len(targ)
        targ_words = postproc_fn([index2vocab[x] for x in targ]).split()
        pred_words = postproc_fn([index2vocab[x] for x in pred]).split()
        dist = edit_distance(pred_words, targ_words)
        m["w_errors"] += dist
        m["wv_errors"] += dist
        m["w_total"] += len(targ_words)
    return m


def decode_metrics(decoded: Sequence[Sequence[int]], targets: np.ndarray,
                   index2vocab: Dict[int, str],
                   postproc_fn: Callable = postproc_letters
                   ) -> Dict[str, int]:
    """WER/CER numerators and denominators of already-decoded id rows
    (seq2seq greedy or beam outputs): each row deduplicated and stripped
    of blanks as the CTC path does, as the JAX ``decode_metrics``."""
    blank = Offsets.GO
    m = dict(c_errors=0, c_total=0, w_errors=0, wv_errors=0, w_total=0)
    for dp, t_row in zip(decoded, targets):
        pred = greedy_collapse(dp, blank)
        targ = _target_units(np.asarray(t_row))
        m["c_errors"] += edit_distance(pred, targ)
        m["c_total"] += len(targ)
        targ_words = postproc_fn([index2vocab[x] for x in targ]).split()
        pred_words = postproc_fn([index2vocab[x] for x in pred]).split()
        dist = edit_distance(pred_words, targ_words)
        m["w_errors"] += dist
        m["wv_errors"] += dist
        m["w_total"] += len(targ_words)
    return m


def decode_text_wer(pred_units: str, target_row: np.ndarray,
                    index2vocab: Dict[int, str],
                    postproc_fn: Callable = postproc_letters):
    """(word errors, target words) of one decoded transcription string
    against a target row."""
    targ = [index2vocab[x] for x in _target_units(np.asarray(target_row))]
    targ_words = postproc_fn(targ).split()
    return (edit_distance(postproc_fn(pred_units).split(), targ_words),
            len(targ_words))
