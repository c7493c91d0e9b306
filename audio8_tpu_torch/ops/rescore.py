"""Neural-LM n-best rescoring of beam output (``audio8_tpu/ops/rescore.py``).

The beam proposes; each hypothesis h of its n-best list is scored

    score(h) = ctc_logp(h | frames) + alpha * lm_logp(h) + bonus * |h|

where ``ctc_logp`` is the exact CTC likelihood from the forward
recursion (:func:`ctc_label_logp`: ``ops/ctc.py:ctc_loss`` forward only,
so ``a8t::ctc_loss``, kernel 1, on a CUDA tensor, and the plain scan on a
CPU one; JAX runs its scan), and ``lm_logp`` comes from a
``cli.train_lm`` basedir (:class:`NeuralLMRescorer`, a
``models/text.py:CausalTextLM``). A transducer's beam scores are already
exact, so :func:`rescore_transducer_nbest` adds only the LM and the
length terms. Hypotheses pad to the longest one (JAX snaps to a length
grid for its compile cache; padded labels and tokens change no value).
GO, EOS and PAD are read from ``Offsets`` at call time, as in JAX.

As in JAX, ``ctc_loss`` zeroes an infinite loss (``zero_infinity``), so
a hypothesis that cannot align (its labels and repeats need more frames
than the utterance has) scores an acoustic log-likelihood of 0. The
kernel takes at most 1023 labels a hypothesis and raises above that on
the card.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from audio8_tpu_torch.config import TextLMConfig
from audio8_tpu_torch.models.text import CausalTextLM
from audio8_tpu_torch.ops.ctc import ctc_loss
from audio8_tpu_torch.train.checkpoint import (find_latest_checkpoint,
                                               load_model_weights)
from audio8_tpu_torch.utils import Offsets


class NeuralLMRescorer:
    """Configures itself from a ``cli.train_lm`` basedir
    (``lm_config.json`` and the latest ``checkpoint-step-N.pt``), or the
    JAX ``a8t-train-lm`` one (its latest Orbax ``checkpoint-step-N``), and
    scores letter or BPE id sequences with the LM on ``device``."""

    def __init__(self, lm_dir: str, alpha: float = 0.5,
                 word_bonus: float = 0.0, dtype=torch.float32,
                 device="cpu"):
        with open(os.path.join(lm_dir, "lm_config.json")) as f:
            raw = json.load(f)
        raw.pop("dict_file", None)
        self.config = TextLMConfig(**raw)
        self.alpha = float(alpha)
        self.word_bonus = float(word_bonus)
        self.device = torch.device(device)
        path, _ = find_latest_checkpoint(lm_dir)
        self.model = CausalTextLM(self.config, dtype)
        load_model_weights(path, self.model, "lm")
        self.model.to(self.device)

    @torch.inference_mode()
    def lm_logp(self, hyps: Sequence[Sequence[int]]) -> np.ndarray:
        """Total LM log-prob of each id sequence (GO context, closed by
        EOS), float32."""
        if not hyps:
            return np.zeros((0,), np.float32)
        rows = [[Offsets.GO] + list(h) + [Offsets.EOS] for h in hyps]
        ids = np.full((len(rows), max(len(r) for r in rows)), Offsets.PAD,
                      np.int64)
        for i, r in enumerate(rows):
            ids[i, :len(r)] = r
        lens = torch.tensor([len(r) for r in rows], device=self.device)
        out = self.model.sequence_logp(
            torch.from_numpy(ids).to(self.device), lens)
        return out.float().cpu().numpy()


def ctc_label_logp(log_probs, frame_length: int,
                   hyps: Sequence[Sequence[int]],
                   blank: Optional[int] = None) -> np.ndarray:
    """Exact CTC log-likelihood of each hypothesis for ONE utterance's
    ``(T', V)`` frame log-probs (a numpy array, computed on the CPU, or a
    tensor, computed on its device: all hypotheses in one call)."""
    if not hyps:
        return np.zeros((0,), np.float32)
    blank = Offsets.GO if blank is None else blank
    lp = (log_probs if torch.is_tensor(log_probs)
          else torch.from_numpy(np.asarray(log_probs)))
    dev = lp.device
    u = max(max(len(h) for h in hyps), 1)
    tgt = np.zeros((len(hyps), u), np.int32)
    for i, h in enumerate(hyps):
        tgt[i, :len(h)] = list(h)
    n = len(hyps)
    with torch.inference_mode():
        nll = ctc_loss(
            lp.float()[None].expand(n, *lp.shape),
            torch.full((n,), int(frame_length), dtype=torch.int32,
                       device=dev),
            torch.from_numpy(tgt).to(dev),
            torch.tensor([len(h) for h in hyps], dtype=torch.int32,
                         device=dev),
            blank=blank, reduction="none")
    return -nll.cpu().numpy().astype(np.float32)


def _pick(acoustic: np.ndarray, nbest_ids, rescorer, timings) -> int:
    t0 = time.perf_counter()
    lm = rescorer.lm_logp(nbest_ids)
    if timings is not None:
        timings["lm"] = timings.get("lm", 0.0) + time.perf_counter() - t0
    total = (np.asarray(acoustic, np.float32) + rescorer.alpha * lm
             + rescorer.word_bonus * np.asarray(
                 [len(h) for h in nbest_ids], np.float32))
    total = np.where([len(h) == 0 for h in nbest_ids], -np.inf, total)
    if not np.isfinite(total).any():
        return 0
    return int(np.argmax(total))


def rescore_transducer_nbest(acoustic_scores: Sequence[float],
                             nbest_ids: Sequence[Sequence[int]],
                             rescorer: NeuralLMRescorer,
                             timings: Optional[dict] = None) -> int:
    """Index of the best transducer hypothesis under acoustic + LM +
    length score: ``Transducer.decode_beam``'s scores are already the
    exact explored-alignment marginals, so nothing is recomputed.
    ``timings``: a dict that accumulates the LM's host seconds (``lm``)."""
    if not nbest_ids:
        return 0
    return _pick(acoustic_scores, nbest_ids, rescorer, timings)


def rescore_nbest(log_probs, frame_length: int,
                  nbest_ids: Sequence[Sequence[int]],
                  rescorer: NeuralLMRescorer, blank: Optional[int] = None,
                  timings: Optional[dict] = None) -> int:
    """Index of the best hypothesis under acoustic + LM + length score;
    empty hypotheses score -inf unless every one is empty. ``timings``: a
    dict that accumulates the host seconds of the CTC recompute
    (``ctc``) and of the LM (``lm``)."""
    if not nbest_ids:
        return 0
    t0 = time.perf_counter()
    ac = ctc_label_logp(log_probs, frame_length, nbest_ids, blank)
    if timings is not None:
        timings["ctc"] = timings.get("ctc", 0.0) + time.perf_counter() - t0
    return _pick(ac, nbest_ids, rescorer, timings)
