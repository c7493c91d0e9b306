"""CTC prefix beam search with optional n-gram LM fusion
(``audio8_tpu/ops/beam.py``).

:class:`PrefixBeamSearch` has the JAX package's interface (vocab_list,
alpha, beta, beam, lm_file; blank = ``Offsets.GO``; '|' <-> ' '; the
same ``run`` n-best convention), without ``device=``: the on-device
search is ROADMAP.md queue 1, item 7. Every decode runs in the port's
host library (``csrc/beam.cc``, ``csrc/arpa_lm.cc``), and its LM is read
there too (:func:`_load_lm`). :func:`_prefix_beam_search_py` (Hannun et
al. 2014's prefix search with a word-insertion bonus and LM fusion at
word boundaries) is the plain version the tests hold it to; nothing
else calls it.
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import List, Optional, Sequence

import numpy as np

from audio8_tpu_torch.csrc import native
from audio8_tpu_torch.ops.lm import ensure_arpa
from audio8_tpu_torch.utils import Offsets

LOG0 = -1e30


def _logaddexp(a: float, b: float) -> float:
    if a < b:
        a, b = b, a
    if b <= LOG0 / 2:
        return a
    return a + math.log1p(math.exp(b - a))


def _n_words(prefix, space_idx) -> int:
    """Completed (non-empty) words: spaces that end a word. Leading or
    repeated spaces earn no insertion bonus (ctcdecode's semantics, as
    ``csrc/arpa_lm.cc``'s ``n_words``)."""
    if space_idx is None:
        return 0
    n = 0
    prev = space_idx
    for s in prefix:
        if s == space_idx and prev != space_idx:
            n += 1
        prev = s
    return n


def _load_lm(lm_file: str) -> native.NativeLM:
    """An ARPA file (plain or gzipped) or a KenLM binary (PROBING, TRIE,
    QUANT_TRIE), read by the host library."""
    try:
        ensure_arpa(lm_file)
    except ValueError:
        return native.NativeKenLM(lm_file)
    return native.NativeArpaLM(lm_file)


def _prefix_beam_search_py(log_probs: np.ndarray, blank: int, beam: int,
                           space_idx: Optional[int], alpha: float,
                           beta: float, lm=None,
                           id2sym=None) -> List[List[int]]:
    """Decode one utterance (T, V) into its ranked n-best id sequences.

    With an LM, each completed word (at a ``space_idx`` boundary) is
    scored with weight ``alpha`` and adds the insertion bonus ``beta``:
    ctcdecode's fusion."""
    T, V = log_probs.shape
    # prefix tuple -> [p_blank, p_non_blank, lm_score]
    beams = {(): [0.0, LOG0, 0.0]}
    k = min(V, max(beam, 16))

    def set_lm(entry, value):
        # a prefix reached from several parents in one step carries ONE
        # LM score; its writers agree (same prefix, same completed words)
        entry[2] = value if entry[2] is None else max(entry[2], value)

    def word_ending_at(prefix) -> str:
        chars = []
        for s_id in reversed(prefix):
            if s_id == space_idx:
                break
            chars.append(id2sym[s_id] if id2sym else str(s_id))
        return "".join(reversed(chars))

    def context_words(prefix) -> tuple:
        if id2sym is None:
            return ()
        text = "".join(id2sym[i] for i in prefix)
        return tuple(w for w in text.split(" ") if w)

    for t in range(T):
        lp = log_probs[t]
        cand_syms = np.argpartition(-lp, k - 1)[:k]
        next_beams: dict = defaultdict(lambda: [LOG0, LOG0, None])
        for prefix, (p_b, p_nb, lm_sc) in beams.items():
            p_tot = _logaddexp(p_b, p_nb)
            nb = next_beams[prefix]
            nb[0] = _logaddexp(nb[0], p_tot + lp[blank])
            set_lm(nb, lm_sc)
            last = prefix[-1] if prefix else None
            for c in cand_syms:
                c = int(c)
                if c == blank:
                    continue
                p_sym = lp[c]
                if c == last:
                    nb_rep = next_beams[prefix]
                    nb_rep[1] = _logaddexp(nb_rep[1], p_nb + p_sym)
                    nb_new = next_beams[prefix + (c,)]
                    nb_new[1] = _logaddexp(nb_new[1], p_b + p_sym)
                    set_lm(nb_new, lm_sc)
                else:
                    nb_new = next_beams[prefix + (c,)]
                    new_lm = lm_sc
                    if (lm is not None and space_idx is not None
                            and c == space_idx and prefix
                            and prefix[-1] != space_idx):
                        word = word_ending_at(prefix)
                        if word:
                            ctx = context_words(
                                prefix[:len(prefix) - len(word)])
                            new_lm = lm_sc + lm.logp(word, ctx)
                    nb_new[1] = _logaddexp(nb_new[1], p_tot + p_sym)
                    set_lm(nb_new, new_lm)
        scored = []
        for prefix, entry in next_beams.items():
            p_b, p_nb, lm_sc = entry
            if lm_sc is None:
                lm_sc = entry[2] = 0.0
            score = (_logaddexp(p_b, p_nb) + alpha * lm_sc
                     + beta * _n_words(prefix, space_idx))
            scored.append((score, prefix, [p_b, p_nb, lm_sc]))
        scored.sort(key=lambda x: -x[0])
        beams = {prefix: vals for _, prefix, vals in scored[:beam]}
    ranked = sorted(beams.items(), key=lambda kv: -(
        _logaddexp(kv[1][0], kv[1][1]) + alpha * kv[1][2]
        + beta * _n_words(kv[0], space_idx)))
    return [list(prefix) for prefix, _ in ranked]


class PrefixBeamSearch:
    """The JAX package's ``PrefixBeamSearch`` without ``device=``."""

    def __init__(self, vocab_list: Sequence[str], alpha: float = 0.2,
                 beta: float = 5.0, beam: int = 100,
                 lm_file: Optional[str] = None):
        self.vocab_list = list(vocab_list)
        self.use_bar = "|" in self.vocab_list
        self.bar_off = self.vocab_list.index("|") if self.use_bar else -1
        if self.use_bar:
            self.vocab_list[self.bar_off] = " "
        self.beam = beam
        self.alpha = alpha
        self.beta = beta
        self.blank = Offsets.GO
        self._lm_file = lm_file
        self.lm = _load_lm(lm_file) if lm_file else None

    def _decode_one(self, lp: np.ndarray) -> List[List[int]]:
        lp32 = np.ascontiguousarray(lp, np.float32)
        if self.lm is None:
            return native.prefix_beam_search(
                lp32, self.blank, self.beam, self.bar_off, self.alpha,
                self.beta)
        return native.prefix_beam_search_lm(
            lp32, self.blank, self.beam, self.bar_off, self.alpha, self.beta,
            self.vocab_list, self.lm)

    def run(self, log_probs: np.ndarray, frame_lengths=None, n_best=None,
            return_ids: bool = False):
        """n-best transcriptions per batch row; at ``n_best=1`` the
        singleton axis collapses, as in the reference."""
        log_probs = np.asarray(log_probs)
        if n_best is None:
            n_best = self.beam

        def transform(t):
            return t if return_ids else (
                self.vocab_list[t] if t != self.bar_off else "|")

        out = []
        for b in range(log_probs.shape[0]):
            lp = log_probs[b]
            if frame_lengths is not None:
                lp = lp[:int(frame_lengths[b])]
            nbest = self._decode_one(lp)[:n_best]
            if n_best == 1:
                out.append([transform(t) for t in (nbest[0] if nbest
                                                   else [])])
            else:
                out.append([[transform(t) for t in seq] for seq in nbest])
        return out
