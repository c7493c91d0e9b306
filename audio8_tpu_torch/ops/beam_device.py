"""Batched CTC prefix beam search on the log-probs' device, no LM: the
counterpart of ``audio8_tpu/ops/beam_jax.py``.

The JAX module runs the search as one ``lax.scan`` over frames; here
:func:`beam_search` runs the same step for a fixed trip count of frames,
as torch ops on the device that holds the log-probs, with no host read
inside the loop. Each frame every live prefix yields a "keep" candidate
(absorb a blank, repeat the last symbol) and V-1 "extend" candidates;
the table is JAX's (the K keeps first, then the K*(V-1) extensions,
beam-major). Identical prefixes merge by a rolling pair of 32-bit hashes
(the JAX uint32 arithmetic as int64 wraparound, ``ops.hashrand.mul32``):
a stable sort by (h1, h2) as one int64 key keeps the "keep" candidate
first in its run, so it is the run's representative and its backpointer
survives; each run log-adds its p_b and p_nb (a segment logsumexp over
``scatter_reduce``: NEG = -1e30, the sum floored at 1e-38); a stable top-k
(``models/seq2seq.py:top_k_stable``, ``lax.top_k``'s ties) keeps K by
``logsumexp(p_b, p_nb) + beta * n_words``. Frames at or past a row's
length leave its state as it was. Prefixes are never materialized: each
frame stores (parent, token) backpointers, and :func:`backtrace` rebuilds
the sequences on the host after the loop.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from audio8_tpu_torch.models.seq2seq import top_k_stable
from audio8_tpu_torch.ops.hashrand import MASK32, mul32

NEG = -1.0e30
MUL1, MUL2 = 1000003, 2654435761  # the JAX hash multipliers


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mx = torch.maximum(a, b)
    mn = torch.minimum(a, b)
    return mx + torch.log1p(torch.exp(torch.clamp(mn - mx, min=NEG)))


def _seg_lse(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """Each element's segment logsumexp (``jax.ops.segment_max`` and
    ``segment_sum`` as the JAX search uses them); ``ids`` flat segment
    ids of ``x``'s elements, ``n`` segments."""
    flat = x.reshape(-1)
    mx = torch.full((n,), NEG, device=x.device).scatter_reduce(
        0, ids, flat, "amax", include_self=False)
    mx = torch.clamp(mx, min=NEG)
    ssum = torch.zeros((n,), device=x.device).scatter_add(
        0, ids, torch.exp(flat - mx[ids]))
    return (mx + torch.log(torch.clamp(ssum, min=1e-38)))[ids].reshape(
        x.shape)


def beam_search(log_probs: torch.Tensor,
                frame_lengths: Optional[torch.Tensor] = None, *,
                beam: int = 8, blank: int = 0, space: int = -1,
                beta: float = 0.0):
    """Run the search on ``log_probs``' device. log_probs: (B, T, V)
    log-probs; ``frame_lengths`` (B,) on the same device (default T).

    Returns (parents (T, B, K) int64, tokens (T, B, K) int64 [-1 = keep],
    scores (B, K) f32, descending), all on the device: feed the first two
    to :func:`backtrace`."""
    b_sz, t_len, v = log_probs.shape
    k = beam
    m = k * v  # k keep candidates + k*(v-1) extensions
    dev = log_probs.device
    lp_all = log_probs.float()
    # the symbols but the blank, built on the device (no host copy)
    ext_syms = torch.arange(v - 1, device=dev)
    ext_syms = ext_syms + (ext_syms >= blank).long()
    sym_u = (ext_syms + 1)[None, None, :]
    arange_k = torch.arange(k, device=dev)
    neg = torch.full((), NEG, device=dev)

    # beam 0 = the live empty prefix; the rest are -inf duds with distinct
    # hashes, so they never merge with a real prefix
    ones = torch.arange(1, k + 1, device=dev)[None].expand(b_sz, k)
    state = {"h1": ones.clone(), "h2": (ones * 7919).clone(),
             "p_b": torch.cat([torch.zeros((b_sz, 1), device=dev),
                               torch.full((b_sz, k - 1), NEG, device=dev)],
                              dim=1),
             "p_nb": torch.full((b_sz, k), NEG, device=dev),
             "last": torch.full((b_sz, k), -1, dtype=torch.long, device=dev),
             "plen": torch.zeros((b_sz, k), dtype=torch.long, device=dev),
             "nwords": torch.zeros((b_sz, k), dtype=torch.long,
                                   device=dev)}
    lengths = (torch.full((b_sz,), t_len, device=dev) if frame_lengths is None
               else frame_lengths.to(dev).long())
    seg_offset = torch.arange(b_sz, device=dev)[:, None] * m
    keep_parent = arange_k[None].expand(b_sz, k)
    ext_parent = arange_k[None, :, None].expand(b_sz, k, v - 1).reshape(
        b_sz, k * (v - 1))
    cand_parent = torch.cat([keep_parent, ext_parent], dim=1)
    cand_token = torch.cat([torch.full((b_sz, k), -1, device=dev),
                            ext_syms[None].repeat(b_sz, k)], dim=1)
    parents = torch.empty((t_len, b_sz, k), dtype=torch.long, device=dev)
    tokens = torch.empty((t_len, b_sz, k), dtype=torch.long, device=dev)

    def kv(x):  # (B, K, V-1) -> (B, K*(V-1))
        return x.expand(b_sz, k, v - 1).reshape(b_sz, k * (v - 1))

    for t in range(t_len):
        lp = lp_all[:, t]
        last = state["last"]
        p_tot = _logaddexp(state["p_b"], state["p_nb"])
        # keep candidates (the same prefix): absorb blank; repeat last
        keep_pb = p_tot + lp[:, blank:blank + 1]
        lp_last = torch.gather(lp, 1, torch.clamp(last, min=0))
        keep_pnb = torch.where(last >= 0, state["p_nb"] + lp_last, neg)
        # extend candidates (B, K, V-1)
        is_rep = last[:, :, None] == ext_syms[None, None, :]
        base = torch.where(is_rep, state["p_b"][:, :, None],
                           p_tot[:, :, None])
        ext_pnb = base + lp[:, ext_syms][:, None, :]
        ext_h1 = (mul32(state["h1"], MUL1)[:, :, None] + sym_u) & MASK32
        ext_h2 = (mul32(state["h2"], MUL2)[:, :, None] + sym_u) & MASK32
        new_word = ((ext_syms[None, None, :] == space)
                    & (last[:, :, None] != space)
                    & (state["plen"][:, :, None] > 0))
        h1 = torch.cat([state["h1"], kv(ext_h1)], dim=1)
        h2 = torch.cat([state["h2"], kv(ext_h2)], dim=1)
        p_b = torch.cat([keep_pb, neg.expand(b_sz, k * (v - 1))], dim=1)
        p_nb = torch.cat([keep_pnb, kv(ext_pnb)], dim=1)
        nwords = torch.cat([state["nwords"], kv(
            state["nwords"][:, :, None] + new_word.long())], dim=1)

        # the stable lexicographic sort by (h1, h2): h1 shifted into the
        # signed range keeps its unsigned order in the high 32 bits
        key = (h1 - (1 << 31)) * (1 << 32) + h2
        key_s, order = torch.sort(key, dim=1, stable=True)
        first = torch.cat([torch.ones((b_sz, 1), dtype=torch.bool,
                                      device=dev),
                           key_s[:, 1:] != key_s[:, :-1]], dim=1)
        ids = ((torch.cumsum(first.long(), dim=1) - 1)
               + seg_offset).reshape(-1)
        merged_pb = _seg_lse(p_b.gather(1, order), ids, b_sz * m)
        merged_pnb = _seg_lse(p_nb.gather(1, order), ids, b_sz * m)
        score = torch.where(
            first, _logaddexp(merged_pb, merged_pnb)
            + beta * nwords.gather(1, order).float(), neg)
        _, top = top_k_stable(score, k)
        pick = order.gather(1, top)  # the candidate index of each pick
        new_state = {"h1": h1.gather(1, pick), "h2": h2.gather(1, pick),
                     "p_b": merged_pb.gather(1, top),
                     "p_nb": merged_pnb.gather(1, top),
                     "last": torch.cat([last, kv(ext_syms[None, None, :])],
                                       dim=1).gather(1, pick),
                     "plen": torch.cat([state["plen"], kv(
                         state["plen"][:, :, None] + 1)], dim=1).gather(
                             1, pick),
                     "nwords": nwords.gather(1, pick)}
        # frames past this row's length: identity update
        valid = (lengths > t)[:, None]
        state = {key_: torch.where(valid, val, state[key_])
                 for key_, val in new_state.items()}
        parents[t] = torch.where(valid, cand_parent.gather(1, pick),
                                 keep_parent)
        tokens[t] = torch.where(valid, cand_token.gather(1, pick),
                                torch.full_like(pick, -1))
    scores = (_logaddexp(state["p_b"], state["p_nb"])
              + beta * state["nwords"].float())
    return parents, tokens, scores


def backtrace(parents: np.ndarray, tokens: np.ndarray) -> list:
    """(T, B, K) backpointers -> per row the K id sequences, beam order
    kept: the JAX host walk, vectorized over the beams."""
    parents = np.asarray(parents)
    tokens = np.asarray(tokens)
    t_len, b_sz, k = parents.shape
    out = []
    for b in range(b_sz):
        cur = np.arange(k)
        rev = []
        for t in range(t_len - 1, -1, -1):
            rev.append(tokens[t, b, cur])
            cur = parents[t, b, cur]
        walk = np.stack(rev[::-1], axis=1) if rev else np.zeros((k, 0),
                                                                np.int64)
        out.append([[int(x) for x in row if x >= 0] for row in walk])
    return out


def ctc_beam_search(log_probs, frame_lengths=None, *, beam: int = 8,
                    blank: int = 0, space: int = -1, beta: float = 0.0
                    ) -> Tuple[list, np.ndarray]:
    """Batched prefix beam search where the log-probs are (a numpy array
    is searched on the CPU; a CUDA tensor on its card, never moved).

    Returns (nbest, scores): ``nbest[b]`` the ``beam`` id sequences of
    row b in descending score order; ``scores`` (B, beam) float32 (log
    prob + beta * completed-word count)."""
    lp = (log_probs if torch.is_tensor(log_probs)
          else torch.from_numpy(np.asarray(log_probs)))
    fl = None
    if frame_lengths is not None:
        fl = (frame_lengths if torch.is_tensor(frame_lengths)
              else torch.as_tensor(np.asarray(frame_lengths)))
        fl = fl.to(lp.device)
    parents, tokens, scores = beam_search(lp, fl, beam=beam, blank=blank,
                                          space=space, beta=beta)
    return (backtrace(parents.cpu().numpy(), tokens.cpu().numpy()),
            scores.cpu().numpy())
