"""CTC decoding helpers (the loss comes with training).

Counterparts of ``audio8_tpu/ops/ctc.py:ctc_greedy_decode`` and
``greedy_collapse``; that module imports jax, so the two small functions
are re-implemented here.
"""
from __future__ import annotations

from typing import Iterable, List

import torch


def ctc_greedy_decode(log_probs: torch.Tensor) -> torch.Tensor:
    """Per-frame argmax ``(B, T)`` int32; blank removal and de-duplication
    happen host-side in :func:`greedy_collapse`."""
    return torch.argmax(log_probs, dim=-1).to(torch.int32)


def greedy_collapse(frames: Iterable[int], blank: int) -> List[int]:
    """Host-side unique_consecutive + blank removal for one utterance."""
    out = []
    prev = None
    for tok in frames:
        tok = int(tok)
        if tok != prev:
            if tok != blank:
                out.append(tok)
            prev = tok
    return out
