"""Span masks for training-time time and channel masking
(``audio8_tpu/ops/masks.py``).

Same sampling as the JAX ``span_mask``: ``N = num_spans(T, p, L)`` starts
per row, drawn without replacement from ``[0, T - L]`` as the first N of
a stable argsort of hash-uniform keys, each masking L consecutive
positions. Given the same integer seed the mask is the JAX package's bit
for bit. ``compact_mask_indices`` turns a mask into the static-width
gather indices of the pretraining loss, as the JAX function does.
"""
from __future__ import annotations

import torch

from audio8_tpu_torch.ops.hashrand import hash_uniform


def num_spans(seq_len: int, p: float, span_len: int) -> int:
    """Round-half-up of p*T/L."""
    return int(p * seq_len / float(span_len) + 0.5)


def span_mask(seed: int, batch: int, seq_len: int, p: float = 0.65,
              span_len: int = 10, device: torch.device | str = "cpu",
              row_offset: int = 0) -> torch.Tensor:
    """A (B, T) boolean span mask from an integer ``seed``; the rows are
    rows ``row_offset ..`` of the batch's mask (a data-parallel row
    block draws the global batch's keys)."""
    n = num_spans(seq_len, p, span_len)
    if n == 0:
        return torch.zeros((batch, seq_len), dtype=torch.bool, device=device)
    max_start = max(seq_len - span_len, 1)
    keys = hash_uniform((batch, max_start), seed, device,
                        row_offset * max_start)
    starts = torch.argsort(keys, dim=-1, stable=True)[:, :n]
    t = torch.arange(seq_len, device=device)[None, None, :]
    covered = (t >= starts[..., None]) & (t < starts[..., None] + span_len)
    return covered.any(dim=1)


def compact_mask_indices(mask: torch.Tensor, capacity: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """A boolean (B, T) mask -> static-width gather indices: ``indices``
    (B, capacity) int64, the first ``capacity`` masked positions of each
    row in increasing order (a stable argsort of ``~mask``), and ``valid``
    (B, capacity) bool, which of them are real."""
    b, t = mask.shape
    capacity = min(capacity, t)
    order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)
    counts = mask.sum(dim=-1, keepdim=True)
    valid = torch.arange(capacity, device=mask.device)[None, :] < counts
    return order[:, :capacity], valid
