"""Hash dropout (``audio8_tpu/nn/dropout.py``, the JAX package's default
dropout).

The keep mask is a pure function of the element's flat index and an
integer seed (``ops/hashrand.py``), so it is bit-exact with the JAX
package's ``_hash_keep_mask`` for the same seed. The work is
``ops.dropout.fused_dropout``: the kernel ``csrc/dropout.cu`` on the card
(forward, and the backward that regenerates the mask), the plain
:func:`hash_dropout` on the CPU.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from audio8_tpu_torch.ops.dropout import fused_dropout, hash_dropout
from audio8_tpu_torch.ops.hashrand import draw_seed, strided_index
from audio8_tpu_torch.parallel.sharding import row_offset

__all__ = ["dropout", "hash_dropout"]


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            whole: Optional[Sequence[int]] = None,
            at: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Training-time hash dropout with a seed drawn from ``generator``;
    the identity without a generator (evaluation) or at rate 0, where no
    seed is drawn. ``x`` is batch-first: in a data-parallel step its rows
    draw the global batch's mask from the step's row offset. ``x`` may be
    a piece of a tensor whose non-batch axes are ``whole`` (a
    sequence-parallel rank's frames, a tensor-parallel rank's heads),
    starting there at ``at`` (its non-batch offsets): it draws that
    tensor's mask (``ops/hashrand.py:strided_index``)."""
    if generator is None or rate == 0.0:
        return x
    whole = tuple(x.shape[1:]) if whole is None else tuple(whole)
    at = (0,) * len(whole) if at is None else tuple(at)
    base, row_len, row_stride = strided_index(
        x.shape, (x.shape[0],) + whole, (row_offset(),) + at)
    return fused_dropout(x, rate, draw_seed(generator), base, row_len,
                         row_stride)
