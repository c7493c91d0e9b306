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

from typing import Optional

import torch

from audio8_tpu_torch.ops.dropout import fused_dropout, hash_dropout
from audio8_tpu_torch.ops.hashrand import draw_seed, row_base
from audio8_tpu_torch.parallel.sharding import row_offset

__all__ = ["dropout", "hash_dropout"]


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Training-time hash dropout with a seed drawn from ``generator``;
    the identity without a generator (evaluation) or at rate 0, where no
    seed is drawn. ``x`` is batch-first: in a data-parallel step its rows
    draw the global batch's mask from the step's row offset."""
    if generator is None or rate == 0.0:
        return x
    return fused_dropout(x, rate, draw_seed(generator),
                         row_base(x.shape, row_offset()))
