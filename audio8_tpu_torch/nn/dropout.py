"""Hash dropout (``audio8_tpu/nn/dropout.py``, the JAX package's default
dropout).

The keep mask is a pure function of the element's flat index and an
integer seed (``ops/hashrand.py``), so it is bit-exact with the JAX
package's ``_hash_keep_mask`` for the same seed. The Pallas
``fast_dropout`` (TPU hardware PRNG, opt-in there) is not on this path.
"""
from __future__ import annotations

from typing import Optional

import torch

from audio8_tpu_torch.ops.hashrand import draw_seed, hash_bits, keep_threshold


def hash_keep_mask(shape, rate: float, seed: int,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    return hash_bits(shape, seed, device) >= keep_threshold(rate)


def hash_dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """``where(keep, x / (1 - rate), 0)`` with the hash keep mask; the
    gradient flows through the same mask."""
    if rate == 0.0:
        return x
    keep = hash_keep_mask(x.shape, rate, seed, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Training-time hash dropout with a seed drawn from ``generator``;
    the identity without a generator (evaluation) or at rate 0, where no
    seed is drawn."""
    if generator is None or rate == 0.0:
        return x
    return hash_dropout(x, rate, draw_seed(generator))
