"""Random bits from an integer hash of element indices
(``audio8_tpu/ops/hashrand.py``).

The murmur-style mix of the flat element index and a uint32 seed that the
JAX package's hash dropout, span masks and attention kernel use. uint32
arithmetic runs in int64 with explicit wrap-around (products in 16-bit
halves), so the bits are the JAX package's bit for bit on any device.
Seeds are plain integers: the port draws them from a ``torch.Generator``
that the caller owns (:func:`draw_seed`).
"""
from __future__ import annotations

from typing import Sequence

import torch

MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32)."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """The murmur finaliser on int64 values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def hash_bits(shape: Sequence[int], seed: int,
              device: torch.device | str = "cpu") -> torch.Tensor:
    """uint32 bits (as int64) of ``shape``: mix(flat index ^ seed)."""
    n = 1
    for d in shape:
        n *= int(d)
    idx = torch.arange(n, dtype=torch.int64, device=device) & MASK32
    return mix32(idx ^ (int(seed) & MASK32)).reshape(tuple(shape))


def hash_uniform(shape: Sequence[int], seed: int,
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """float32 in the open interval (0, 1): the top 24 bits plus half an
    ulp."""
    bits = hash_bits(shape, seed, device)
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0) \
        + (0.5 / 16777216.0)


def hash_gumbel(shape: Sequence[int], seed: int,
                device: torch.device | str = "cpu") -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))`` from :func:`hash_uniform`
    (float32)."""
    return -torch.log(-torch.log(hash_uniform(shape, seed, device)))


def hash_randint(shape: Sequence[int], seed: int,
                 maxval: torch.Tensor) -> torch.Tensor:
    """int64 in ``[0, maxval)``: the uint32 bits modulo ``maxval``, which
    broadcasts against ``shape`` (the JAX package's uint32 remainder)."""
    bits = hash_bits(shape, seed, maxval.device)
    return bits % maxval.to(torch.int64)


def keep_threshold(rate: float) -> int:
    """uint32 threshold of a keep mask with drop probability ``rate``."""
    return min(int(rate * 4294967296.0), 4294967295)


class SeedReplay:
    """A seed source that hands out given seeds in order, in place of a
    ``torch.Generator``: the seam through which a run is fed the seeds
    another implementation drew (the tests hold the port's dropout to the
    JAX package's this way), and LayerDrop's keep decisions (``keeps``)
    likewise. ``remaining`` counts the seeds not drawn, ``keeps_left``
    the decisions."""

    def __init__(self, seeds, keeps=()):
        self._seeds = [int(s) & MASK32 for s in seeds]
        self._keeps = [bool(k) for k in keeps]
        self.device = torch.device("cpu")

    @property
    def remaining(self) -> int:
        return len(self._seeds)

    @property
    def keeps_left(self) -> int:
        return len(self._keeps)

    def next_keep(self) -> bool:
        if not self._keeps:
            raise RuntimeError("SeedReplay: more keep decisions drawn than "
                               "given")
        return self._keeps.pop(0)

    def next_seed(self) -> int:
        if not self._seeds:
            raise RuntimeError("SeedReplay: more seeds drawn than given")
        return self._seeds.pop(0)


def draw_seed(generator) -> int:
    """One uint32 seed from ``generator`` (the JAX package draws an int32
    from its key and reinterprets it as uint32), or the next seed of a
    :class:`SeedReplay`."""
    if isinstance(generator, SeedReplay):
        return generator.next_seed()
    return int(torch.randint(0, 2 ** 32, (), generator=generator,
                             device=generator.device))


def draw_keep(generator, keep_prob: float) -> bool:
    """A Bernoulli(``keep_prob``) decision from ``generator`` (LayerDrop's
    per-layer keep), or the next given one of a :class:`SeedReplay`."""
    if isinstance(generator, SeedReplay):
        return generator.next_keep()
    return bool(torch.rand((), generator=generator, device=generator.device)
                < keep_prob)
