"""Small shared utilities of the port (``audio8_tpu/utils.py``):
special-token registry, running averages, vocab helpers.

``Offsets`` is the port's own process-global registry; the CTC entry
points remap it to the fairseq letter-dict layout as the JAX ones remap
theirs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List


class Offsets:
    """Registry of special-token ids. ``remap_fairseq_ctc`` applies the
    fairseq CTC ordering (``<s>`` = 0 is both GO and the CTC blank,
    ``<pad>`` = 1)."""

    PAD = 0
    GO = 1
    EOS = 2
    UNK = 3
    OFFSET = 4
    VALUES: List[str] = ["<PAD>", "<GO>", "<EOS>", "<UNK>"]

    @classmethod
    def remap_fairseq_ctc(cls) -> None:
        cls.GO = 0
        cls.PAD = 1
        cls.VALUES[cls.GO] = "<s>"
        cls.VALUES[cls.PAD] = "<pad>"
        cls.VALUES[cls.EOS] = "</s>"
        cls.VALUES[cls.UNK] = "<unk>"


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise ValueError(f"Boolean value expected, got {v!r}")


def revlut(lut: Dict[str, int]) -> Dict[int, str]:
    return {v: k for k, v in lut.items()}


@dataclasses.dataclass
class Average:
    """Streaming mean, printed as ``"<name> <avg>"``."""

    name: str
    total: float = 0.0
    count: int = 0

    def update(self, value: float, n: int = 1) -> None:
        self.total += value * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.total / self.count if self.count else 0.0

    def reset(self) -> None:
        self.total = 0.0
        self.count = 0

    def __str__(self) -> str:
        return f"{self.name} {self.avg:.6f}"
