"""Transcript post-processing (``audio8_tpu/ops/metrics.py:41-53``).

Re-implemented because the JAX module imports jax through ``ops/ctc.py``.
WER/CER accumulation comes with the evaluation CLI.
"""
from __future__ import annotations

from typing import Iterable


def postproc_letters(sentence: Iterable[str]) -> str:
    """Letter targets: join, drop spaces, '|' -> word boundary."""
    s = "".join(sentence)
    return s.replace(" ", "").replace("|", " ").strip()


def postproc_bpe(sentence: Iterable[str]) -> str:
    """BPE targets: join with spaces, strip '@@ ' continuations."""
    s = " ".join(sentence)
    return s.replace("@@ ", "").strip()
