"""Vocabulary reader (``audio8_tpu/models/text.py:read_vocab_list``).

The JAX reader lives in a flax module, so the jax-free function is
re-implemented here; it reads the shared ``audio8_tpu.utils.Offsets``.
"""
from __future__ import annotations

import json
from typing import List

from audio8_tpu.utils import Offsets


def read_vocab_list(vocab_file: str) -> List[str]:
    """Specials (``Offsets.VALUES``) + one token per line (first
    whitespace field), the fairseq ``dict.ltr.txt`` format. A ``.json``
    file is read as an HF ``vocab.json`` token -> index map."""
    if vocab_file.endswith(".json"):
        with open(vocab_file) as rf:
            mapping = json.load(rf)
        vocab = ["<unused>"] * (max(mapping.values()) + 1)
        for tok, idx in mapping.items():
            vocab[idx] = tok
        return vocab
    vocab = list(Offsets.VALUES)
    with open(vocab_file) as rf:
        for line in rf:
            parts = line.split()
            if parts:
                vocab.append(parts[0])
    return vocab
