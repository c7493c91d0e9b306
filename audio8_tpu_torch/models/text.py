"""Vocabulary reader and letter tokenizer (``audio8_tpu/models/text.py:
read_vocab_list``, ``TextVectorizer``).

The JAX reader lives in a flax module, so the function is re-implemented
here; it reads the port's ``audio8_tpu_torch.utils.Offsets``.
"""
from __future__ import annotations

import json
from typing import Dict, List, Sequence

import numpy as np

from audio8_tpu_torch.utils import Offsets


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


class TextVectorizer:
    """Dict-lookup tokenizer with optional begin/end emissions
    (``audio8_tpu/models/text.py:TextVectorizer``)."""

    def __init__(self, vocab: Dict[str, int], emit_begin_tok=(),
                 emit_end_tok=()):
        self.vocab = vocab
        self.emit_begin_tok = list(emit_begin_tok)
        self.emit_end_tok = list(emit_end_tok)

    def run(self, tokens: Sequence[str]) -> np.ndarray:
        ids = ([self.vocab[t] for t in self.emit_begin_tok]
               + [self.vocab.get(t, Offsets.UNK) for t in tokens]
               + [self.vocab[t] for t in self.emit_end_tok])
        return np.array(ids, dtype=np.int32)
