"""ARPA n-gram language model in pure Python (``audio8_tpu/ops/lm.py``).

The plain version of the host library's ARPA reader
(``csrc/arpa_lm.cc``): the LM that ``ops.beam._prefix_beam_search_py``
scores with in the tests. A real run reads its LM through the host
library (``ops.beam._load_lm``). Scores are natural-log (ARPA log10
converted), ctcdecode's scale, with standard backoff.
"""
from __future__ import annotations

import gzip
import math
from typing import Dict, Tuple

LOG10 = math.log(10.0)

# Every KenLM binary (probing or trie, any version) starts with this
# sanity-header magic (kenlm lm/binary_format.cc kMagicBeforeVersion).
KENLM_BINARY_MAGIC = b"mmap lm http://kheafield.com/code format version"


def ensure_arpa(path: str) -> None:
    """Raise ``ValueError`` if ``path`` is a KenLM *binary* model rather
    than ARPA text (a binary would otherwise parse as garbled ARPA).
    ``ops.beam._load_lm`` catches it and reads the binary natively."""
    opener = gzip.open if path.endswith(".gz") else open
    try:
        with opener(path, "rb") as f:
            head = f.read(len(KENLM_BINARY_MAGIC))
    except OSError:
        return  # let the real reader produce its own error
    if head == KENLM_BINARY_MAGIC:
        raise ValueError(
            f"{path} is a KenLM binary model, not ARPA text. PROBING, "
            "TRIE and QUANT_TRIE binaries load through "
            "audio8_tpu_torch.csrc.native.NativeKenLM (PrefixBeamSearch "
            "routes there); REST_PROBING and -a array-trie binaries need "
            "the original ARPA (which may be gzipped)")


class ArpaLM:
    """Backoff n-gram LM loaded from an ARPA file (optionally gzipped)."""

    def __init__(self, path: str):
        ensure_arpa(path)
        self.ngrams: Dict[Tuple[str, ...], Tuple[float, float]] = {}
        self.order = 0
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8", errors="replace") as f:
            section = 0
            for line in f:
                line = line.strip()
                if not line or line.startswith("\\data\\"):
                    continue
                if line.startswith("\\") and "-grams:" in line:
                    section = int(line[1:line.index("-")])
                    self.order = max(self.order, section)
                    continue
                if line.startswith("\\end\\"):
                    break
                if section == 0:
                    continue
                parts = line.split("\t")
                if len(parts) < 2:
                    parts = line.split()
                    if len(parts) < section + 1:
                        continue
                    prob = float(parts[0])
                    words = tuple(parts[1:section + 1])
                    backoff = (float(parts[section + 1])
                               if len(parts) > section + 1 else 0.0)
                else:
                    prob = float(parts[0])
                    words = tuple(parts[1].split())
                    backoff = float(parts[2]) if len(parts) > 2 else 0.0
                self.ngrams[words] = (prob * LOG10, backoff * LOG10)

    def logp(self, word: str, context: Tuple[str, ...]) -> float:
        """ln P(word | context) with standard backoff; an OOV word falls
        back to <unk> or a -100 floor, as kenlm does. Backoff weights
        accumulate across every shortened context level, as in
        ``csrc/arpa_lm.cc``."""
        context = tuple(context[-(self.order - 1):]) if self.order > 1 else ()
        backoff_acc = 0.0
        while True:
            entry = self.ngrams.get(context + (word,))
            if entry is not None:
                return backoff_acc + entry[0]
            if not context:
                unk = self.ngrams.get(("<unk>",))
                return backoff_acc + (unk[0] if unk is not None
                                      else -100.0 * LOG10)
            bo = self.ngrams.get(context)
            if bo is not None:
                backoff_acc += bo[1]
            context = context[1:]
