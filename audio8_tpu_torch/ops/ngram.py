"""Interpolated modified Kneser-Ney n-gram LM estimation to ARPA, a copy
of ``audio8_tpu/ops/ngram.py`` (Chen & Goodman 1998; kenlm's ``lmplz``
estimates the same model class).

The output is standard ARPA, read by the port's ``ops/lm.ArpaLM``, its
native reader (``csrc/arpa_lm.cc``) and kenlm. For every context the
model stores, the backoff-scored distribution over the vocabulary sums
to 1. Counting is pure Python (a Counter over tuples): fine for
transcript-scale corpora; kenlm serves billion-word ones.
"""
from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

BOS, EOS, UNK = "<s>", "</s>", "<unk>"

Gram = Tuple[str, ...]


def count_ngrams(sentences: Iterable[Sequence[str]], order: int,
                 ) -> List[Counter]:
    """Raw counts per order (1..order). Sentences are wrapped
    ``<s> w1..wn </s>``; k-grams never span sentences and never *end*
    with <s> (it is only ever context)."""
    counts: List[Counter] = [Counter() for _ in range(order)]
    reserved = {BOS, EOS, UNK}
    for sent in sentences:
        bad = reserved.intersection(sent)
        if bad:
            # conflating corpus tokens with the sentence markers silently
            # corrupts the model (e.g. a literal </s> inflates
            # end-of-sentence mass); error loudly like lmplz does
            raise ValueError(
                f"corpus contains reserved token(s) {sorted(bad)}; "
                "remove or rename them (<s>, </s>, <unk> are the "
                "sentence/OOV markers)")
        toks = [BOS] + list(sent) + [EOS]
        n = len(toks)
        for k in range(1, order + 1):
            ck = counts[k - 1]
            for i in range(n - k + 1):
                g = tuple(toks[i:i + k])
                if g[-1] == BOS:
                    continue
                ck[g] += 1
    return counts


def adjusted_counts(raw: List[Counter]) -> List[Counter]:
    """Kneser-Ney adjusted counts: highest order and <s>-anchored grams
    keep raw counts (their left context cannot be extended); every other
    gram's count becomes its left-continuation count
    ``|{v : c(v . g) > 0}|``."""
    order = len(raw)
    adj: List[Counter] = [Counter() for _ in range(order)]
    adj[order - 1] = Counter(raw[order - 1])
    for k in range(order - 1, 0, -1):  # fill order k from raw order k+1
        ak = adj[k - 1]
        for g in raw[k]:  # Counter keys are distinct (k+1)-grams
            ak[g[1:]] += 1
        # grams whose left context never varies keep raw counts
        for g, c in raw[k - 1].items():
            if g[0] == BOS or g not in ak:
                ak[g] = c
    return adj


def _discounts(counts: Counter) -> Tuple[float, float, float]:
    """Three-bucket modified KN discounts (D1, D2, D3+) from the
    count-of-counts, with the standard estimator
    ``Dj = j - (j+1) * Y * t[j+1]/t[j]``, ``Y = t1/(t1+2*t2)``.
    Degenerate count-of-counts (tiny corpora) fall back to the classic
    absolute-discount constants, clipped so ``c - D(c) >= 0``."""
    t = Counter()
    for c in counts.values():
        if 1 <= c <= 4:
            t[c] += 1
    if t[1] and t[2]:
        y = t[1] / (t[1] + 2.0 * t[2])
        d = []
        for j in (1, 2, 3):
            if t[j]:
                dj = j - (j + 1) * y * t[j + 1] / t[j]
            else:
                dj = 0.5 * j
            d.append(min(max(dj, 0.0), float(j)))
        return d[0], d[1], d[2]
    return 0.5, 1.0, 1.5


def _bucket(d: Tuple[float, float, float], c: int) -> float:
    return d[0] if c == 1 else (d[1] if c == 2 else d[2])


class KneserNeyLM:
    """Estimated model: ``prob[g]`` / ``backoff[g]`` in log10 (ARPA
    scale). Built by :func:`train_kneser_ney`."""

    def __init__(self, order: int):
        self.order = order
        self.prob: Dict[Gram, float] = {}
        self.backoff: Dict[Gram, float] = {}

    def write_arpa(self, path: str) -> None:
        by_order: List[List[Gram]] = [[] for _ in range(self.order)]
        for g in self.prob:
            by_order[len(g) - 1].append(g)
        with open(path, "w", encoding="utf-8") as f:
            f.write("\\data\\\n")
            for k in range(self.order):
                f.write(f"ngram {k + 1}={len(by_order[k])}\n")
            for k in range(self.order):
                f.write(f"\n\\{k + 1}-grams:\n")
                for g in sorted(by_order[k]):
                    line = f"{self.prob[g]:.7f}\t{' '.join(g)}"
                    bo = self.backoff.get(g)
                    if bo is not None:
                        line += f"\t{bo:.7f}"
                    f.write(line + "\n")
            f.write("\n\\end\\\n")


def train_kneser_ney(sentences: Iterable[Sequence[str]], order: int = 3,
                     ) -> KneserNeyLM:
    """Estimate an interpolated modified-KN model of ``order`` from
    tokenized sentences.

    - vocabulary = observed words + </s> + <unk>; <s> is context-only
      (ARPA prob -99, the convention kenlm/SRILM use);
    - <unk> receives its share of the unigram interpolation mass
      (``gamma(eps)/V``), so the distribution over the full vocabulary
      (including <unk>) sums to exactly 1 in every context.
    """
    raw = count_ngrams(sentences, order)
    if not raw[0]:
        raise ValueError("empty corpus: no tokens to estimate from")
    adj = adjusted_counts(raw)

    # per-order discounts from the adjusted counts (lmplz semantics)
    disc = [_discounts(adj[k]) for k in range(order)]

    # group each order's grams by context
    by_ctx: List[Dict[Gram, List[Tuple[str, int]]]] = []
    for k in range(order):
        d: Dict[Gram, List[Tuple[str, int]]] = defaultdict(list)
        for g, c in adj[k].items():
            d[g[:-1]].append((g[-1], c))
        by_ctx.append(d)

    vocab = sorted({g[0] for g in adj[0]} - {BOS} | {EOS, UNK})
    v_size = len(vocab)

    # interpolated probabilities, bottom-up; p[k][gram] linear-space
    p: List[Dict[Gram, float]] = [dict() for _ in range(order)]
    gammas: List[Dict[Gram, float]] = [dict() for _ in range(order)]

    # unigrams: interpolate with the uniform distribution over vocab
    d1 = disc[0]
    total1 = sum(c for _, c in by_ctx[0][()])
    n_bucket = [0.0, 0.0, 0.0]
    for _, c in by_ctx[0][()]:
        n_bucket[min(c, 3) - 1] += 1
    gamma1 = (d1[0] * n_bucket[0] + d1[1] * n_bucket[1]
              + d1[2] * n_bucket[2]) / total1
    uniform = 1.0 / v_size
    for w, c in by_ctx[0][()]:
        if w == BOS:
            continue
        p[0][(w,)] = max(c - _bucket(d1, c), 0.0) / total1 + gamma1 * uniform
    for w in (EOS, UNK):  # unseen in tiny corpora: pure smoothing mass
        p[0].setdefault((w,), gamma1 * uniform)
    gammas[0][()] = gamma1

    def p_lower(g: Gram) -> float:
        """Interpolated lower-order probability. Always a direct hit:
        every suffix of a counted gram is itself counted (continuation
        or raw), so the interpolation never needs a backoff path."""
        return p[len(g) - 1][g]

    for k in range(1, order):
        dk = disc[k]
        for ctx, items in by_ctx[k].items():
            total = sum(c for _, c in items)
            nb = [0.0, 0.0, 0.0]
            for _, c in items:
                nb[min(c, 3) - 1] += 1
            gamma = (dk[0] * nb[0] + dk[1] * nb[1] + dk[2] * nb[2]) / total
            gammas[k][ctx] = gamma
            for w, c in items:
                g = ctx + (w,)
                p[k][g] = (max(c - _bucket(dk, c), 0.0) / total
                           + gamma * p_lower(g[1:]))

    lm = KneserNeyLM(order)
    log10 = math.log(10.0)

    def l10(x: float) -> float:
        return math.log(max(x, 1e-99)) / log10

    for k in range(order):
        for g, prob in p[k].items():
            lm.prob[g] = l10(prob)
    lm.prob[(BOS,)] = -99.0  # context-only, never predicted
    # backoff weights: stored for every gram that is a context of a
    # longer stored gram (ARPA omission means backoff 1.0)
    for k in range(1, order):
        for ctx, gamma in gammas[k].items():
            # every context is already stored: contexts are counted grams
            # (prefix of an occurrence) except (<s>,), whose -99 entry was
            # added above
            lm.backoff[ctx] = l10(gamma)
    return lm


def read_sentences(paths: Sequence[str], lowercase: bool = False,
                   ) -> Iterable[List[str]]:
    for path in paths:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                toks = line.split()
                if toks:
                    yield [t.lower() for t in toks] if lowercase else toks
