"""Text side of the port (``audio8_tpu/models/text.py``).

Host half: vocab IO, the letter/word tokenizer, and the subword-nmt BPE
codec (learning merges, applying them with '@@' continuation pieces).
Module half: the paired model's text towers (bag of words, and an
rpr-attention transformer with a reduction), the seq2seq model's
decoder (learned-positional embeddings, a pre-norm decoder stack, tied
log-softmax output, KV-cached single-token steps) and the causal text LM
of n-best rescoring (:class:`CausalTextLM`).

The JAX module is a flax module, so the host functions are copies; they
read the port's ``audio8_tpu_torch.utils.Offsets``. Parameter names are
the JAX tree's (``tgt_embeddings.word.embedding``,
``transformer.layer_{i}.self_attn.w_Q``, ...), so
``models/convert.py:params_from_jax`` maps them one to one.
"""
from __future__ import annotations

import contextlib
import heapq
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from audio8_tpu_torch.config import (DecoderConfig, TextEncoderConfig,
                                     TextLMConfig)
from audio8_tpu_torch.nn.embeddings import (LearnedPositionalEmbeddings,
                                            LookupTableEmbeddings)
from audio8_tpu_torch.nn.pooling import MaxPool1D, MeanPool1D, Reduction
from audio8_tpu_torch.nn.transformer import (TextTransformerEncoderStack,
                                             TransformerDecoderStack,
                                             subsequent_mask)
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


def read_vocab_file(vocab_file: str) -> Dict[str, int]:
    return {v: i for i, v in enumerate(read_vocab_list(vocab_file))}


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


class SubwordBPE:
    """Minimal subword-nmt BPE codec: apply merge rules from a codes file,
    emitting '@@'-suffixed continuation pieces."""

    def __init__(self, model_file: str):
        self.bpe_ranks: Dict[Tuple[str, str], int] = {}
        with open(model_file, encoding="utf-8") as f:
            for i, line in enumerate(f):
                if i == 0 and line.startswith("#version"):
                    continue
                parts = line.split()
                if len(parts) >= 2:
                    self.bpe_ranks.setdefault((parts[0], parts[1]),
                                              len(self.bpe_ranks))
        self._cache: Dict[str, List[str]] = {}

    def segment_word(self, word: str) -> List[str]:
        if not word:
            return []
        if word in self._cache:
            return self._cache[word]
        # subword-nmt v0.2: end-of-word is a separate '</w>' symbol
        symbols: List[str] = list(word) + ["</w>"]
        while len(symbols) > 1:
            pairs = [(symbols[i], symbols[i + 1])
                     for i in range(len(symbols) - 1)]
            best_rank, _, best = min(
                (self.bpe_ranks.get(p, 1 << 30), i, p)
                for i, p in enumerate(pairs))
            if best_rank >= 1 << 30:
                break
            symbols = _merge(symbols, best)
        if symbols and symbols[-1] == "</w>":
            symbols = symbols[:-1]
        elif symbols and symbols[-1].endswith("</w>"):
            symbols = symbols[:-1] + [symbols[-1][: -len("</w>")]]
        out = [s + "@@" for s in symbols[:-1]] + symbols[-1:]
        self._cache[word] = out
        return out


def _merge(symbols: List[str], pair: Tuple[str, str]) -> List[str]:
    """Every left-to-right occurrence of ``pair`` merged into one
    symbol."""
    merged: List[str] = []
    i = 0
    while i < len(symbols):
        if i < len(symbols) - 1 and (symbols[i], symbols[i + 1]) == pair:
            merged.append(symbols[i] + symbols[i + 1])
            i += 2
        else:
            merged.append(symbols[i])
            i += 1
    return merged


class _Desc:
    """A pair ordered backwards, so that a min-heap pops the
    lexicographically largest pair of a count first."""
    __slots__ = ("pair",)

    def __init__(self, pair: Tuple[str, str]):
        self.pair = pair

    def __lt__(self, other: "_Desc") -> bool:
        return self.pair > other.pair


def learn_bpe(word_counts: Dict[str, int], num_merges: int,
              min_frequency: int = 2) -> List[Tuple[str, str]]:
    """Learn BPE merge rules from a word-frequency table (subword-nmt's
    ``learn_bpe``): start from characters + '</w>', repeatedly merge the
    most frequent adjacent pair, ties to the lexicographically largest
    pair, until ``num_merges`` or the best count drops below
    ``min_frequency``. Pair counts are kept incrementally: a merge
    revisits only the words that contain the merged pair. The best pair
    comes from a heap of (count, pair) entries, one pushed whenever a
    pair's count changes; an entry whose count is no longer the pair's
    is dropped when it reaches the top, where the JAX package scans
    every pair for each merge."""
    words: List[Tuple[List[str], int]] = [
        (list(w) + ["</w>"], c) for w, c in word_counts.items() if w]
    stats: Dict[Tuple[str, str], int] = {}
    index: Dict[Tuple[str, str], set] = {}
    for wi, (syms, c) in enumerate(words):
        for pair in zip(syms, syms[1:]):
            stats[pair] = stats.get(pair, 0) + c
            index.setdefault(pair, set()).add(wi)
    heap = [(-n, _Desc(pair)) for pair, n in stats.items()]
    heapq.heapify(heap)

    merges: List[Tuple[str, str]] = []
    for _ in range(num_merges):
        while heap and stats.get(heap[0][1].pair) != -heap[0][0]:
            heapq.heappop(heap)  # a stale count
        if not heap:
            break
        best = heap[0][1].pair
        if stats[best] < min_frequency:
            break
        merges.append(best)
        changed = set()
        for wi in list(index.get(best, ())):
            syms, c = words[wi]
            for pair in zip(syms, syms[1:]):  # the word's old pairs out
                stats[pair] -= c
                changed.add(pair)
                if stats[pair] <= 0:
                    stats.pop(pair, None)
                idx = index.get(pair)
                if idx is not None:
                    idx.discard(wi)
                    if not idx:
                        index.pop(pair, None)
            merged = _merge(syms, best)
            words[wi] = (merged, c)
            for pair in zip(merged, merged[1:]):
                stats[pair] = stats.get(pair, 0) + c
                changed.add(pair)
                index.setdefault(pair, set()).add(wi)
        for pair in changed:
            if pair in stats:
                heapq.heappush(heap, (-stats[pair], _Desc(pair)))
    return merges


def write_bpe_codes(path: str, merges: Sequence[Tuple[str, str]]) -> None:
    """Write merges in the subword-nmt codes-file format (v0.2 header),
    readable back by :class:`SubwordBPE`."""
    with open(path, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")


class BPEVectorizer:
    """BPE segmentation + vocab lookup."""

    def __init__(self, model_file: str, vocab_file: str, emit_begin_tok=(),
                 emit_end_tok=()):
        self.bpe = SubwordBPE(model_file)
        self.vocab = read_vocab_file(vocab_file)
        self.emit_begin_tok = list(emit_begin_tok)
        self.emit_end_tok = list(emit_end_tok)

    def segment(self, tokens: Sequence[str]) -> List[str]:
        out: List[str] = []
        for t in tokens:
            out.extend(self.bpe.segment_word(t))
        return out

    def run(self, tokens: Sequence[str]) -> np.ndarray:
        pieces = self.emit_begin_tok + self.segment(tokens) \
            + self.emit_end_tok
        return np.array([self.vocab.get(p, Offsets.UNK) for p in pieces],
                        dtype=np.int32)


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_len) bool, True = valid position."""
    return (torch.arange(max_len, device=lengths.device)[None, :]
            < lengths[:, None])


class TextBoWPooledEncoder(nn.Module):
    """Embeddings + masked max or mean pooling."""

    def __init__(self, vocab_size: int, d_model: int,
                 reduction_type: str = "mean",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model = d_model
        self.embeddings = LookupTableEmbeddings(vocab_size, d_model, dtype)
        self.pooler = MaxPool1D() if reduction_type == "max" else MeanPool1D()

    @property
    def output_dim(self) -> int:
        return self.d_model

    def forward(self, ids, lengths, generator=None, freeze: bool = True):
        with torch.no_grad() if freeze else contextlib.nullcontext():
            embedded = self.embeddings(ids)
        return self.pooler(embedded, lengths)


class TextTransformerPooledEncoder(nn.Module):
    """Embeddings + rpr-attention post-norm transformer + reduction."""

    def __init__(self, cfg: TextEncoderConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = cfg
        self.embeddings = LookupTableEmbeddings(cfg.vocab_size, cfg.d_model,
                                                dtype)
        self.transformer = TextTransformerEncoderStack(
            cfg.num_heads, cfg.d_model, cfg.num_layers, cfg.d_ff, dtype,
            cfg.dropout, cfg.rpr_k)
        self.reduction = Reduction(cfg.reduction_type, cfg.d_model,
                                   cfg.reduction_d_k, cfg.dropout, dtype)

    @property
    def output_dim(self) -> int:
        return self.config.d_model

    def forward(self, ids, lengths, generator=None, freeze: bool = True):
        """``generator``: training mode. ``freeze``: no gradient into the
        embeddings and the transformer (they run under
        ``torch.no_grad()``, the JAX ``stop_gradient`` on the encoded
        sequence)."""
        pad_mask = sequence_mask(lengths, ids.shape[1])
        with torch.no_grad() if freeze else contextlib.nullcontext():
            encoded = self.transformer(self.embeddings(ids), pad_mask,
                                       generator)
        return self.reduction(encoded, pad_mask, generator)


class TextTransformerDecoder(nn.Module):
    """Learned-positional target embeddings + pre-norm decoder stack +
    the tied log-softmax output, which casts to f32 before ``attend``;
    :meth:`step` decodes one token through the KV cache."""

    def __init__(self, cfg: DecoderConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = cfg
        self.tgt_embeddings = LearnedPositionalEmbeddings(
            cfg.vocab_size, cfg.d_model, cfg.max_len, dtype)
        self.transformer = TransformerDecoderStack(
            cfg.num_heads, cfg.d_model, cfg.num_layers,
            cfg.d_ff or 4 * cfg.d_model, dtype, cfg.dropout)

    def _output(self, x: torch.Tensor) -> torch.Tensor:
        return torch.log_softmax(self.tgt_embeddings.attend(x.float()),
                                 dim=-1)

    def forward(self, memory, src_pad_mask, dst, dst_pad_mask,
                generator=None):
        """memory (B, T_src, C); src_pad_mask and dst_pad_mask (B, T)
        bool -> (B, T_dst, V) f32 log-probs."""
        embed = self.tgt_embeddings(dst)
        tgt_mask = (subsequent_mask(dst.shape[1], dst.device)
                    & dst_pad_mask[:, None, None, :])
        src_mask = (None if src_pad_mask is None
                    else src_pad_mask[:, None, None, :])
        return self._output(self.transformer(embed, memory, src_mask,
                                             tgt_mask, generator))

    def init_cache(self, batch: int, max_len: int, device=None) -> dict:
        return self.transformer.init_cache(batch, max_len, device=device)

    def compute_cross_kv(self, memory):
        """Per-layer cross-attention K/V of the encoder output, projected
        once and reused at every decode step."""
        return self.transformer.compute_cross_kv(memory)

    def step(self, memory, src_pad_mask, tok, cache, cross_kv=None):
        """tok (B, 1) -> (log-probs (B, V), cache)."""
        embed = self.tgt_embeddings(tok, offset=cache["index"])
        src_mask = (None if src_pad_mask is None
                    else src_pad_mask[:, None, None, :])
        out, cache = self.transformer.step(embed, memory, src_mask, cache,
                                           cross_kv)
        return self._output(out)[:, 0], cache


class CausalTextLM(nn.Module):
    """Decoder-only text LM (``audio8_tpu/models/text.py:CausalTextLM``):
    embeddings, the pre-norm rpr-attention stack under the causal mask,
    and the tied log-softmax output computed in f32. Relative attention
    (no absolute positions) scores any length, whatever the training
    block. ``generator``: when given, the parameters get the JAX
    package's random init drawn from it."""

    def __init__(self, cfg: TextLMConfig, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = cfg
        self.embeddings = LookupTableEmbeddings(cfg.vocab_size, cfg.d_model,
                                                dtype)
        self.transformer = TextTransformerEncoderStack(
            cfg.num_heads, cfg.d_model, cfg.num_layers, cfg.d_ff, dtype,
            cfg.dropout, cfg.rpr_k, pre_norm=True)
        if generator is not None:
            for m in self.modules():
                if hasattr(m, "init_from") and m is not self:
                    m.init_from(generator)

    def forward(self, ids: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, L) token ids -> (B, L, V) f32 next-token log-probs (position
        t predicts ``ids[:, t + 1]``); ``generator``: training mode."""
        h = self.transformer(self.embeddings(ids), generator=generator,
                             mask=subsequent_mask(ids.shape[1], ids.device))
        return torch.log_softmax(self.embeddings.attend(h.float()), dim=-1)

    def sequence_logp(self, ids: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
        """(B,) total log-prob of each row: the sum over 1 <= t < length
        of ``log p(ids[t] | ids[:t])`` (``ids[:, 0]`` is the GO context;
        the PAD tail is masked out)."""
        lp = self(ids)
        tgt = ids[:, 1:].long()
        tok_lp = torch.gather(lp[:, :-1], 2, tgt[..., None])[..., 0]
        pos = torch.arange(tgt.shape[1], device=ids.device)[None, :]
        valid = pos < (lengths.to(ids.device)[:, None] - 1)
        return torch.where(valid, tok_lp, torch.zeros_like(tok_lp)).sum(-1)
