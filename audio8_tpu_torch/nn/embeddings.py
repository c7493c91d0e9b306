"""Embedding layers of the text side (``audio8_tpu/nn/embeddings.py``).

Tables are float32 parameters named as the JAX tree names them
(``embedding``, ``pos_embedding``), read in the compute dtype. The tied
output projection (``attend``, :class:`WeightTieDense`) multiplies by the
table cast to the input's dtype, as the JAX ``jnp.dot(x, table.T)``.
"""
from __future__ import annotations

import torch
from torch import nn


def _normal(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator,
                       device=generator.device) * std


class LookupTableEmbeddings(nn.Module):
    """Token-embedding lookup (the 'default' embed type)."""

    def __init__(self, vocab_size: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.embedding = nn.Parameter(torch.zeros(vocab_size, features))

    def init_from(self, generator: torch.Generator) -> None:
        """Normal with std ``features ** -0.5``, the JAX init."""
        with torch.no_grad():
            self.embedding.copy_(_normal(self.embedding.shape,
                                         self.embedding.shape[1] ** -0.5,
                                         generator))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids].to(self.compute_dtype)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Features back onto the vocabulary with the tied table."""
        return torch.matmul(x, self.embedding.t().to(x.dtype))


class LearnedPositionalEmbeddings(nn.Module):
    """Token + learned absolute position embeddings
    ('learned-positional'): ``word`` and ``pos_embedding (max_len, C)``;
    positions start at ``offset`` (a decode step's cache index)."""

    def __init__(self, vocab_size: int, features: int, max_len: int = 1024,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.word = LookupTableEmbeddings(vocab_size, features, dtype)
        self.pos_embedding = nn.Parameter(torch.zeros(max_len, features))

    def init_from(self, generator: torch.Generator) -> None:
        """The position table; ``word`` inits as a module of its own."""
        with torch.no_grad():
            self.pos_embedding.copy_(_normal(
                self.pos_embedding.shape,
                self.pos_embedding.shape[1] ** -0.5, generator))

    def forward(self, ids: torch.Tensor, offset: int = 0) -> torch.Tensor:
        t = ids.shape[-1]
        pos = torch.arange(t, device=ids.device) + offset
        return self.word(ids) + self.pos_embedding[pos].to(self.compute_dtype)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        return self.word.attend(x)


class WeightTieDense(nn.Module):
    """Output projection tied to an embedding table passed at call time
    (``logits = x @ E^T``), so the parameter stays single-sourced."""

    def forward(self, x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, table.t().to(x.dtype))
