"""Utterance pooling and reductions (``audio8_tpu/nn/pooling.py``): the
reduction menu of the pooled encoders (``2ha``, ``2ha_max``,
``2ha_mean``, ``sha``, ``sha_max``, ``sha_mean``, ``max``, ``mean``,
``none``), sequence (B, T, C) -> utterance (B, C).

Parameter names are the JAX tree's (``head_0``, ``w_Q``, ``squeeze``).
The arithmetic follows the JAX modules' order in the compute dtype:
masked positions take -1e9 (in the input's dtype) before a max, 0 before
a sum; the single-head attention's logits and softmax run in f32 and the
probabilities are cast back before their product with the input.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from audio8_tpu_torch.nn.dropout import dropout
from audio8_tpu_torch.nn.layers import Dense
from audio8_tpu_torch.nn.transformer import NEG_INF


def _neg(x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(NEG_INF, dtype=x.dtype, device=x.device)


def _masked_max(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, x, _neg(x)).amax(dim=1)


def _masked_sum(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(valid, x, zero).sum(dim=1)


def _mean_den(lengths: torch.Tensor, dtype) -> torch.Tensor:
    return torch.clamp(lengths[:, None].to(dtype), min=1.0)


class MaxPool1D(nn.Module):
    """Masked max over time."""

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        valid = (torch.arange(x.shape[1], device=x.device)[None, :, None]
                 < lengths[:, None, None])
        return _masked_max(x, valid)


class MeanPool1D(nn.Module):
    """Masked mean over time."""

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        valid = (torch.arange(x.shape[1], device=x.device)[None, :, None]
                 < lengths[:, None, None])
        s = _masked_sum(x, valid)
        return s / _mean_den(lengths, s.dtype)


class SingleHeadReduction(nn.Module):
    """Single-head attention reduction: queries and keys project to
    ``d_k`` (``w_Q``, ``w_K``; the logits unscaled, as the reduction menu
    builds it), the values are the input itself; the attention output is
    pooled over time by ``pooling``: ``sqrt_length`` (sum times length **
    -0.5), ``max`` or ``mean``."""

    def __init__(self, d_model: int, d_k: int = 64,
                 dropout_rate: float = 0.0, pooling: str = "sqrt_length",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pooling = pooling
        self.dropout_rate = dropout_rate
        self.compute_dtype = dtype
        self.w_Q = Dense(d_model, d_k, dtype=dtype)
        self.w_K = Dense(d_model, d_k, dtype=dtype)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, T, C); pad_mask (B, T) bool, True = valid."""
        dt = self.compute_dtype
        q, k = self.w_Q(x), self.w_K(x)
        logits = torch.matmul(q.float(), k.float().transpose(1, 2))
        logits = torch.where(pad_mask[:, None, :], logits,
                             torch.tensor(NEG_INF, device=x.device))
        probs = torch.softmax(logits, dim=-1).to(dt)
        rate = self.dropout_rate if generator is not None else 0.0
        probs = dropout(probs, rate, generator)
        out = torch.matmul(probs, x.to(dt))  # (B, T, C)
        valid = pad_mask[..., None]
        lengths = pad_mask.sum(dim=-1)
        if self.pooling == "max":
            return _masked_max(out, valid)
        s = _masked_sum(out, valid)
        if self.pooling == "mean":
            return s / _mean_den(lengths, s.dtype)
        return s * torch.rsqrt(
            _mean_den(lengths, torch.float32)).to(s.dtype)


class TwoHeadConcat(nn.Module):
    """Two single-head reductions (``head_0``, ``head_1``), concatenated
    to (B, 2C)."""

    def __init__(self, d_model: int, d_k: int = 64,
                 dropout_rate: float = 0.0, pooling: str = "sqrt_length",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        args = (d_model, d_k, dropout_rate, pooling, dtype)
        self.head_0 = SingleHeadReduction(*args)
        self.head_1 = SingleHeadReduction(*args)

    def forward(self, x, pad_mask, generator=None):
        return torch.cat([self.head_0(x, pad_mask, generator),
                          self.head_1(x, pad_mask, generator)], dim=-1)


_POOLING = {"": "sqrt_length", "_max": "max", "_mean": "mean"}


class Reduction(nn.Module):
    """The reduction menu. Output (B, C) for every type but ``none``,
    which returns the sequence and its pad mask unchanged. The attention
    types hold their heads as ``head`` (``sha*``: a
    :class:`SingleHeadReduction`; ``2ha*``: a :class:`TwoHeadConcat` and
    the ``squeeze`` Dense back to ``d_model``)."""

    def __init__(self, reduction_type: str, d_model: int, d_k: int = 64,
                 dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        rt = reduction_type.lower()
        self.reduction_type = rt
        for prefix, cls in (("2ha", TwoHeadConcat),
                            ("sha", SingleHeadReduction)):
            if rt.startswith(prefix) and rt[3:] in _POOLING:
                self.head = cls(d_model, d_k, dropout_rate,
                                _POOLING[rt[3:]], dtype)
                if prefix == "2ha":
                    self.squeeze = Dense(2 * d_model, d_model, dtype=dtype)
                return
        if rt not in ("max", "mean", "none"):
            raise ValueError(f"Unknown reduction type {reduction_type!r}")

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        rt = self.reduction_type
        if rt.startswith("2ha"):
            return self.squeeze(self.head(x, pad_mask, generator))
        if rt.startswith("sha"):
            return self.head(x, pad_mask, generator)
        if rt == "none":
            return x, pad_mask
        lengths = pad_mask.sum(dim=-1)
        return (MaxPool1D() if rt == "max" else MeanPool1D())(x, lengths)


def make_reduction(reduction_type: str, d_model: int, d_k: int = 64,
                   dropout_rate: float = 0.0, **kwargs) -> Reduction:
    return Reduction(reduction_type, d_model, d_k, dropout_rate, **kwargs)
