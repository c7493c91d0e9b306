"""Transformer encoder of the port (``audio8_tpu/nn/transformer.py``).

The serving slice's encoder: post-norm self-attention layers whose
attention core is the hand-written kernel ``ops.attention.attention_core``
(the JAX package's ``fused_attention=True`` path) under a key-validity
mask. Module and parameter names follow fairseq's wav2vec2 encoder
(``self_attn.{q,k,v,out}_proj``, ``self_attn_layer_norm``, ``fc1``,
``fc2``, ``final_layer_norm``, ``layers.{i}``) so checkpoints load by
prefix. The JAX module's other features (pre-norm, relative positions,
decode caches, causal or biased masks, MoE, packed QKV, flash) are not
ported yet: ``models/wav2vec2.py`` refuses configs that ask for them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from audio8_tpu_torch.nn.layers import Dense, LayerNorm, gelu
from audio8_tpu_torch.ops.attention import attention_core


class MultiHeadAttention(nn.Module):
    """Self-attention: Q/K/V projections, the fused attention core with a
    key-validity mask, output projection. Layout (B, T, D) in and out;
    heads are split to (B, H, T, dh) for the core."""

    def __init__(self, num_heads: int, d_model: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} % num_heads {num_heads}")
        self.num_heads = num_heads
        self.d_head = d_model // num_heads
        self.q_proj = Dense(d_model, d_model, dtype=dtype)
        self.k_proj = Dense(d_model, d_model, dtype=dtype)
        self.v_proj = Dense(d_model, d_model, dtype=dtype)
        self.out_proj = Dense(d_model, d_model, dtype=dtype)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        return x.reshape(b, t, self.num_heads, self.d_head).permute(
            0, 2, 1, 3).contiguous()

    def forward(self, x: torch.Tensor,
                key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``key_valid``: optional (B, T) bool, True = attend. Eval: the
        attention-probability dropout waits for the training slice."""
        q, k, v = (self._split(p(x)) for p in (self.q_proj, self.k_proj,
                                               self.v_proj))
        out = attention_core(q, k, v, key_valid, 1.0 / math.sqrt(self.d_head))
        b, h, t, d = out.shape
        return self.out_proj(out.permute(0, 2, 1, 3).reshape(b, t, h * d))


def ffn(x: torch.Tensor, fc1: Dense, fc2: Dense) -> torch.Tensor:
    """The position-wise FFN (``audio8_tpu/nn/transformer.py:FFN``):
    ``fc2(gelu(fc1(x)))``. A function over the layer's own ``fc1``/``fc2``
    so the parameters keep fairseq's names."""
    return fc2(gelu(fc1(x)))


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer (wav2vec2-base):
    ``x = LN(x + attn(x)); x = LN(x + ffn(x))``."""

    def __init__(self, num_heads: int, d_model: int, d_ff: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self_attn = MultiHeadAttention(num_heads, d_model, dtype)
        self.self_attn_layer_norm = LayerNorm(d_model, dtype)
        self.fc1 = Dense(d_model, d_ff, dtype=dtype)
        self.fc2 = Dense(d_ff, d_model, dtype=dtype)
        self.final_layer_norm = LayerNorm(d_model, dtype)

    def forward(self, x: torch.Tensor,
                key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.self_attn_layer_norm(x + self.self_attn(x, key_valid))
        return self.final_layer_norm(x + ffn(x, self.fc1, self.fc2))


class TransformerEncoderStack(nn.Module):
    """``num_layers`` post-norm layers in ``self.layers``."""

    def __init__(self, num_heads: int, d_model: int, num_layers: int,
                 d_ff: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d_ff = d_ff or 4 * d_model
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(num_heads, d_model, d_ff, dtype)
            for _ in range(num_layers))

    def forward(self, x: torch.Tensor,
                key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, key_valid)
        return x
