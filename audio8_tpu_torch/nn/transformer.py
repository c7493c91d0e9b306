"""Transformer encoder of the port (``audio8_tpu/nn/transformer.py``).

Post-norm self-attention layers whose attention core is the
hand-written kernel ``ops.attention.attention_core`` (the JAX package's
``fused_attention=True`` path) under a key-validity mask. With
``fused_attention="block"`` a layer whose frames pass the JAX package's
gate (at most 1024 frames, a head dim the kernels take) runs its
projections and core as one call, ``ops.attention_block.attention_block``
(the JAX ``attention_block_kernel``); longer inputs take the core path.
In training (a ``generator`` is passed) the attention probabilities drop
out inside the kernel with one seed per layer call, and the two residual
branches take hash dropout, each seed drawn from the generator. Module
and parameter names follow fairseq's wav2vec2 encoder
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

from audio8_tpu_torch.nn.dropout import dropout
from audio8_tpu_torch.nn.layers import Dense, LayerNorm, gelu
from audio8_tpu_torch.ops.attention import attention_core
from audio8_tpu_torch.ops.attention_block import HEAD_DIMS, attention_block
from audio8_tpu_torch.ops.hashrand import draw_seed


# the JAX gate's bound on T (``attention_kernel.structural_ok``)
BLOCK_MAX_FRAMES = 1024


class MultiHeadAttention(nn.Module):
    """Self-attention: Q/K/V projections, the fused attention core with a
    key-validity mask, output projection. Layout (B, T, D) in and out;
    heads are split to (B, H, T, dh) for the core. ``fused_attention``:
    None or True, the core; "block", the attention block where
    :meth:`block_eligible` admits the input."""

    def __init__(self, num_heads: int, d_model: int,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0, fused_attention=None):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} % num_heads {num_heads}")
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate  # on the attention probabilities
        self.fused_attention = fused_attention
        self.d_head = d_model // num_heads
        self.q_proj = Dense(d_model, d_model, dtype=dtype)
        self.k_proj = Dense(d_model, d_model, dtype=dtype)
        self.v_proj = Dense(d_model, d_model, dtype=dtype)
        self.out_proj = Dense(d_model, d_model, dtype=dtype)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        return x.reshape(b, t, self.num_heads, self.d_head).permute(
            0, 2, 1, 3).contiguous()

    def block_eligible(self, t: int) -> bool:
        """The JAX ``_block_eligible`` gate for this module's inputs: the
        block is asked for, T <= 1024 and the head dim is one the kernels
        take (the JAX gate: d_head <= 128). The port's attention is always
        self-attention under a key-validity mask, the gate's other
        conditions."""
        return (self.fused_attention == "block" and t <= BLOCK_MAX_FRAMES
                and self.d_head in HEAD_DIMS)

    def forward(self, x: torch.Tensor,
                key_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``key_valid``: optional (B, T) bool, True = attend. With a
        ``generator`` the probabilities drop out at ``dropout_rate`` (head
        (b, h) seeded ``seed + b*H + h`` inside the kernel; the seed is
        drawn at the same point on both paths)."""
        rate = self.dropout_rate if generator is not None else 0.0
        scale = 1.0 / math.sqrt(self.d_head)
        if self.block_eligible(x.shape[1]):
            seed = draw_seed(generator) if rate > 0.0 else 0
            dt = self.q_proj.compute_dtype
            params = [t.to(dt) for m in (self.q_proj, self.k_proj,
                                         self.v_proj, self.out_proj)
                      for t in (m.weight, m.bias)]
            return attention_block(x.to(dt).contiguous(), *params, key_valid,
                                   self.num_heads, scale, rate, seed)
        q, k, v = (self._split(p(x)) for p in (self.q_proj, self.k_proj,
                                               self.v_proj))
        seed = draw_seed(generator) if rate > 0.0 else 0
        out = attention_core(q, k, v, key_valid, scale, rate, seed)
        b, h, t, d = out.shape
        return self.out_proj(out.permute(0, 2, 1, 3).reshape(b, t, h * d))


def ffn(x: torch.Tensor, fc1: Dense, fc2: Dense) -> torch.Tensor:
    """The position-wise FFN (``audio8_tpu/nn/transformer.py:FFN``):
    ``fc2(gelu(fc1(x)))``. A function over the layer's own ``fc1``/``fc2``
    so the parameters keep fairseq's names."""
    return fc2(gelu(fc1(x)))


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer (wav2vec2-base):
    ``x = LN(x + drop(attn(x))); x = LN(x + drop(ffn(x)))``; the
    attention-probability rate defaults to ``dropout_rate``."""

    def __init__(self, num_heads: int, d_model: int, d_ff: int,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0,
                 attention_dropout: Optional[float] = None,
                 fused_attention=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.self_attn = MultiHeadAttention(
            num_heads, d_model, dtype,
            dropout_rate if attention_dropout is None else attention_dropout,
            fused_attention)
        self.self_attn_layer_norm = LayerNorm(d_model, dtype)
        self.fc1 = Dense(d_model, d_ff, dtype=dtype)
        self.fc2 = Dense(d_ff, d_model, dtype=dtype)
        self.final_layer_norm = LayerNorm(d_model, dtype)

    def forward(self, x: torch.Tensor,
                key_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rate = self.dropout_rate
        x = x + dropout(self.self_attn(x, key_valid, generator), rate,
                        generator)
        x = self.self_attn_layer_norm(x)
        x = x + dropout(ffn(x, self.fc1, self.fc2), rate, generator)
        return self.final_layer_norm(x)


class TransformerEncoderStack(nn.Module):
    """``num_layers`` post-norm layers in ``self.layers``. LayerDrop is
    not ported yet: ``layer_drop > 0`` raises in training."""

    def __init__(self, num_heads: int, d_model: int, num_layers: int,
                 d_ff: Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0,
                 attention_dropout: Optional[float] = None,
                 layer_drop: float = 0.0, fused_attention=None):
        super().__init__()
        d_ff = d_ff or 4 * d_model
        self.layer_drop = layer_drop
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(num_heads, d_model, d_ff, dtype,
                                    dropout_rate, attention_dropout,
                                    fused_attention)
            for _ in range(num_layers))

    def forward(self, x: torch.Tensor,
                key_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if generator is not None and self.layer_drop > 0.0:
            raise NotImplementedError(
                "layer_drop > 0 is not ported yet (ROADMAP.md)")
        for layer in self.layers:
            x = layer(x, key_valid, generator)
        return x
