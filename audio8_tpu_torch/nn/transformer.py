"""Transformer encoder of the port (``audio8_tpu/nn/transformer.py``).

Post-norm self-attention layers under a key-validity mask. The
attention follows the JAX ``MultiHeadAttention``'s dispatch:

======================  ====================  ============================
``fused_attention``     JAX package           port
======================  ====================  ============================
None                    XLA attention         core kernel, "xla"
True, gate passes       Pallas core           core kernel, "kernel"
True, gate refuses      XLA attention         core kernel, "xla"
"block", gate passes    Pallas block          block kernel
"block", gate refuses   XLA attention         core kernel, "xla"
======================  ====================  ============================

The gate is the JAX ``structural_ok``: at most 1024 frames and a head
dim of at most 128 (the block also wants a head dim its kernels take).
The core kernel is ``ops.attention.attention_core`` in one of its two
semantics (the TPU kernel's, or the XLA attention's with
``bf16_softmax``'s bf16 logits); the block is
``ops.attention_block.attention_block`` (the JAX
``attention_block_kernel``). In training (a ``generator`` is passed) the
attention probabilities drop out inside the kernel with one seed per
layer call, and the two residual branches take hash dropout, each seed
drawn from the generator. Module
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


# the JAX gates' bounds on T and the head dim
# (``attention_kernel.structural_ok``)
BLOCK_MAX_FRAMES = 1024
GATE_MAX_HEAD_DIM = 128


class MultiHeadAttention(nn.Module):
    """Self-attention: Q/K/V projections, the fused attention core with a
    key-validity mask, output projection. Layout (B, T, D) in and out;
    heads are split to (B, H, T, dh) for the core. ``fused_attention``
    picks the path as the module docstring's table says;
    ``bf16_softmax`` is the JAX field (read by the "xla" semantics)."""

    def __init__(self, num_heads: int, d_model: int,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0, fused_attention=None,
                 bf16_softmax: bool = True):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} % num_heads {num_heads}")
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate  # on the attention probabilities
        self.fused_attention = fused_attention
        self.bf16_softmax = bf16_softmax
        self.d_head = d_model // num_heads
        self.q_proj = Dense(d_model, d_model, dtype=dtype)
        self.k_proj = Dense(d_model, d_model, dtype=dtype)
        self.v_proj = Dense(d_model, d_model, dtype=dtype)
        self.out_proj = Dense(d_model, d_model, dtype=dtype)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        return x.reshape(b, t, self.num_heads, self.d_head).permute(
            0, 2, 1, 3).contiguous()

    def gate(self, t: int) -> bool:
        """The JAX ``structural_ok`` for this module's inputs: T <= 1024
        and d_head <= 128. The port's attention is always self-attention
        under a key-validity mask with no cache or relative positions,
        the gate's other conditions."""
        return t <= BLOCK_MAX_FRAMES and self.d_head <= GATE_MAX_HEAD_DIM

    def block_eligible(self, t: int) -> bool:
        """The JAX ``_block_eligible`` gate: the block is asked for, the
        gate passes and the head dim is one the kernels take."""
        return (self.fused_attention == "block" and self.gate(t)
                and self.d_head in HEAD_DIMS)

    def xla_semantics(self, t: int) -> bool:
        """Whether the core computes the JAX XLA attention (every path
        but ``fused_attention=True`` under the gate, the TPU kernel's)."""
        return not (self.fused_attention is True and self.gate(t))

    def forward(self, x: torch.Tensor,
                key_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``key_valid``: optional (B, T) bool, True = attend. With a
        ``generator`` the probabilities drop out at ``dropout_rate``, one
        seed drawn per call at the point where the JAX module draws it
        (the core's semantics say how the mask derives from it)."""
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
        out = attention_core(q, k, v, key_valid, scale, rate, seed,
                             xla=self.xla_semantics(x.shape[1]),
                             bf16_softmax=self.bf16_softmax)
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
                 fused_attention=None, bf16_softmax: bool = True):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.self_attn = MultiHeadAttention(
            num_heads, d_model, dtype,
            dropout_rate if attention_dropout is None else attention_dropout,
            fused_attention, bf16_softmax)
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
                 layer_drop: float = 0.0, fused_attention=None,
                 bf16_softmax: bool = True):
        super().__init__()
        d_ff = d_ff or 4 * d_model
        self.layer_drop = layer_drop
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(num_heads, d_model, d_ff, dtype,
                                    dropout_rate, attention_dropout,
                                    fused_attention, bf16_softmax)
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
