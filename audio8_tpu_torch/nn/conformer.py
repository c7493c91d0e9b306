"""Conformer encoder blocks of the port (``audio8_tpu/nn/conformer.py``),
the wav2vec2-conformer family.

Each block is the macaron layout: a half-step FFN, self-attention with
rotary (RoPE) or Transformer-XL relative positions, the convolution
module (pointwise GLU, depthwise conv, the folded-BatchNorm affine,
swish, pointwise), a second half-step FFN and a final LayerNorm. The
JAX package computes all of it with XLA (no kernel), so the port
computes it as torch ops that follow the JAX code step by step: the
positional tables are built with numpy once per length, q and k
products are summed in f32, under bf16 ``bf16_softmax`` rounds the
logits to bf16 before the softmax, and the GLU's and swish's sigmoid
rounds op by op as XLA's expansion does (:func:`sigmoid`). The
BatchNorm runs in frozen-statistics form: ``models/convert.py`` folds
the running statistics into ``bn_folded`` (exact at inference), and
training trains the affine, as in JAX.

Modules and parameters keep HF's names (``ffn1_layer_norm``,
``ffn1.intermediate_dense``, ``self_attn.linear_{q,k,v,out,pos}``,
``pos_bias_{u,v}``, ``conv_module.{layer_norm, pointwise_conv1,
depthwise_conv, pointwise_conv2}``, ``final_layer_norm``), the keys of
``audio8_tpu/models/convert.py``'s conformer table, so the checkpoints
load by name. HF's conformer encoder builds a positional conv it never
applies; the port has none.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from audio8_tpu_torch.nn.dropout import dropout
from audio8_tpu_torch.nn.layers import Dense, GroupedConv, LayerNorm, gelu
from audio8_tpu_torch.nn.transformer import NEG_INF, softmax


class _LowPrecisionSigmoid(torch.autograd.Function):
    """``jax.nn.sigmoid`` below f32 as XLA expands it, each op rounded in
    x's dtype: ``1 / (1 + exp(-x))``; backward its JVP's ``g * (y * (1 -
    y))``, op by op (``torch.sigmoid`` rounds once and differs from JAX
    on about a third of bf16 inputs)."""

    @staticmethod
    def forward(ctx, x):
        y = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1.0 - y))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: ``torch.sigmoid`` in f32,
    :class:`_LowPrecisionSigmoid` below it."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return _LowPrecisionSigmoid.apply(x)


def activation(name: str):
    """The JAX ``_activation``: swish/silu as ``x * sigmoid(x)`` with
    :func:`sigmoid`, so below f32 it rounds where ``jax.nn.silu`` does."""
    if name == "gelu":
        return gelu
    if name == "relu":
        return torch.relu
    if name in ("swish", "silu"):
        return lambda x: x * sigmoid(x)
    raise ValueError(f"Unknown activation {name!r}")


def rotary_tables(t: int, d_head: int, base: float = 10000.0):
    """RoPE cos/sin tables, (t, d_head) each, f32 (HF duplicates the
    half-dim frequency vector)."""
    inv_freq = 1.0 / (base ** (np.arange(0, d_head, 2) / d_head))
    freqs = np.arange(t)[:, None] * inv_freq[None, :]
    emb = np.concatenate([freqs, freqs], axis=-1)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


def relative_sinusoid_table(t: int, d_model: int) -> np.ndarray:
    """Transformer-XL relative position table, (2t-1, d_model) f32:
    positive distances first, reversed, then negative (HF
    ``Wav2Vec2ConformerRelPositionalEmbedding``)."""
    pos = np.arange(t)[:, None]
    div = np.exp(np.arange(0, d_model, 2) * -(np.log(10000.0) / d_model))
    pe_pos = np.zeros((t, d_model))
    pe_neg = np.zeros((t, d_model))
    pe_pos[:, 0::2] = np.sin(pos * div)
    pe_pos[:, 1::2] = np.cos(pos * div)
    pe_neg[:, 0::2] = np.sin(-pos * div)
    pe_neg[:, 1::2] = np.cos(-pos * div)
    return np.concatenate([pe_pos[::-1], pe_neg[1:]]).astype(np.float32)


def _table(kind: str, t: int, dim: int, base: float, device: torch.device,
           dtype: torch.dtype):
    """A positional table on ``device`` in ``dtype``: ``"rotary"`` gives
    (cos, sin), ``"relative"`` the XL sinusoid table."""
    if kind == "rotary":
        return tuple(torch.from_numpy(a).to(device, dtype)
                     for a in rotary_tables(t, dim, base))
    return torch.from_numpy(relative_sinusoid_table(t, dim)).to(device, dtype)


@functools.lru_cache(maxsize=8)
def _device_table(kind: str, t: int, dim: int, base: float,
                  device: torch.device, dtype: torch.dtype):
    """:func:`_table`, built once per length (a constant of the shape, as
    under JAX's jit). Built outside inference mode, so a training forward
    may save it for backward whichever call built it."""
    with torch.inference_mode(False):
        return _table(kind, t, dim, base, device, dtype)


def position_table(kind: str, t: int, dim: int, base: float,
                   device: torch.device, dtype: torch.dtype):
    """The cached :func:`_device_table`, but under a trace
    (``torch.export``) a table of its own, a constant of the program: a
    cached one would hold the trace's fake tensor."""
    build = _table if torch.compiler.is_compiling() else _device_table
    return build(kind, t, dim, base, device, dtype)


class ConformerAttention(nn.Module):
    """Self-attention with rotary or Transformer-XL relative positions
    (HF ``Wav2Vec2ConformerSelfAttention``), ``mask`` broadcastable to
    (B, H, T, T), True = attend."""

    def __init__(self, num_heads: int, d_model: int,
                 position_embeddings_type: str = "relative",
                 rotary_base: float = 10000.0, dropout_rate: float = 0.0,
                 bf16_softmax: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} % num_heads {num_heads}")
        self.num_heads, self.d_model = num_heads, d_model
        self.d_head = d_model // num_heads
        self.position_embeddings_type = position_embeddings_type
        self.rotary_base = rotary_base
        self.dropout_rate = dropout_rate
        self.bf16_softmax = bf16_softmax
        self.compute_dtype = dtype
        for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
            self.add_module(name, Dense(d_model, d_model, dtype=dtype))
        if position_embeddings_type == "relative":
            self.linear_pos = Dense(d_model, d_model, bias=False, dtype=dtype)
            self.pos_bias_u = nn.Parameter(torch.zeros(num_heads,
                                                       self.d_head))
            self.pos_bias_v = nn.Parameter(torch.zeros(num_heads,
                                                       self.d_head))

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        return x.reshape(b, t, self.num_heads, self.d_head).permute(0, 2, 1, 3)

    def _rotate(self, x: torch.Tensor) -> torch.Tensor:
        """RoPE on the attention input (B, T, D): HF rotates the hidden
        states before the q/k projections."""
        b, t, _ = x.shape
        cos, sin = (a[None, :, None, :] for a in position_table(
            "rotary", t, self.d_head, self.rotary_base, x.device, x.dtype))
        h = x.reshape(b, t, self.num_heads, self.d_head)
        half = self.d_head // 2
        rot = torch.cat([-h[..., half:], h[..., :half]], dim=-1)
        return (h * cos + rot * sin).reshape(b, t, self.d_model)

    def _relative_scores(self, q: torch.Tensor, k: torch.Tensor,
                         t: int) -> torch.Tensor:
        """Transformer-XL scores: ``(q + u) k^T`` plus ``(q + v) R^T``
        realigned from the (T, 2T-1) distance axis by the shift trick,
        over sqrt(dh), in f32."""
        dt = q.dtype
        pe = position_table("relative", t, self.d_model, 0.0, q.device,
                           dt)[None]
        r = self._split(self.linear_pos(pe))  # (1, H, 2T-1, dh)
        u = self.pos_bias_u.to(dt)[None, :, None, :]
        v = self.pos_bias_v.to(dt)[None, :, None, :]
        ac = torch.matmul((q + u).float(), k.float().transpose(-1, -2))
        bd = torch.matmul((q + v).float(), r.float().transpose(-1, -2))
        b, h, _, rr = bd.shape
        padded = torch.nn.functional.pad(bd, (1, 0))
        padded = padded.reshape(b, h, rr + 1, t)[:, :, 1:, :]
        bd = padded.reshape(b, h, t, rr)[..., :t]
        return (ac + bd) / np.float32(math.sqrt(self.d_head))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.to(dt)
        qk_in = self._rotate(x) if self.position_embeddings_type == \
            "rotary" else x
        q = self._split(self.linear_q(qk_in))
        k = self._split(self.linear_k(qk_in))
        v = self._split(self.linear_v(x))
        t = x.shape[1]
        if self.position_embeddings_type == "relative":
            logits = self._relative_scores(q, k, t)
        else:
            logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
            logits = logits / np.float32(math.sqrt(self.d_head))
        if mask is not None:
            logits = torch.where(mask, logits, torch.tensor(
                NEG_INF, dtype=logits.dtype, device=logits.device))
        if self.bf16_softmax and dt != torch.float32:
            probs = softmax(logits.to(dt))
        else:
            probs = softmax(logits).to(dt)
        rate = self.dropout_rate if generator is not None else 0.0
        probs = dropout(probs, rate, generator)
        out = torch.matmul(probs, v)
        b, h, tq, d = out.shape
        return self.linear_out(out.permute(0, 2, 1, 3).reshape(b, tq, h * d))


class _FoldedBatchNorm(nn.Module):
    """The conv module's BatchNorm as a per-channel affine (``scale``,
    ``bias``): running statistics folded in at load time."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))


class ConformerConvModule(nn.Module):
    """LN -> pointwise(2C) -> GLU -> depthwise(k, SAME) -> folded-BN
    affine -> activation -> pointwise(C) -> dropout."""

    def __init__(self, d_model: int, kernel_size: int = 31,
                 activation_name: str = "swish", dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("depthwise kernel must be odd")
        self.d_model = d_model
        self.dropout_rate = dropout_rate
        self.act = activation(activation_name)
        self.layer_norm = LayerNorm(d_model, dtype)
        self.pointwise_conv1 = Dense(d_model, 2 * d_model, bias=False,
                                     dtype=dtype)
        self.depthwise_conv = GroupedConv(d_model, kernel_size, d_model,
                                          use_bias=False, dtype=dtype)
        self.bn_folded = _FoldedBatchNorm(d_model)
        self.pointwise_conv2 = Dense(d_model, d_model, bias=False,
                                     dtype=dtype)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.pointwise_conv1(self.layer_norm(x))
        h = h[..., :self.d_model] * sigmoid(h[..., self.d_model:])
        h = self.depthwise_conv(h)
        h = h * self.bn_folded.scale.to(h.dtype) + \
            self.bn_folded.bias.to(h.dtype)
        h = self.pointwise_conv2(self.act(h))
        return dropout(h, self.dropout_rate, generator)


class ConformerFFN(nn.Module):
    """expand -> activation -> dropout -> contract -> dropout."""

    def __init__(self, d_model: int, d_ff: int, activation_name: str,
                 dropout_rate: float, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.act = activation(activation_name)
        self.intermediate_dense = Dense(d_model, d_ff, dtype=dtype)
        self.output_dense = Dense(d_ff, d_model, dtype=dtype)

    def forward(self, x, generator=None):
        h = dropout(self.act(self.intermediate_dense(x)), self.dropout_rate,
                    generator)
        return dropout(self.output_dense(h), self.dropout_rate, generator)


class ConformerBlock(nn.Module):
    """``x + FFN/2``, ``x + drop(attn(LN x))``, ``x + conv(x)``, ``x +
    FFN/2``, final LayerNorm."""

    def __init__(self, num_heads: int, d_model: int, d_ff: int,
                 position_embeddings_type: str = "relative",
                 rotary_base: float = 10000.0, conv_kernel_size: int = 31,
                 activation_name: str = "swish", dropout_rate: float = 0.1,
                 attention_dropout: Optional[float] = None,
                 bf16_softmax: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout_rate = dropout_rate
        ffn = (d_model, d_ff, activation_name, dropout_rate, dtype)
        self.ffn1_layer_norm = LayerNorm(d_model, dtype)
        self.ffn1 = ConformerFFN(*ffn)
        self.self_attn_layer_norm = LayerNorm(d_model, dtype)
        self.self_attn = ConformerAttention(
            num_heads, d_model, position_embeddings_type, rotary_base,
            dropout_rate if attention_dropout is None else attention_dropout,
            bf16_softmax, dtype)
        self.conv_module = ConformerConvModule(
            d_model, conv_kernel_size, activation_name, dropout_rate, dtype)
        self.ffn2_layer_norm = LayerNorm(d_model, dtype)
        self.ffn2 = ConformerFFN(*ffn)
        self.final_layer_norm = LayerNorm(d_model, dtype)

    def num_seeds(self) -> int:
        """The seeds a training forward draws: two per FFN, the attention
        probabilities', the residual and the conv module's."""
        return (6 * (self.dropout_rate > 0.0)
                + (self.self_attn.dropout_rate > 0.0))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + 0.5 * self.ffn1(self.ffn1_layer_norm(x), generator)
        a = self.self_attn(self.self_attn_layer_norm(x), mask, generator)
        x = x + dropout(a, self.dropout_rate, generator)
        x = x + self.conv_module(x, generator)
        x = x + 0.5 * self.ffn2(self.ffn2_layer_norm(x), generator)
        return self.final_layer_norm(x)
