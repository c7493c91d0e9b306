"""Transformer stacks of the port (``audio8_tpu/nn/transformer.py``).

``MultiHeadAttention`` follows the JAX module's dispatch:

==================================  ================  ======================
case                                JAX package       port
==================================  ================  ======================
self-attention, key-validity mask:
 ``fused_attention`` None           XLA attention     core kernel, "xla"
 True, gate passes                  Pallas core       core kernel, "kernel"
 True, gate refuses                 XLA attention     core kernel, "xla"
 "block", gate passes               Pallas block      block kernel
 "block", gate refuses              XLA attention     core kernel, "xla"
``flash_attention`` (off a TPU)     XLA attention     core kernel, "xla"
relative positions (``rpr_k``),     XLA attention     torch composition
 a position bias (WavLM)
other masks (causal chunks),        XLA attention     torch composition
 attention (T_q != T_k)
a static KV cache                   XLA attention     torch composition
``attend_kv``                       XLA, f32 softmax  torch composition,
                                                      f32 softmax
==================================  ================  ======================

The gate is the JAX ``structural_ok``: at most 1024 frames and a head
dim of at most 128 (the block also wants a head dim its kernels take).
The core kernel is ``ops.attention.attention_core`` in one of its two
semantics (the TPU kernel's, or the XLA attention's with
``bf16_softmax``'s bf16 logits); the block is
``ops.attention_block.attention_block`` (the JAX
``attention_block_kernel``). The JAX package computes the other cases
with XLA and never in a Pallas kernel (its ``structural_ok`` refuses rpr,
a cache and T_q != T_k), so the port computes them as torch ops that
follow the JAX code step by step (:meth:`MultiHeadAttention._composed`):
q scaled in its own dtype before the product, under bf16 the logits and
softmax in bf16 (``bf16_softmax``, no rpr), with rpr the logits summed
in f32 and rounded to bf16 before the softmax, and ``attend_kv``'s
softmax in f32. Its probability dropout is the flat (B, H, T_q, T_k)
hash mask of the JAX ``Dropout`` (``nn/dropout.py``: kernel 4 on the
card).

In training (a ``generator`` is passed) every dropout draws its seed
from the generator where the JAX module draws it. The wav2vec2 stack
keeps fairseq's module and parameter names
(``self_attn.{q,k,v,out}_proj``, ``self_attn_layer_norm``, ``fc1``,
``fc2``, ``final_layer_norm``, ``layers.{i}``) so checkpoints load by
prefix; the text encoder and the decoder stacks keep the JAX tree's
(``layer_{i}``, ``self_attn.w_{Q,K,V,O}``, ``rpr_key_emb``,
``ffn.{expand,contract}``, ``ln_*``). The wav2vec2 stack is post-norm or
pre-norm (stable layer norm, its final norm after the layers), with
WavLM's gated relative position bias (:func:`relative_position_bias`,
the bucket table in layer 0's attention as fairseq and HF keep it) and
LayerDrop. Packed Q/K/V is a TPU layout of the same product: the port
computes it unpacked, as it computes flash as the XLA attention. MoE is
not ported; ``models/wav2vec2.py`` refuses configs that ask for it.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from audio8_tpu_torch.nn.dropout import dropout
from audio8_tpu_torch.nn.embeddings import LookupTableEmbeddings
from audio8_tpu_torch.nn.layers import Dense, LayerNorm, gelu
from audio8_tpu_torch.ops.attention import attention_core
from audio8_tpu_torch.ops.attention_block import HEAD_DIMS, attention_block
from audio8_tpu_torch.ops.hashrand import SeedReplay, draw_keep, draw_seed


# the JAX gates' bounds on T and the head dim
# (``attention_kernel.structural_ok``)
BLOCK_MAX_FRAMES = 1024
GATE_MAX_HEAD_DIM = 128
NEG_INF = -1e9  # the JAX masks' large negative: keeps bf16 softmax NaN-free
# the projections' module names: fairseq's (the wav2vec2 stack) or the
# JAX tree's (the text encoder and the decoder)
PROJ_NAMES = {"fairseq": ("q_proj", "k_proj", "v_proj", "out_proj"),
              "jax": ("w_Q", "w_K", "w_V", "w_O")}


class _LowPrecisionSoftmax(torch.autograd.Function):
    """``jax.nn.softmax`` below f32, op by op in x's dtype: forward
    ``exp(x - max)`` over its sum, backward its custom JVP's ``y * (g -
    sum(y * g))``, each op rounded as JAX rounds it (``torch.softmax``
    rounds once, and autograd through the ops would differentiate the
    division instead)."""

    @staticmethod
    def forward(ctx, x, dim):
        e = torch.exp(x - x.amax(dim=dim, keepdim=True))
        y = e / e.sum(dim=dim, keepdim=True)
        ctx.save_for_backward(y)
        ctx.dim = dim
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return y * (g - (y * g).sum(dim=ctx.dim, keepdim=True)), None


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.softmax``: ``torch.softmax`` in f32 (the same
    arithmetic), :class:`_LowPrecisionSoftmax` below it."""
    if x.dtype == torch.float32:
        return torch.softmax(x, dim=dim)
    return _LowPrecisionSoftmax.apply(x, dim)


def relative_position_buckets(t_q: int, t_k: int, num_buckets: int,
                              max_distance: int) -> np.ndarray:
    """WavLM/T5 bidirectional relative-position buckets, (t_q, t_k) int32
    (``audio8_tpu/nn/transformer.py:relative_position_buckets``, numpy
    float64 logs, so the table is the JAX one bit for bit): half the
    buckets for each sign, half of those exact, the rest log-spaced up
    to ``max_distance``."""
    rel = np.arange(t_k)[None, :] - np.arange(t_q)[:, None]
    half = num_buckets // 2
    out = (rel > 0).astype(np.int64) * half
    rel = np.abs(rel)
    max_exact = half // 2
    is_small = rel < max_exact
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact)
        / np.log(max_distance / max_exact) * (half - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, half - 1)
    out += np.where(is_small, rel, large)
    return out.astype(np.int32)


def _bucket_table(t: int, num_buckets: int, max_distance: int,
                  device: torch.device) -> torch.Tensor:
    """:func:`relative_position_buckets` of (t, t) on ``device``."""
    return torch.from_numpy(relative_position_buckets(
        t, t, num_buckets, max_distance)).to(device, torch.long)


@functools.lru_cache(maxsize=8)
def _bucket_ids(t: int, num_buckets: int, max_distance: int,
                device: torch.device) -> torch.Tensor:
    """:func:`_bucket_table`, built once per length: the table is a
    constant of the shape, as it is under JAX's jit. Built outside
    inference mode, so a training forward may save it for backward
    whichever call built it."""
    with torch.inference_mode(False):
        return _bucket_table(t, num_buckets, max_distance, device)


def bucket_ids(t: int, num_buckets: int, max_distance: int,
               device: torch.device) -> torch.Tensor:
    """The cached :func:`_bucket_ids`, but under a trace
    (``torch.export``) a table of its own, a constant of the program: a
    cached one would hold the trace's fake tensor."""
    build = _bucket_table if torch.compiler.is_compiling() else _bucket_ids
    return build(t, num_buckets, max_distance, device)


def relative_position_bias(embed: torch.Tensor, t: int, num_buckets: int,
                           max_distance: int,
                           dtype: torch.dtype) -> torch.Tensor:
    """The shared (1, H, T, T) bias of a WavLM stack
    (``RelativePositionBias``): the ``(num_buckets, H)`` table looked up
    at the bucket ids, in the compute dtype as flax's ``Embed`` gives
    it."""
    buckets = bucket_ids(t, num_buckets, max_distance, embed.device)
    return embed.to(dtype)[buckets].permute(2, 0, 1)[None]


class MultiHeadAttention(nn.Module):
    """Q/K/V projections, attention, output projection; layout (B, T, D)
    in and out, heads split to (B, H, T, dh). Self-attention under a
    key-validity mask takes the kernels as the module docstring's table
    says (``fused_attention``; ``bf16_softmax`` is the JAX field, read by
    the "xla" semantics); relative positions (``rpr_k``, with
    ``rpr_value_on`` also on the values), other masks, cross attention
    and the KV cache take the torch composition. ``names`` picks the
    projections' module names (:data:`PROJ_NAMES`). q is scaled by
    1/sqrt(dh), as every caller of the JAX module asks."""

    def __init__(self, num_heads: int, d_model: int,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0, fused_attention=None,
                 bf16_softmax: bool = True, *, rpr_k: Optional[int] = None,
                 rpr_value_on: bool = False, names: str = "fairseq",
                 flash: bool = False, gated_rel_pos: bool = False,
                 rel_pos_buckets: int = 0):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} % num_heads {num_heads}")
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate  # on the attention probabilities
        self.fused_attention = fused_attention
        self.bf16_softmax = bf16_softmax
        self.compute_dtype = dtype
        self.rpr_k = rpr_k
        self.rpr_value_on = rpr_value_on
        self.flash = flash
        self.gated_rel_pos = gated_rel_pos
        self.d_head = d_model // num_heads
        self.proj_names = PROJ_NAMES[names]
        for name in self.proj_names:
            self.add_module(name, Dense(d_model, d_model, dtype=dtype))
        if gated_rel_pos:
            # WavLM's per-layer gate (fairseq/HF names)
            self.gru_rel_pos_linear = Dense(self.d_head, 8, dtype=dtype)
            self.gru_rel_pos_const = nn.Parameter(
                torch.ones(1, num_heads, 1, 1))
        if rel_pos_buckets:
            # the stack's shared bucket table, in layer 0 as fairseq has it
            self.rel_attn_embed = nn.Embedding(rel_pos_buckets, num_heads)
            nn.init.zeros_(self.rel_attn_embed.weight)
        if rpr_k is not None:
            self.rpr_key_emb = LookupTableEmbeddings(2 * rpr_k + 1,
                                                     self.d_head, dtype)
            if rpr_value_on:
                self.rpr_value_emb = LookupTableEmbeddings(
                    2 * rpr_k + 1, self.d_head, dtype)

    def init_from(self, generator: torch.Generator) -> None:
        """The bucket table's random init (flax ``Embed``'s: normal with
        std 1/sqrt(H)); the gate constant stays at one."""
        if hasattr(self, "rel_attn_embed"):
            w = self.rel_attn_embed.weight
            with torch.no_grad():
                w.copy_(torch.randn(w.shape, generator=generator,
                                    device=generator.device)
                        / math.sqrt(w.shape[1]))

    def projections(self):
        """The Q, K, V and output ``Dense`` modules."""
        return tuple(getattr(self, n) for n in self.proj_names)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        return x.reshape(b, t, self.num_heads, self.d_head).permute(
            0, 2, 1, 3).contiguous()

    def _merge(self, out: torch.Tensor) -> torch.Tensor:
        b, h, t, d = out.shape
        return self.projections()[3](out.permute(0, 2, 1, 3).reshape(
            b, t, h * d))

    def gate(self, t: int) -> bool:
        """The JAX ``structural_ok`` for self-attention under a
        key-validity mask with no cache or relative positions: T <= 1024
        and d_head <= 128."""
        return t <= BLOCK_MAX_FRAMES and self.d_head <= GATE_MAX_HEAD_DIM

    def block_eligible(self, t: int) -> bool:
        """The JAX ``_block_eligible`` gate: the block is asked for, no
        flash, no WavLM gate, the gate passes and the head dim is one the
        kernels take."""
        return (self.fused_attention == "block" and not self.flash
                and not self.gated_rel_pos and self.gate(t)
                and self.d_head in HEAD_DIMS)

    def xla_semantics(self, t: int) -> bool:
        """Whether the core computes the JAX XLA attention (every path
        but ``fused_attention=True`` under the gate without flash, the
        TPU kernel's; flash off a TPU is the XLA attention in JAX)."""
        return not (self.fused_attention is True and not self.flash
                    and self.gate(t))

    def qkv(self, x: torch.Tensor, key: Optional[torch.Tensor] = None,
            value: Optional[torch.Tensor] = None):
        """Split Q, K and V heads (``key``/``value`` default to ``x``)."""
        wq, wk, wv, _ = self.projections()
        key = x if key is None else key
        value = key if value is None else value
        return self._split(wq(x)), self._split(wk(key)), self._split(wv(value))

    def gate_bias(self, x: torch.Tensor,
                  position_bias: torch.Tensor) -> torch.Tensor:
        """WavLM's gated bias (HF ``WavLMAttention`` steps 1-4) in f32:
        per-head slices of the attention input -> Dense(8) -> (2, 4) sums
        -> sigmoid -> ``a * (b * const - 1) + 2`` times the bias."""
        b, t, _ = x.shape
        g = x.reshape(b, t, self.num_heads, self.d_head).permute(0, 2, 1, 3)
        proj = self.gru_rel_pos_linear(g).float()
        gates = torch.sigmoid(proj.reshape(proj.shape[:-1] + (2, 4)).sum(-1))
        gate_a, gate_b = gates[..., :1], gates[..., 1:]
        const = self.gru_rel_pos_const.float()
        return (gate_a * (gate_b * const - 1.0) + 2.0) * position_bias.float()

    def forward(self, x: torch.Tensor,
                key_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, *,
                key: Optional[torch.Tensor] = None,
                value: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                cache: Optional[dict] = None, cache_index: int = 0,
                position_bias: Optional[torch.Tensor] = None):
        """``key_valid``: optional (B, T) bool, True = attend. With a
        ``generator`` the probabilities drop out at ``dropout_rate``, one
        seed drawn per call at the point where the JAX module draws it
        (the core's semantics say how the mask derives from it).

        ``key``/``value`` (default: ``x``), ``mask`` (bool, broadcastable
        to (B, H, T_q, T_k), True = attend) and ``cache`` (a dict with
        (B, H, T_max, dh) ``k`` and ``v``; the new rows are written at
        ``cache_index`` in place, keys past ``cache_index + T_new`` are
        masked, and ``(out, cache)`` is returned) take the composition,
        as does a (1|B, H, T, T) ``position_bias`` (WavLM; gated by this
        layer's gate over ``x`` when ``gated_rel_pos``)."""
        if (key is None and value is None and mask is None and cache is None
                and self.rpr_k is None and position_bias is None):
            return self._self_attention(x, key_valid, generator)
        if key_valid is not None:
            kv = key_valid[:, None, None, :]
            mask = kv if mask is None else mask & kv
        if position_bias is not None and self.gated_rel_pos:
            position_bias = self.gate_bias(x, position_bias)
        q, k, v = self.qkv(x, key, value)
        return self._composed(q, k, v, mask, generator, cache, cache_index,
                              position_bias)

    def _self_attention(self, x, key_valid, generator):
        rate = self.dropout_rate if generator is not None else 0.0
        scale = 1.0 / math.sqrt(self.d_head)
        if self.block_eligible(x.shape[1]):
            seed = draw_seed(generator) if rate > 0.0 else 0
            dt = self.compute_dtype
            if self.projections()[0].weight.dtype == torch.int8:
                raise ValueError("the attention block takes float weights: "
                                 "int8 Dense layers run the core")
            params = [t.to(dt) for m in self.projections()
                      for t in (m.weight, m.bias)]
            return attention_block(x.to(dt).contiguous(), *params, key_valid,
                                   self.num_heads, scale, rate, seed)
        q, k, v = self.qkv(x)
        seed = draw_seed(generator) if rate > 0.0 else 0
        out = attention_core(q, k, v, key_valid, scale, rate, seed,
                             xla=self.xla_semantics(x.shape[1]),
                             bf16_softmax=self.bf16_softmax)
        return self._merge(out)

    def _scaled(self, q: torch.Tensor) -> torch.Tensor:
        """q times 1/sqrt(dh) computed in f32 and cast to q's dtype, the
        product in q's dtype (the JAX order)."""
        s = 1.0 / torch.sqrt(torch.tensor(float(self.d_head),
                                          dtype=torch.float32))
        return q * s.to(device=q.device, dtype=q.dtype)

    def _rel_ids(self, t_q: int, t_k: int, q_offset: int,
                 device) -> torch.Tensor:
        qi = torch.arange(t_q, device=device)[:, None] + q_offset
        kj = torch.arange(t_k, device=device)[None, :]
        return torch.clamp(kj - qi, -self.rpr_k, self.rpr_k) + self.rpr_k

    def _composed(self, q, k, v, mask, generator, cache, cache_index,
                  position_bias=None):
        """The JAX XLA attention on split heads (``__call__`` past its
        kernel branches); ``position_bias`` (f32) is added to the logits
        in their dtype (bf16 under ``bf16_softmax``)."""
        dt = self.compute_dtype
        q = self._scaled(q)
        q_offset = 0
        if cache is not None:
            t_new = k.shape[2]
            cache["k"][:, :, cache_index:cache_index + t_new] = k
            cache["v"][:, :, cache_index:cache_index + t_new] = v
            k, v = cache["k"], cache["v"]
            valid = (torch.arange(k.shape[2], device=k.device)
                     < cache_index + t_new)[None, None, None, :]
            mask = valid if mask is None else mask & valid
            q_offset = cache_index
        bf16_sm = (self.bf16_softmax and dt != torch.float32
                   and self.rpr_k is None)
        if bf16_sm:  # the product summed in f32, stored in bf16
            logits = torch.matmul(q, k.transpose(-1, -2))
        else:
            logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        if position_bias is not None:
            logits = logits + position_bias.to(logits.dtype)
        if self.rpr_k is not None:
            rel = self.rpr_key_emb(self._rel_ids(q.shape[2], k.shape[2],
                                                 q_offset, q.device))
            logits = logits + torch.einsum("bhqd,qkd->bhqk", q.float(),
                                           rel.float())
        if mask is not None:
            logits = torch.where(mask, logits, torch.tensor(
                NEG_INF, dtype=logits.dtype, device=logits.device))
        if bf16_sm:
            probs = softmax(logits)
        elif self.bf16_softmax and dt != torch.float32:
            probs = softmax(logits.to(dt))
        else:
            probs = softmax(logits).to(dt)
        rate = self.dropout_rate if generator is not None else 0.0
        probs = dropout(probs, rate, generator)
        out = torch.matmul(probs, v)
        if self.rpr_k is not None and self.rpr_value_on:
            rel_v = self.rpr_value_emb(self._rel_ids(q.shape[2], k.shape[2],
                                                     q_offset, q.device))
            out = out + torch.einsum("bhqk,qkd->bhqd", probs, rel_v).to(dt)
        out = self._merge(out)
        if cache is not None:
            return out, cache
        return out

    def compute_kv(self, key: torch.Tensor, value: torch.Tensor):
        """Split K/V heads of a fixed memory, projected once for a
        decode's every step."""
        _, wk, wv, _ = self.projections()
        return self._split(wk(key)), self._split(wv(value))

    def attend_kv(self, query: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Attention over precomputed (B, H, T_k, dh) keys and values:
        the logits and the softmax in f32, then the probabilities cast to
        the compute dtype (the JAX ``attend_kv``, which rounds unlike the
        bf16 ``__call__``)."""
        q = self._scaled(self._split(self.projections()[0](query)))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        if mask is not None:
            logits = torch.where(mask, logits, torch.tensor(
                NEG_INF, dtype=logits.dtype, device=logits.device))
        probs = softmax(logits).to(self.compute_dtype)
        return self._merge(torch.matmul(probs, v))


def ffn(x: torch.Tensor, fc1: Dense, fc2: Dense) -> torch.Tensor:
    """The position-wise FFN (``audio8_tpu/nn/transformer.py:FFN``):
    ``fc2(gelu(fc1(x)))``. A function over the layer's own ``fc1``/``fc2``
    so the parameters keep fairseq's names."""
    return fc2(gelu(fc1(x)))


class TransformerEncoderLayer(nn.Module):
    """Encoder layer of the wav2vec2 stack. Post-norm (wav2vec2-base):
    ``x = LN(x + drop(attn(x))); x = LN(x + drop(ffn(x)))``; pre-norm
    (``pre_norm``, stable layer norm): ``x = x + drop(attn(LN(x))); x =
    x + drop(ffn(LN(x)))``. The attention-probability rate defaults to
    ``dropout_rate``. ``mask`` (broadcastable to (B, H, T, T)) and
    ``position_bias`` take the attention's composition."""

    def __init__(self, num_heads: int, d_model: int, d_ff: int,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0,
                 attention_dropout: Optional[float] = None,
                 fused_attention=None, bf16_softmax: bool = True,
                 pre_norm: bool = False, flash: bool = False,
                 gated_rel_pos: bool = False, rel_pos_buckets: int = 0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.pre_norm = pre_norm
        self.self_attn = MultiHeadAttention(
            num_heads, d_model, dtype,
            dropout_rate if attention_dropout is None else attention_dropout,
            fused_attention, bf16_softmax, flash=flash,
            gated_rel_pos=gated_rel_pos,
            rel_pos_buckets=rel_pos_buckets)
        self.self_attn_layer_norm = LayerNorm(d_model, dtype)
        self.fc1 = Dense(d_model, d_ff, dtype=dtype)
        self.fc2 = Dense(d_ff, d_model, dtype=dtype)
        self.final_layer_norm = LayerNorm(d_model, dtype)

    def num_seeds(self) -> int:
        """The seeds a training forward draws: the attention's
        probability dropout and the two residual dropouts."""
        return ((self.self_attn.dropout_rate > 0.0)
                + 2 * (self.dropout_rate > 0.0))

    def forward(self, x: torch.Tensor,
                key_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                mask: Optional[torch.Tensor] = None,
                position_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        rate = self.dropout_rate

        def attn(h):
            return self.self_attn(h, key_valid, generator, mask=mask,
                                  position_bias=position_bias)

        if self.pre_norm:
            x = x + dropout(attn(self.self_attn_layer_norm(x)), rate,
                            generator)
            return x + dropout(ffn(self.final_layer_norm(x), self.fc1,
                                   self.fc2), rate, generator)
        x = x + dropout(attn(x), rate, generator)
        x = self.self_attn_layer_norm(x)
        x = x + dropout(ffn(x, self.fc1, self.fc2), rate, generator)
        return self.final_layer_norm(x)


def run_layers(layers, x, generator, layer_drop: float,
               remat: bool = False, **kwargs):
    """The layers in order, under LayerDrop in training: every layer's
    keep decision is drawn before the first layer, as the JAX stack
    splits its key (``jax.random.bernoulli`` with ``1 - layer_drop``); a
    dropped layer is skipped (JAX computes it and selects its input), but
    the seeds it would have drawn are drawn and discarded, so every later
    draw is the one JAX makes (``ops.hashrand.SeedReplay`` lines up).

    ``remat`` (the JAX ``nn.remat`` of each layer; in training, while
    autograd records): a kept layer's activations are not kept for the
    backward but recomputed there (``torch.utils.checkpoint``). Its
    ``num_seeds()`` seeds are drawn before it runs, and the forward and
    the recompute each take them from a fresh ``SeedReplay``: both apply
    the same dropout masks, and the generator's stream ends where a
    plain step leaves it."""
    keeps = None
    if generator is not None and layer_drop > 0.0:
        keeps = [draw_keep(generator, 1.0 - layer_drop) for _ in layers]
    for i, layer in enumerate(layers):
        if keeps is not None and not keeps[i]:
            for _ in range(layer.num_seeds()):
                draw_seed(generator)
            continue
        if remat and generator is not None and torch.is_grad_enabled():
            seeds = [draw_seed(generator) for _ in range(layer.num_seeds())]
            x = torch.utils.checkpoint.checkpoint(
                _replayed, layer, seeds, x, use_reentrant=False, **kwargs)
        else:
            x = layer(x, generator=generator, **kwargs)
    return x


def _replayed(layer, seeds, x, **kwargs):
    """``layer``'s forward with its dropout seeds given (a remat
    forward and its recompute)."""
    replay = SeedReplay(seeds)
    out = layer(x, generator=replay, **kwargs)
    if replay.remaining:
        raise RuntimeError(f"{type(layer).__name__}: drew "
                           f"{len(seeds) - replay.remaining} of its "
                           f"{len(seeds)} seeds")
    return out


def wavlm_position_bias(layers, t: int, num_buckets: int,
                        max_distance: int,
                        dtype: torch.dtype) -> torch.Tensor:
    """The bias a WavLM stack shares across its layers, from layer 0's
    bucket table (:func:`relative_position_bias`)."""
    return relative_position_bias(layers[0].self_attn.rel_attn_embed.weight,
                                  t, num_buckets, max_distance, dtype)


class FFN(nn.Module):
    """The JAX ``FFN`` under its names: ``contract(gelu(expand(x)))`` (its
    inner dropout rate is 0 in every recipe, so it draws nothing)."""

    def __init__(self, d_model: int, d_ff: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.expand = Dense(d_model, d_ff, dtype=dtype)
        self.contract = Dense(d_ff, d_model, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.contract(gelu(self.expand(x)))


class TextEncoderLayer(nn.Module):
    """Post-norm encoder layer under the JAX names (``self_attn``,
    ``ffn``, ``ln_attn``, ``ln_ffn``), with relative positions: the text
    tower's layer. The arithmetic is :class:`TransformerEncoderLayer`'s."""

    def __init__(self, num_heads: int, d_model: int, d_ff: int,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.1, rpr_k: Optional[int] = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.self_attn = MultiHeadAttention(num_heads, d_model, dtype,
                                            dropout_rate, rpr_k=rpr_k,
                                            names="jax")
        self.ffn = FFN(d_model, d_ff, dtype)
        self.ln_attn = LayerNorm(d_model, dtype)
        self.ln_ffn = LayerNorm(d_model, dtype)

    def forward(self, x, key_valid=None, generator=None):
        rate = self.dropout_rate
        x = x + dropout(self.self_attn(x, key_valid, generator), rate,
                        generator)
        x = self.ln_attn(x)
        x = x + dropout(self.ffn(x), rate, generator)
        return self.ln_ffn(x)


class TextTransformerEncoderStack(nn.Module):
    """The JAX ``TransformerEncoderStack`` as the text tower builds it:
    post-norm, gelu, ``rpr_k`` relative positions on the keys, layers
    ``layer_{i}``."""

    def __init__(self, num_heads: int, d_model: int, num_layers: int,
                 d_ff: Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.1, rpr_k: Optional[int] = None):
        super().__init__()
        d_ff = d_ff or 4 * d_model
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TextEncoderLayer(
                num_heads, d_model, d_ff, dtype, dropout_rate, rpr_k))

    def forward(self, x: torch.Tensor,
                key_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, key_valid, generator)
        return x


class TransformerDecoderLayer(nn.Module):
    """The JAX decoder layer as the seq2seq decoder builds it (pre-norm):
    causal self-attention (KV-cached in :meth:`step`), cross attention
    over the memory, FFN; one residual dropout for the three branches,
    each call its own seed."""

    def __init__(self, num_heads: int, d_model: int, d_ff: int,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.self_attn = MultiHeadAttention(num_heads, d_model, dtype,
                                            dropout_rate, names="jax")
        self.src_attn = MultiHeadAttention(num_heads, d_model, dtype,
                                           dropout_rate, names="jax")
        self.ffn = FFN(d_model, d_ff, dtype)
        self.ln_self = LayerNorm(d_model, dtype)
        self.ln_src = LayerNorm(d_model, dtype)
        self.ln_ffn = LayerNorm(d_model, dtype)

    def _sublayers(self, x, memory, src_mask, tgt_mask, generator,
                   self_cache=None, cache_index=0, cross_kv=None):
        rate = self.dropout_rate
        h = self.ln_self(x)
        if self_cache is not None:
            attn, self_cache = self.self_attn(h, None, generator,
                                              mask=tgt_mask, cache=self_cache,
                                              cache_index=cache_index)
        else:
            attn = self.self_attn(h, None, generator, mask=tgt_mask)
        x = x + dropout(attn, rate, generator)
        h = self.ln_src(x)
        if cross_kv is not None:
            attn = self.src_attn.attend_kv(h, cross_kv[0], cross_kv[1],
                                           src_mask)
        else:
            attn = self.src_attn(h, None, generator, key=memory,
                                 value=memory, mask=src_mask)
        x = x + dropout(attn, rate, generator)
        x = x + dropout(self.ffn(self.ln_ffn(x)), rate, generator)
        return x, self_cache

    def forward(self, x, memory, src_mask=None, tgt_mask=None,
                generator=None):
        return self._sublayers(x, memory, src_mask, tgt_mask, generator)[0]

    def compute_cross_kv(self, memory):
        return self.src_attn.compute_kv(memory, memory)

    def step(self, x, memory, src_mask, self_cache, cache_index,
             cross_kv=None):
        """One decode step through the KV cache (the cache's own mask
        covers causality); ``cross_kv`` is the memory's precomputed K/V."""
        return self._sublayers(x, memory, src_mask, None, None, self_cache,
                               cache_index, cross_kv)


class TransformerDecoderStack(nn.Module):
    """``num_layers`` decoder layers (``layer_{i}``) and the final
    ``ln_out``. The JAX stack's ``layer_drop`` is inert there too."""

    def __init__(self, num_heads: int, d_model: int, num_layers: int,
                 d_ff: Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.num_heads, self.d_model = num_heads, d_model
        self.num_layers = num_layers
        self.compute_dtype = dtype
        d_ff = d_ff or 4 * d_model
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerDecoderLayer(
                num_heads, d_model, d_ff, dtype, dropout_rate))
        self.ln_out = LayerNorm(d_model, dtype)

    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]

    def forward(self, x, memory, src_mask=None, tgt_mask=None,
                generator=None):
        for layer in self.layers():
            x = layer(x, memory, src_mask, tgt_mask, generator)
        return self.ln_out(x)

    def init_cache(self, batch: int, max_len: int, device=None) -> dict:
        """Zero (L, B, H, max_len, dh) keys and values in the compute
        dtype, index 0 (the JAX ``KVCache.init``); :meth:`step` writes
        into it in place."""
        shape = (self.num_layers, batch, self.num_heads, max_len,
                 self.d_model // self.num_heads)
        return {"k": torch.zeros(shape, dtype=self.compute_dtype,
                                 device=device),
                "v": torch.zeros(shape, dtype=self.compute_dtype,
                                 device=device),
                "index": 0}

    def compute_cross_kv(self, memory):
        """Per-layer cross-attention K/V over a fixed memory."""
        return [layer.compute_cross_kv(memory) for layer in self.layers()]

    def step(self, x, memory, src_mask, cache: dict, cross_kv=None):
        """One decode step through every layer; returns ``(out, cache)``
        with the index advanced."""
        idx = cache["index"]
        for i, layer in enumerate(self.layers()):
            layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
            x, _ = layer.step(x, memory, src_mask, layer_cache, idx,
                              None if cross_kv is None else cross_kv[i])
        return self.ln_out(x), dict(cache, index=idx + 1)


def subsequent_mask(size: int, device=None) -> torch.Tensor:
    """Causal mask (1, 1, T, T), True where position j <= i."""
    return torch.tril(torch.ones(size, size, dtype=torch.bool,
                                 device=device))[None, None]
