"""Attention core: softmax(q k^T * scale, key mask) [hash dropout] v.

Counterpart of ``audio8_tpu/ops/pallas/attention_kernel.py:attention_core``
and its custom VJP. Layout is the JAX one: q, k, v ``(B, H, T, dh)``,
key_valid ``(B, T)``. On CUDA tensors :func:`attention_core` launches
``csrc/attention_fwd.cu`` and, when a gradient is needed, its backward
launches ``csrc/attention_bwd.cu``. On CPU tensors it runs the plain
versions, which follow the TPU kernel step by step:
:func:`attention_core_plain` (``_probs`` + ``_fwd_kernel``: T padded to a
multiple of 128, -1e9 for invalid keys, f32 softmax, the integer-hash
dropout mask, probabilities cast to the input dtype before P.V) and
:func:`attention_core_bwd_plain` (``_bwd_kernel``: p recomputed, ds not
zeroed at masked columns, pd and ds cast to the input dtype before the
products).
"""
from __future__ import annotations

from typing import Optional

import torch

from audio8_tpu_torch.ops import _ext
from audio8_tpu_torch.ops.hashrand import MASK32 as _MASK32
from audio8_tpu_torch.ops.hashrand import keep_threshold, mix32

SOURCE = "attention_fwd.cu"
BWD_SOURCE = "attention_bwd.cu"
NEG = -1e9


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def hash_keep(t_pad: int, seeds: torch.Tensor, rate: float) -> torch.Tensor:
    """Keep masks ``(G, t_pad, t_pad)`` for per-group uint32 ``seeds``
    (int64 tensor of shape (G,)): bit-exact with ``_hash_keep`` of the TPU
    kernel, whose row stride is ``t_pad``."""
    dev = seeds.device
    r = torch.arange(t_pad, device=dev, dtype=torch.int64)
    idx = (r[:, None] * t_pad + r[None, :]) & _MASK32
    return mix32(idx[None] ^ (seeds[:, None, None] & _MASK32)) \
        >= keep_threshold(rate)


def attention_core_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         key_valid: Optional[torch.Tensor], scale: float,
                         rate: float = 0.0, seed: int = 0) -> torch.Tensor:
    """Plain version of the TPU kernel's forward (``_probs`` +
    ``_fwd_kernel``), computed on the T_pad = round_up(T, 128) grid."""
    b, h, t, dh = q.shape
    t_pad = round_up(t, 128)
    pad = (0, 0, 0, t_pad - t)
    qp, kp, vp = (torch.nn.functional.pad(a, pad) for a in (q, k, v))
    s = torch.matmul(qp.float(), kp.float().transpose(-1, -2)) * scale
    valid = torch.arange(t_pad, device=q.device) < t
    valid = valid.expand(b, t_pad)
    if key_valid is not None:
        kv = torch.nn.functional.pad(key_valid.to(torch.bool), (0, t_pad - t))
        valid = valid & kv
    s = torch.where(valid[:, None, None, :], s, torch.tensor(NEG, device=s.device))
    p = torch.softmax(s, dim=-1)
    if rate > 0.0:
        g = torch.arange(b * h, device=q.device, dtype=torch.int64)
        keep = hash_keep(t_pad, (int(seed) + g) & _MASK32, rate)
        p = torch.where(keep.view(b, h, t_pad, t_pad), p * (1.0 / (1.0 - rate)),
                        torch.zeros((), device=p.device))
    out = torch.matmul(p.to(q.dtype), vp)
    return out[:, :, :t, :]


def attention_core_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, key_valid: Optional[torch.Tensor],
                             scale: float, rate: float, seed: int,
                             dout: torch.Tensor):
    """Plain version of the TPU kernel's backward (``_bwd_kernel``):
    ``(dq, dk, dv)`` by recompute on the T_pad grid, in the input dtype."""
    return tuple(g.to(q.dtype) for g in attention_core_bwd_f32(
        q, k, v, key_valid, scale, rate, seed, dout))


def attention_core_bwd_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           key_valid: Optional[torch.Tensor], scale: float,
                           rate: float, seed: int, dout: torch.Tensor):
    """:func:`attention_core_bwd_plain` before its final rounding: the f32
    ``(dq, dk, dv)`` that the attention block's bias gradients sum."""
    b, h, t, dh = q.shape
    t_pad = round_up(t, 128)
    pad = (0, 0, 0, t_pad - t)
    qp, kp, vp, dop = (torch.nn.functional.pad(a, pad).float()
                       for a in (q, k, v, dout))
    s = torch.matmul(qp, kp.transpose(-1, -2)) * scale
    valid = (torch.arange(t_pad, device=q.device) < t).expand(b, t_pad)
    if key_valid is not None:
        kv = torch.nn.functional.pad(key_valid.to(torch.bool), (0, t_pad - t))
        valid = valid & kv
    s = torch.where(valid[:, None, None, :], s, torch.tensor(NEG, device=s.device))
    p = torch.softmax(s, dim=-1)
    dpd = torch.matmul(dop, vp.transpose(-1, -2))
    zero = torch.zeros((), device=p.device)
    if rate > 0.0:
        g = torch.arange(b * h, device=q.device, dtype=torch.int64)
        keep = hash_keep(t_pad, (int(seed) + g) & _MASK32, rate)
        keep = keep.view(b, h, t_pad, t_pad)
        pd = torch.where(keep, p * (1.0 / (1.0 - rate)), zero)
        dp = torch.where(keep, dpd * (1.0 / (1.0 - rate)), zero)
    else:
        pd, dp = p, dpd
    pd = pd.to(q.dtype).float()
    dv = torch.matmul(pd.transpose(-1, -2), dop)
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    ds = ds.to(q.dtype).float()
    dq = torch.matmul(ds, kp) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qp) * scale
    return tuple(x[:, :, :t, :] for x in (dq, dk, dv))


def _checked(q, k, v, key_valid, rate, what):
    """Validate CUDA inputs; returns the (B, T) uint8 key mask or None."""
    tensors = [q, k, v] + ([] if key_valid is None else [key_valid])
    if not all(a.is_cuda and a.device == q.device for a in tensors):
        raise ValueError(f"{what}: inputs must all be on the CPU or all on "
                         "one CUDA device")
    if q.dtype not in _ext.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"{what}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                        "the kernel takes float32 or bfloat16")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{what}: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}; want equal "
                         "(B, H, T, dh) (self-attention)")
    b, h, t, dh = q.shape
    if dh not in (16, 32, 64, 128):
        raise ValueError(f"{what}: head dim {dh} not in (16, 32, 64, 128)")
    if b * h > 65535:
        raise ValueError(f"{what}: B*H = {b * h} > 65535")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{what}: q, k, v must be contiguous")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"{what}: rate {rate} not in [0, 1)")
    if key_valid is None:
        return None
    if key_valid.shape != (b, t):
        raise ValueError(f"{what}: key_valid {tuple(key_valid.shape)} != "
                         f"{(b, t)}")
    return key_valid.to(torch.uint8).contiguous()


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _forward_kernel(q, k, v, key_valid, scale, rate, seed,
                    with_stats: bool):
    """Launch ``attention_fwd.cu``; returns ``(o, stats, o32)``. With
    ``with_stats`` the kernel also writes the row statistics and the
    output in f32 (``o`` itself for f32 inputs) for the backward; without
    it both are None."""
    kv = _checked(q, k, v, key_valid, rate, "attention_core")
    b, h, t, dh = q.shape
    o = torch.empty_like(q)
    stats = o32 = None
    if with_stats:
        stats = torch.empty((b * h * t, 2), dtype=torch.float32,
                            device=q.device)
        o32 = o if q.dtype == torch.float32 else torch.empty(
            q.shape, dtype=torch.float32, device=q.device)
    fn = _ext.function(SOURCE)
    _ext.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv),
                  o.data_ptr(), _ptr(stats),
                  None if o32 is o else _ptr(o32), b, h, t, dh,
                  _ext.DTYPE_CODES[q.dtype], float(scale),
                  1.0 / (1.0 - rate), keep_threshold(rate),
                  int(seed) & _MASK32, int(rate > 0.0),
                  _ext.stream_handle(q.device)), "attention_core")
    attention_core.launches += 1
    return o, stats, o32


def attention_core_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       o32: torch.Tensor, stats: torch.Tensor,
                       key_valid: Optional[torch.Tensor], scale: float,
                       rate: float, seed: int, dout: torch.Tensor):
    """The backward kernel on CUDA tensors: ``(dq, dk, dv)`` from the
    forward's inputs, its output in f32 ``o32`` and its row ``stats``
    (both written by the forward kernel when a gradient is needed)."""
    kv = _checked(q, k, v, key_valid, rate, "attention_core_bwd")
    b, h, t, dh = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype \
            or o32.shape != q.shape or o32.dtype != torch.float32:
        raise ValueError("attention_core_bwd: dout must match q, o32 be "
                         "its f32 output")
    if stats is None or stats.shape != (b * h * t, 2):
        raise ValueError("attention_core_bwd: the forward's row statistics "
                         "are missing")
    dout, o32 = dout.contiguous(), o32.contiguous()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dvec = torch.empty((b * h * t,), dtype=torch.float32, device=q.device)
    fn = _ext.function(BWD_SOURCE)
    _ext.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o32.data_ptr(),
                  dout.data_ptr(), _ptr(kv), stats.data_ptr(),
                  dvec.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), b, h, t, dh, _ext.DTYPE_CODES[q.dtype],
                  float(scale), 1.0 / (1.0 - rate), keep_threshold(rate),
                  int(seed) & _MASK32, int(rate > 0.0),
                  _ext.stream_handle(q.device)), "attention_core_bwd")
    attention_core_bwd.launches += 1
    return dq, dk, dv


class _AttentionCore(torch.autograd.Function):
    """The custom VJP of the JAX ``attention_core``: residuals are the
    inputs (plus, on the card, the f32 output and the row statistics)."""

    @staticmethod
    def forward(ctx, q, k, v, key_valid, scale, rate, seed):
        if q.is_cuda:
            o, stats, o32 = _forward_kernel(q, k, v, key_valid, scale, rate,
                                            seed, with_stats=True)
        else:
            o = attention_core_plain(q, k, v, key_valid, scale, rate, seed)
            stats = o32 = None
        ctx.save_for_backward(q, k, v, key_valid, o32, stats)
        ctx.args = (scale, rate, seed)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_valid, o32, stats = ctx.saved_tensors
        scale, rate, seed = ctx.args
        if q.is_cuda:
            grads = attention_core_bwd(q, k, v, o32, stats, key_valid, scale,
                                       rate, seed, dout)
        else:
            grads = attention_core_bwd_plain(q, k, v, key_valid, scale, rate,
                                             seed, dout)
        return (*grads, None, None, None, None)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   key_valid: Optional[torch.Tensor], scale: float,
                   rate: float = 0.0, seed: int = 0) -> torch.Tensor:
    """Fused attention core. q/k/v ``(B, H, T, dh)`` float32 or bfloat16;
    key_valid optional ``(B, T)`` bool; ``rate`` the probability dropout
    (0 = off) with uint32 ``seed``; head ``(b, h)`` uses ``seed + b*H + h``.
    Returns ``(B, H, T, dh)`` in the input dtype, differentiable in q, k
    and v. CPU tensors take the plain versions; CUDA tensors launch the
    kernels or raise."""
    tensors = [q, k, v] + ([] if key_valid is None else [key_valid])
    on_cpu = all(a.device.type == "cpu" for a in tensors)
    if torch.is_grad_enabled() and any(a.requires_grad for a in (q, k, v)):
        if not on_cpu:
            _checked(q, k, v, key_valid, rate, "attention_core")
        return _AttentionCore.apply(q, k, v, key_valid, scale, rate, seed)
    if on_cpu:
        return attention_core_plain(q, k, v, key_valid, scale, rate, seed)
    return _forward_kernel(q, k, v, key_valid, scale, rate, seed,
                           with_stats=False)[0]


attention_core.launches = 0
attention_core_bwd.launches = 0
