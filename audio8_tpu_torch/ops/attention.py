"""Attention core: softmax(q k^T * scale, key mask) [hash dropout] v.

Counterpart of ``audio8_tpu/ops/pallas/attention_kernel.py:attention_core``
(the forward; the backward kernel comes with training). Layout is the JAX
one: q, k, v ``(B, H, T, dh)``, key_valid ``(B, T)``. On CUDA tensors
:func:`attention_core` launches ``csrc/attention_fwd.cu``; on CPU tensors
it runs :func:`attention_core_plain`, which follows the TPU kernel step by
step (T padded to a multiple of 128, -1e9 for invalid keys, f32 softmax,
the same integer-hash dropout mask, probabilities cast to the input dtype
before P.V).
"""
from __future__ import annotations

from typing import Optional

import torch

from audio8_tpu_torch.ops import _ext

SOURCE = "attention_fwd.cu"
NEG = -1e9
_MASK32 = 0xFFFFFFFF


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def keep_threshold(rate: float) -> int:
    """uint32 threshold of the hash dropout (``_hash_keep``)."""
    return min(int(rate * 4294967296.0), 4294967295)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32), without overflowing
    int64: multiply the 16-bit halves separately."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def hash_keep(t_pad: int, seeds: torch.Tensor, rate: float) -> torch.Tensor:
    """Keep masks ``(G, t_pad, t_pad)`` for per-group uint32 ``seeds``
    (int64 tensor of shape (G,)): bit-exact with ``_hash_keep`` of the TPU
    kernel, whose row stride is ``t_pad``. uint32 arithmetic is done in
    int64 with explicit wrap-around."""
    dev = seeds.device
    r = torch.arange(t_pad, device=dev, dtype=torch.int64)
    idx = (r[:, None] * t_pad + r[None, :]) & _MASK32
    x = idx[None] ^ (seeds[:, None, None] & _MASK32)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x >= keep_threshold(rate)


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


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   key_valid: Optional[torch.Tensor], scale: float,
                   rate: float = 0.0, seed: int = 0) -> torch.Tensor:
    """Fused attention core. q/k/v ``(B, H, T, dh)`` float32 or bfloat16;
    key_valid optional ``(B, T)`` bool; ``rate`` the probability dropout
    (0 = off) with uint32 ``seed``; head ``(b, h)`` uses ``seed + b*H + h``.
    Returns ``(B, H, T, dh)`` in the input dtype. CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    tensors = [q, k, v] + ([] if key_valid is None else [key_valid])
    if all(a.device.type == "cpu" for a in tensors):
        return attention_core_plain(q, k, v, key_valid, scale, rate, seed)
    if not all(a.is_cuda and a.device == q.device for a in tensors):
        raise ValueError("attention_core: inputs must all be on the CPU or "
                         "all on one CUDA device")
    if q.dtype not in _ext.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"attention_core: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; the kernel takes float32 or bfloat16")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention_core: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}; want equal "
                         "(B, H, T, dh) (self-attention)")
    b, h, t, dh = q.shape
    if dh not in (16, 32, 64, 128):
        raise ValueError(f"attention_core: head dim {dh} not in "
                         "(16, 32, 64, 128)")
    if b * h > 65535:
        raise ValueError(f"attention_core: B*H = {b * h} > 65535")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention_core: q, k, v must be contiguous")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"attention_core: rate {rate} not in [0, 1)")
    kv_ptr = None
    if key_valid is not None:
        if key_valid.shape != (b, t):
            raise ValueError(f"attention_core: key_valid {tuple(key_valid.shape)}"
                             f" != {(b, t)}")
        key_valid = key_valid.to(torch.uint8).contiguous()
        kv_ptr = key_valid.data_ptr()
    o = torch.empty_like(q)
    fn = _ext.function(SOURCE)
    _ext.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_ptr,
                  o.data_ptr(), b, h, t, dh, _ext.DTYPE_CODES[q.dtype],
                  float(scale), 1.0 / (1.0 - rate), keep_threshold(rate),
                  int(seed) & _MASK32, int(rate > 0.0),
                  _ext.stream_handle(q.device)), "attention_core")
    attention_core.launches += 1
    return o


attention_core.launches = 0
