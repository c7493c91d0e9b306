"""Fused hash dropout (``audio8_tpu/ops/pallas/dropout_kernel.py`` and
``audio8_tpu/nn/dropout.py:_hash_dropout``).

``where(keep, x / (1 - rate), 0)`` with the keep mask a pure function of
the element's flat index and an integer seed (``ops/hashrand.py``), bit
for bit the JAX package's ``_hash_keep_mask``. :func:`fused_dropout` is
differentiable; like ``_hash_dropout``'s custom VJP it keeps no mask: the
backward regenerates it from the scalar seed and applies the same
function to ``dy``. On CUDA tensors both passes launch
``csrc/dropout.cu``; on CPU tensors they run :func:`hash_dropout`, the
plain version, which the kernel is checked against on the card.
"""
from __future__ import annotations

import torch

from audio8_tpu_torch.ops import _ext
from audio8_tpu_torch.ops.hashrand import MASK32, hash_bits, keep_threshold

SOURCE = "dropout.cu"


def hash_keep_mask(shape, rate: float, seed: int,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    return hash_bits(shape, seed, device) >= keep_threshold(rate)


def hash_dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """Plain version: ``where(keep, x / (1 - rate), 0)``. The division is
    by a 0-dim f32 tensor on x's device, in f32, rounded once to x's dtype:
    a Python-scalar divisor would be a multiply by its reciprocal on
    CUDA."""
    if rate == 0.0:
        return x
    keep = hash_keep_mask(x.shape, rate, seed, x.device)
    den = torch.full((), 1.0 - rate, dtype=torch.float32, device=x.device)
    return torch.where(keep, (x.float() / den).to(x.dtype),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _launch(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    if x.dtype not in _ext.DTYPE_CODES:
        raise TypeError(f"fused_dropout: dtype {x.dtype}; the kernel takes "
                        "float32 or bfloat16")
    x = x.contiguous()
    y = torch.empty_like(x)
    fn = _ext.function(SOURCE)
    _ext.check(fn(x.data_ptr(), y.data_ptr(), x.numel(), int(seed) & MASK32,
                  keep_threshold(rate), 1.0 - rate, _ext.DTYPE_CODES[x.dtype],
                  _ext.stream_handle(x.device)), "fused_dropout")
    fused_dropout.launches += 1
    return y


def _apply(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return hash_dropout(x, rate, seed)
    if not x.is_cuda:
        raise ValueError(f"fused_dropout: x on {x.device}; want the CPU or "
                         "a CUDA device")
    return _launch(x, rate, seed)


class _FusedDropout(torch.autograd.Function):
    """``_hash_dropout``'s custom VJP: the residual is the seed."""

    @staticmethod
    def forward(ctx, x, rate, seed):
        ctx.args = (rate, seed)
        return _apply(x, rate, seed)

    @staticmethod
    def backward(ctx, dy):
        rate, seed = ctx.args
        return _apply(dy, rate, seed), None, None


def fused_dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """Hash dropout at ``rate`` with uint32 ``seed``; the identity at rate
    0. CPU tensors take the plain version; CUDA tensors launch the kernel
    (forward and backward) or raise."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"fused_dropout: rate {rate} not in [0, 1)")
    if rate == 0.0:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _FusedDropout.apply(x, rate, seed)
    return _apply(x, rate, seed)


fused_dropout.launches = 0
