"""Post-training int8 weight quantization for serving
(``audio8_tpu/ops/quant.py`` and ``audio8_tpu/nn/layers.py:int8_dot``).

Quantization is a transform of a loaded model, as in JAX: the checkpoint
format does not change. :func:`quantize_model_params` replaces the float
``weight`` of every plain ``nn.layers.Dense`` with ``min(in, out) >=
min_dim`` by int8 codes and a per-output-channel ``weight_scale`` (both
buffers, not parameters); ``Dense`` dispatches on the weight's dtype to
:func:`int8_dot`. In the acoustic model those are the attention's Q, K,
V and output projections, ``fc1``, ``fc2`` and ``post_extract_proj``;
the 768 -> 32 CTC head stays float.

:func:`int8_dot` quantizes the activations per row (symmetric absmax
over the contraction dim, computed in the compute dtype, as JAX does in
bf16) and multiplies the codes with ``torch._int_mm`` (cuBLASLt's int8
GEMM on the card; the same call on the CPU), int8 x int8 -> int32, then
scales in f32. The codes and the int32 products are exact, so both
devices and the JAX package agree on them bitwise.

``torch._int_mm(a, b)``'s rules on CUDA, which this module keeps on
every device: ``a`` is (M, K) row-major with M > 16, ``b`` is (K, N)
column-major (the transpose of the row-major (N, K) weight codes), and
K and N are multiples of 8. Rows are padded with zero codes up to 17
when M <= 16 (a padded row's products are dropped); a K or N that is
not a multiple of 8 raises. Nothing dequantizes to a float product.
"""
from __future__ import annotations

import logging
from typing import Tuple

import numpy as np
import torch
from torch import nn

logger = logging.getLogger("audio8_tpu_torch")

INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA wants more than 16 rows
INT_MM_MULTIPLE = 8   # ... and K and N in multiples of 8


def quantize_kernel(weight: torch.Tensor) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of a ``(out, in)``
    Dense weight, computed in numpy float32 as JAX's ``quantize_kernel``
    does on its ``(in, out)`` kernel (so the codes are bitwise JAX's).
    Returns ``(codes int8 (out, in), scale f32 (out,))`` with
    ``dequant = codes * scale[:, None]``."""
    w = weight.detach().to("cpu", torch.float32).numpy()
    scale = np.max(np.abs(w), axis=1) / 127.0
    scale = np.maximum(scale, 1e-12)
    codes = np.clip(np.round(w / scale[:, None]), -127, 127).astype(np.int8)
    return (torch.from_numpy(codes).to(weight.device),
            torch.from_numpy(scale.astype(np.float32)).to(weight.device))


def int_mm(a: torch.Tensor, b_rows: torch.Tensor) -> torch.Tensor:
    """``a (M, K) int8 @ b_rows (N, K) int8 ^T -> (M, N) int32`` by
    ``torch._int_mm`` under its CUDA rules (module docstring)."""
    m, k = a.shape
    n = b_rows.shape[0]
    if k % INT_MM_MULTIPLE or n % INT_MM_MULTIPLE:
        raise ValueError(f"int8 product ({m}, {k}) x ({k}, {n}): K and N "
                         f"must be multiples of {INT_MM_MULTIPLE}")
    if m < INT_MM_MIN_ROWS:
        a = torch.cat([a, a.new_zeros(INT_MM_MIN_ROWS - m, k)])
    return torch._int_mm(a.contiguous(), b_rows.t())[:m]


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 codes of activations, JAX's ``int8_dot``
    steps in ``x``'s dtype: the absmax, ``max(absmax, 1e-8) / 127``,
    ``x / x_scale``, the round (half to even) and the clip. Returns
    ``(codes int8, x_scale)``."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    # a 0-dim tensor on x's device, not the Python 127.0: CUDA divides by
    # a host scalar as a product with its reciprocal, whose rounding
    # differs from the division the CPU and XLA make
    x_scale = torch.clamp_min(absmax, 1e-8) / absmax.new_full((), 127.0)
    return (torch.clamp(torch.round(x / x_scale), -127, 127).to(torch.int8),
            x_scale)


def int8_dot(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
             out_dtype: torch.dtype) -> torch.Tensor:
    """``x @ dequant(codes)^T`` on the int8 path, JAX's ``int8_dot``:
    :func:`quantize_rows`, the int32 product, then ``(y_int32 -> f32 *
    x_scale -> f32) * scale`` in that order and the cast to
    ``out_dtype``."""
    xq, x_scale = quantize_rows(x)
    y = int_mm(xq.reshape(-1, x.shape[-1]), codes)
    y = y.reshape(*x.shape[:-1], codes.shape[0])
    return (y.float() * x_scale.float() * scale.float()).to(out_dtype)


def _is_plain_dense(module: nn.Module, min_dim: int) -> bool:
    from audio8_tpu_torch.nn.layers import Dense

    return (type(module) is Dense and module.weight.dtype != torch.int8
            and min(module.weight.shape) >= min_dim)


def quantize_model_params(model: nn.Module, min_dim: int = 64) -> int:
    """Quantize every plain ``Dense`` of ``model`` with ``min(in, out) >=
    min_dim`` in place (``Dense.quantize_``); returns the count, which
    equals JAX's ``quantize_dense_tree`` count on the same model. Raises
    if nothing matched, so that a silent no-op cannot ship."""
    count = 0
    for module in model.modules():
        if _is_plain_dense(module, min_dim):
            module.quantize_()
            count += 1
    if count == 0:
        raise ValueError(
            "int8 quantization matched no Dense kernels -- wrong model?")
    logger.info("int8-quantized %d Dense kernels (min_dim=%d)", count,
                min_dim)
    return count
