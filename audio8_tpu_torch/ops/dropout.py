"""Fused hash dropout (``audio8_tpu/ops/pallas/dropout_kernel.py`` and
``audio8_tpu/nn/dropout.py:_hash_dropout``).

``where(keep, x / (1 - rate), 0)`` with the keep mask a pure function of
the element's flat index and an integer seed (``ops/hashrand.py``), bit
for bit the JAX package's ``_hash_keep_mask``. :func:`fused_dropout` is
differentiable; like ``_hash_dropout``'s custom VJP it keeps no mask: the
backward regenerates it from the scalar seed and applies the same
function to ``dy``. A row block of a larger tensor (data parallelism)
passes its first element's flat index as ``base`` and draws that
tensor's mask; a piece that is rows of a larger tensor's index
(``ops/hashrand.py:strided_index``: a sequence-parallel rank's frames, a
tensor-parallel rank's heads) also passes ``row_len`` and
``row_stride``. Both passes are the custom op ``a8t::hash_dropout``
(:func:`hash_dropout_op`): on CUDA tensors it launches
``csrc/dropout.cu``, on CPU tensors it runs :func:`hash_dropout`, the
plain version, which the kernel is checked against on the card.
"""
from __future__ import annotations

import torch

from audio8_tpu_torch.ops import _ext
from audio8_tpu_torch.ops.hashrand import MASK32, hash_bits, keep_threshold

SOURCE = "dropout.cu"


def hash_keep_mask(shape, rate: float, seed: int,
                   device: torch.device | str = "cpu",
                   base: int = 0, row_len: int = 0,
                   row_stride: int = 0) -> torch.Tensor:
    return hash_bits(shape, seed, device, base, row_len, row_stride) \
        >= keep_threshold(rate)


def hash_dropout(x: torch.Tensor, rate: float, seed: int,
                 base: int = 0, row_len: int = 0,
                 row_stride: int = 0) -> torch.Tensor:
    """Plain version: ``where(keep, x / (1 - rate), 0)``. The division is
    by a 0-dim f32 tensor on x's device, in f32, rounded once to x's dtype:
    a Python-scalar divisor would be a multiply by its reciprocal on
    CUDA."""
    if rate == 0.0:
        return x
    keep = hash_keep_mask(x.shape, rate, seed, x.device, base, row_len,
                          row_stride)
    den = torch.full((), 1.0 - rate, dtype=torch.float32, device=x.device)
    return torch.where(keep, (x.float() / den).to(x.dtype),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _launch(x: torch.Tensor, rate: float, seed: int,
            base: int = 0, row_len: int = 0,
            row_stride: int = 0) -> torch.Tensor:
    if not x.is_cuda:
        raise ValueError(f"fused_dropout: x on {x.device}; want the CPU or "
                         "a CUDA device")
    if x.dtype not in _ext.DTYPE_CODES:
        raise TypeError(f"fused_dropout: dtype {x.dtype}; the kernel takes "
                        "float32 or bfloat16")
    x = x.contiguous()
    y = torch.empty_like(x)
    fn = _ext.function(SOURCE)
    _ext.check(fn(x.data_ptr(), y.data_ptr(), x.numel(), int(seed) & MASK32,
                  int(base) & MASK32, int(row_len), int(row_stride) & MASK32,
                  keep_threshold(rate), 1.0 - rate, _ext.DTYPE_CODES[x.dtype],
                  _ext.stream_handle(x.device)), "fused_dropout")
    fused_dropout.launches += 1
    return y


@torch.library.custom_op("a8t::hash_dropout", mutates_args=(),
                         device_types="cpu")
def hash_dropout_op(x: torch.Tensor, rate: float, seed: int,
                    base: int = 0, row_len: int = 0,
                    row_stride: int = 0) -> torch.Tensor:
    """``a8t::hash_dropout``: the plain version on the CPU, the kernel on
    CUDA (:func:`_launch`), a new tensor like ``x`` under a trace."""
    y = hash_dropout(x, rate, seed, base, row_len, row_stride)
    return y.clone() if y is x else y  # an op's output never aliases x


hash_dropout_op.register_kernel("cuda")(_launch)


@hash_dropout_op.register_fake
def _(x, rate, seed, base=0, row_len=0, row_stride=0):
    return torch.empty_like(x)


def _setup(ctx, inputs, output):
    ctx.args = inputs[1:]


def _backward(ctx, dy):
    """``_hash_dropout``'s custom VJP: the residuals are the seed and the
    index (base, row length and stride)."""
    return (hash_dropout_op(dy, *ctx.args),) + (None,) * 5


hash_dropout_op.register_autograd(_backward, setup_context=_setup)


def fused_dropout(x: torch.Tensor, rate: float, seed: int,
                  base: int = 0, row_len: int = 0,
                  row_stride: int = 0) -> torch.Tensor:
    """Hash dropout at ``rate`` with uint32 ``seed``, the flat index
    starting at ``base`` (rows of ``row_len`` elements ``row_stride``
    apart when ``row_len`` > 0); the identity at rate 0. CPU tensors take
    the plain version; CUDA tensors launch the kernel (forward and
    backward) or raise."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"fused_dropout: rate {rate} not in [0, 1)")
    if rate == 0.0:
        return x
    if row_len >= x.numel():
        row_len = row_stride = 0
    return hash_dropout_op(x, rate, seed, int(base) & MASK32, int(row_len),
                           int(row_stride) & MASK32)


fused_dropout.launches = 0
