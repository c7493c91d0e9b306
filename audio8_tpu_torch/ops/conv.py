"""Stride-2, kernel-3 VALID 1-D convolution over channel-last activations.

Counterpart of ``audio8_tpu/ops/pallas/conv_kernel.py:conv1d_k3s2`` (the
forward only: the dgrad and wgrad kernels come with the pretraining slice,
so on the card a call that would need a gradient raises). On a CUDA tensor
:func:`conv1d_k3s2` launches the hand-written kernel
``csrc/conv_k3s2_fwd.cu``; on a CPU tensor it runs
:func:`conv1d_k3s2_plain`, the same function in plain PyTorch, which is
also what the kernel is checked against on the card.
"""
from __future__ import annotations

import torch

from audio8_tpu_torch.ops import _ext

SOURCE = "conv_k3s2_fwd.cu"


def conv1d_k3s2_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: an overlapping strided view of ``x`` times
    ``w.reshape(3 * C_in, C_out)``. Row t of the view is x[2t:2t+3]
    flattened, i.e. the 3*C_in contiguous elements the kernel reads."""
    b, t, c_in = x.shape
    c_out = w.shape[-1]
    t_out = (t - 3) // 2 + 1
    x = x.contiguous()
    rows = x.as_strided((b, t_out, 3 * c_in), (t * c_in, 2 * c_in, 1),
                        x.storage_offset())
    return torch.matmul(rows, w.reshape(3 * c_in, c_out))


def conv1d_k3s2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, T, C_in) x (3, C_in, C_out) -> (B, (T-3)//2+1, C_out), VALID.

    f32 or bf16 inputs (both the same dtype), f32 accumulation, output in
    the input dtype. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv1d_k3s2_plain(x, w)
    if not (x.is_cuda and w.is_cuda and x.device == w.device):
        raise ValueError(f"conv1d_k3s2: x on {x.device}, w on {w.device}; "
                         "both must be CPU or the same CUDA device")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(
            "conv1d_k3s2: the backward kernels (dgrad, wgrad) are not "
            "ported yet; train with freeze_fx (ROADMAP.md)")
    if x.dtype not in _ext.DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"conv1d_k3s2: dtypes {x.dtype}/{w.dtype}; the "
                        "kernel takes float32 or bfloat16, both the same")
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != 3 \
            or w.shape[1] != x.shape[2]:
        raise ValueError(f"conv1d_k3s2: shapes {tuple(x.shape)} x "
                         f"{tuple(w.shape)}; want (B, T, C_in) x "
                         "(3, C_in, C_out)")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv1d_k3s2: x and w must be contiguous")
    b, t, c_in = x.shape
    c_out = w.shape[2]
    if t < 3:
        raise ValueError(f"conv1d_k3s2: T={t} < kernel size 3")
    y = torch.empty((b, (t - 3) // 2 + 1, c_out), dtype=x.dtype,
                    device=x.device)
    fn = _ext.function(SOURCE)
    _ext.check(fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), b, t, c_in,
                  c_out, _ext.DTYPE_CODES[x.dtype],
                  _ext.stream_handle(x.device)), "conv1d_k3s2")
    conv1d_k3s2.launches += 1
    return y


conv1d_k3s2.launches = 0
