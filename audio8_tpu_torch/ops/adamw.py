"""Fused AdamW update (``audio8_tpu/ops/pallas/adamw_kernel.py``).

:func:`adamw_update` updates every leaf's moments and parameter in place.
It is the custom op ``a8t::adamw_``, which mutates the parameters and
moments: on CUDA tensors one launch of ``csrc/adamw.cu`` over a device
table of the leaves; on CPU tensors :func:`adamw_update_plain`, the same
arithmetic in plain PyTorch. The grad scale (1/examples times the clip
factor) is a 0-dim f32 tensor on the leaves' device, so a clip factor
computed on the card is never read back to the host.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from audio8_tpu_torch.ops import _ext

SOURCE = "adamw.cu"
CHUNK = 16384  # elements per block, as in csrc/adamw.cu


def adamw_update_plain(params: Sequence[torch.Tensor],
                       grads: Sequence[torch.Tensor],
                       mus: Sequence[torch.Tensor],
                       nus: Sequence[torch.Tensor], grad_scale: torch.Tensor,
                       lr: float, b1: float, b2: float, eps: float,
                       weight_decay: float, inv_bc1: float,
                       inv_bc2: float) -> None:
    """Plain version: ``_adamw_kernel``'s arithmetic leaf by leaf (the
    scalars in f32, as the kernels take them)."""
    c1, c2 = (float(np.float32(1.0) - np.float32(b)) for b in (b1, b2))
    with torch.no_grad():
        for p, g, m, v in zip(params, grads, mus, nus):
            g = g.float() * grad_scale
            m.copy_(b1 * m + c1 * g)
            v.copy_(b2 * v + c2 * g * g)
            upd = (m * inv_bc1) / (torch.sqrt(v * inv_bc2) + eps) \
                + weight_decay * p
            p.sub_(lr * upd)


def _launch(params, grads, mus, nus, grad_scale, lr, b1, b2, eps,
            weight_decay, inv_bc1, inv_bc2) -> None:
    """The kernel on CUDA leaves: one launch over a device table of them."""
    dev = params[0].device
    rows, n_blocks = [], 0
    for p, g, m, v in zip(params, grads, mus, nus):
        for x in (p, g, m, v):
            if x.device != dev or x.dtype != torch.float32 \
                    or not x.is_contiguous():
                raise ValueError("adamw_update: every leaf must be a "
                                 f"contiguous float32 tensor on {dev}")
        if not (p.numel() == g.numel() == m.numel() == v.numel()):
            raise ValueError("adamw_update: leaf sizes differ")
        n = p.numel()
        if n == 0:
            continue
        rows.append([p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                     n, n_blocks])
        n_blocks += (n + CHUNK - 1) // CHUNK
    table = torch.tensor(rows, dtype=torch.int64).pin_memory().to(
        dev, non_blocking=True)
    gscale = grad_scale.detach().to(dev, torch.float32).reshape(1)
    fn = _ext.function(SOURCE)
    _ext.check(fn(table.data_ptr(), len(rows), n_blocks, float(lr),
                  float(b1), float(b2), float(eps), float(weight_decay),
                  float(inv_bc1), float(inv_bc2), gscale.data_ptr(),
                  _ext.stream_handle(dev)), "adamw_update")
    adamw_update.launches += 1


@torch.library.custom_op("a8t::adamw_",
                         mutates_args=("params", "mus", "nus"),
                         device_types="cpu")
def adamw_op(params: list[torch.Tensor], grads: list[torch.Tensor],
             mus: list[torch.Tensor], nus: list[torch.Tensor],
             grad_scale: torch.Tensor, lr: float, b1: float, b2: float,
             eps: float, weight_decay: float, inv_bc1: float,
             inv_bc2: float) -> None:
    """``a8t::adamw_``: the plain version on the CPU, the kernel on CUDA
    (:func:`_launch`); it updates ``params``, ``mus`` and ``nus`` in
    place and returns nothing, so its fake does nothing."""
    adamw_update_plain(params, grads, mus, nus, grad_scale, lr, b1, b2, eps,
                       weight_decay, inv_bc1, inv_bc2)


adamw_op.register_kernel("cuda")(_launch)


@adamw_op.register_fake
def _(params, grads, mus, nus, grad_scale, lr, b1, b2, eps, weight_decay,
      inv_bc1, inv_bc2):
    return None


def adamw_update(params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor], mus: Sequence[torch.Tensor],
                 nus: Sequence[torch.Tensor], grad_scale: torch.Tensor,
                 lr: float, b1: float, b2: float, eps: float,
                 weight_decay: float, inv_bc1: float, inv_bc2: float) -> None:
    """In-place AdamW over aligned leaf lists (f32 params and moments),
    the op ``a8t::adamw_``. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if not (len(params) == len(grads) == len(mus) == len(nus)) or not params:
        raise ValueError("adamw_update: leaf lists differ in length or are "
                         "empty")
    with torch.no_grad():
        adamw_op(list(params), list(grads), list(mus), list(nus), grad_scale,
                 float(lr), float(b1), float(b2), float(eps),
                 float(weight_decay), float(inv_bc1), float(inv_bc2))


adamw_update.launches = 0
