"""Attention block: the Q/K/V projections, the attention core and the
output projection of one self-attention layer in one call.

Counterpart of ``audio8_tpu/ops/pallas/attention_block_kernel.py``
(``attention_block_nheads`` and its custom VJP), the JAX package's
``fused_attention="block"`` path. Layouts: x ``(B, T, D)``; the weights
in the port's ``Dense`` layout ``(out, in)``: wq, wk, wv ``(H*dh, D)``
and wo ``(D, H*dh)``; biases bq, bk, bv ``(H*dh,)`` and bo ``(D,)``;
key_valid ``(B, T)`` bool or None. What the TPU kernel computes, and so
what both routes here compute:

* x is padded with zero rows to T_pad = round_up(T, 128) BEFORE the
  projections, so a padded row projects to its bias: a zero-length row
  (no valid key) averages v over T_pad rows whose padded rows are bv;
* rounding points: ``q = round(x Wq_h) + bq_h`` (the bias added after
  rounding to the input dtype), k and v the same; the core is the
  attention core's (``ops/attention.py``) on the (B, H, T_pad, dh) grid
  with keys at or past T masked, so its hash-dropout mask is the core
  kernel's (seed ``seed + b*H + h``, row stride T_pad); ``o_h =
  round(p_d v)``; the output ``sum_h o_h Wo_h + bo`` in f32, rounded
  once at the end;
* backward: ``dxo = round(dout Wo_h^T)``; ``dWo`` sums ``o_h^T dout``
  in f32; the core's dq, dk, dv in f32 feed the bias gradients, summed
  over all T_pad rows (a zero-length row gives the padded keys a dk and
  dv), and their copies rounded to the input dtype feed ``dW{q,k,v} =
  x^T d{q,k,v}`` and ``dx``. The weight and bias gradients come out of
  the kernels as per-batch-row partials, summed here as the TPU
  kernel's per-(b, h) partials are summed outside it; ``dbo`` is the f32
  sum of dout.

On CUDA tensors :func:`attention_block` launches ``csrc/attention_block_
fwd.cu`` and, for the gradient, ``csrc/attention_block_bwd.cu``; on CPU
tensors it runs :func:`attention_block_plain` and
:func:`attention_block_bwd_plain`, which follow the TPU kernel step by
step and which the kernels are held to on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from audio8_tpu_torch.ops import _ext
from audio8_tpu_torch.ops.attention import (HEAD_DIMS, KEY_TILE,
                                            attention_core_bwd_f32,
                                            attention_core_plain, round_up)
from audio8_tpu_torch.ops.hashrand import MASK32, keep_threshold

SOURCE = "attention_block_fwd.cu"
BWD_SOURCE = "attention_block_bwd.cu"


def padded_key_mask(key_valid: Optional[torch.Tensor], b: int, t: int,
                    t_pad: int, device) -> torch.Tensor:
    """(B, T_pad) bool: the core's key mask on the padded grid, False at
    the padded keys (the TPU kernel's ``col < T`` and key mask)."""
    kv = torch.zeros((b, t_pad), dtype=torch.bool, device=device)
    kv[:, :t] = True if key_valid is None else key_valid.to(torch.bool)
    return kv


def _project(xp: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
             h: int) -> torch.Tensor:
    """``round(xp W^T) + bias`` split to heads: (B, H, T_pad, dh)."""
    b, t_pad, _ = xp.shape
    y = torch.matmul(xp.float(), w.float().t()).to(xp.dtype) + bias
    return y.view(b, t_pad, h, -1).permute(0, 2, 1, 3)


def _merge(a: torch.Tensor) -> torch.Tensor:
    """(B, H, T, dh) -> (B, T, H*dh)."""
    b, h, t, dh = a.shape
    return a.permute(0, 2, 1, 3).reshape(b, t, h * dh)


def attention_block_plain(x, wq, bq, wk, bk, wv, bv, wo, bo,
                          key_valid: Optional[torch.Tensor], num_heads: int,
                          scale: float, rate: float = 0.0,
                          seed: int = 0) -> torch.Tensor:
    """Plain version of the TPU kernel's forward (``_fwd_kernel``)."""
    b, t, _ = x.shape
    t_pad = round_up(t, 128)
    xp = torch.nn.functional.pad(x, (0, 0, 0, t_pad - t))
    q, k, v = (_project(xp, w, bias, num_heads)
               for w, bias in ((wq, bq), (wk, bk), (wv, bv)))
    kv = padded_key_mask(key_valid, b, t, t_pad, x.device)
    o = attention_core_plain(q, k, v, kv, scale, rate, seed)
    out = torch.matmul(_merge(o)[:, :t].float(), wo.float().t()) + bo.float()
    return out.to(x.dtype)


def sum_partials(x, wq, bq, wk, bk, wv, bv, wo, bo, dw_part, dwo_part,
                 db_part, dout):
    """The weight and bias gradients from their per-batch-row partials
    (``dw_part`` (3, B, H*dh, D), ``dwo_part`` (B, D, H*dh), ``db_part``
    (B, 3, H*dh), all f32), each rounded to its parameter's dtype; ``dbo``
    is the f32 sum of dout over batch and time."""
    dw = dw_part.sum(1)
    db = db_part.sum(0)
    dwo = dwo_part.sum(0)
    dbo = dout.float().sum((0, 1))
    return (dw[0].to(wq.dtype), db[0].to(bq.dtype), dw[1].to(wk.dtype),
            db[1].to(bk.dtype), dw[2].to(wv.dtype), db[2].to(bv.dtype),
            dwo.to(wo.dtype), dbo.to(bo.dtype))


def attention_block_bwd_plain(x, wq, bq, wk, bk, wv, bv, wo, bo,
                              key_valid: Optional[torch.Tensor],
                              num_heads: int, scale: float, rate: float,
                              seed: int, dout: torch.Tensor):
    """Plain version of the TPU kernel's backward (``_bwd_kernel``, then
    the sums outside it): ``(dx, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo)``
    by recompute."""
    b, t, d = x.shape
    t_pad = round_up(t, 128)
    dt = x.dtype
    xp = torch.nn.functional.pad(x, (0, 0, 0, t_pad - t))
    q, k, v = (_project(xp, w, bias, num_heads)
               for w, bias in ((wq, bq), (wk, bk), (wv, bv)))
    kv = padded_key_mask(key_valid, b, t, t_pad, x.device)
    o = _merge(attention_core_plain(q, k, v, kv, scale, rate, seed))
    dop = torch.nn.functional.pad(dout.to(dt), (0, 0, 0, t_pad - t)).float()
    dxo = torch.matmul(dop, wo.float()).to(dt)                 # (B, T_pad, HD)
    dwo_part = torch.matmul(dop.transpose(1, 2), o.float())   # (B, D, HD)
    dxo = dxo.view(b, t_pad, num_heads, -1).permute(0, 2, 1, 3)
    g32 = attention_core_bwd_f32(q, k, v, kv, scale, rate, seed, dxo)
    g = [_merge(a.to(dt)).float() for a in g32]               # (B, T_pad, HD)
    xf = xp.float()
    dw_part = torch.stack([torch.matmul(a.transpose(1, 2), xf) for a in g])
    db_part = torch.stack([_merge(a).sum(1) for a in g32], 1)
    dx = sum(torch.matmul(a, w.float()) for a, w in zip(g, (wq, wk, wv)))
    return (dx[:, :t].to(dt),) + sum_partials(
        x, wq, bq, wk, bk, wv, bv, wo, bo, dw_part, dwo_part, db_part, dout)


def _checked(x, weights, key_valid, num_heads, rate, what):
    """Validate CUDA inputs; returns ``(d_head, T_pad)``."""
    wq, bq, wk, bk, wv, bv, wo, bo = weights
    tensors = [x, *weights] + ([] if key_valid is None else [key_valid])
    if not all(a.is_cuda and a.device == x.device for a in tensors):
        raise ValueError(f"{what}: inputs must all be on the CPU or all on "
                         "one CUDA device")
    if x.dtype not in _ext.DTYPE_CODES or any(a.dtype != x.dtype
                                              for a in weights):
        raise TypeError(f"{what}: x, weights and biases must share one "
                        "dtype, float32 or bfloat16")
    if x.dim() != 3:
        raise ValueError(f"{what}: x {tuple(x.shape)}; want (B, T, D)")
    b, t, d = x.shape
    hd = wq.shape[0]
    if (any(w.shape != (hd, d) for w in (wq, wk, wv)) or wo.shape != (d, hd)
            or any(a.shape != (hd,) for a in (bq, bk, bv))
            or bo.shape != (d,)):
        raise ValueError(f"{what}: weights must be (H*dh, D) for q/k/v, "
                         "(D, H*dh) for o, with (H*dh,) and (D,) biases")
    if hd % num_heads or hd // num_heads not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {hd}/{num_heads} not in "
                         f"{HEAD_DIMS}")
    if b * num_heads > 65535:
        raise ValueError(f"{what}: B*H = {b * num_heads} > 65535")
    if not all(a.is_contiguous() for a in (x, *weights)):
        raise ValueError(f"{what}: x, weights and biases must be contiguous")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"{what}: rate {rate} not in [0, 1)")
    if key_valid is not None and key_valid.shape != (b, t):
        raise ValueError(f"{what}: key_valid {tuple(key_valid.shape)} != "
                         f"{(b, t)}")
    return hd // num_heads, round_up(t, 128)


def _dropout_args(rate: float, seed: int):
    return (1.0 / (1.0 - rate), keep_threshold(rate), int(seed) & MASK32,
            int(rate > 0.0))


def _forward_kernel(x, weights, key_valid, num_heads, scale, rate, seed,
                    with_residuals: bool):
    """Launch ``attention_block_fwd.cu``: the projections into q, k, v on
    the padded grid, the attention core, the output projection (three
    device kernels). Returns ``(out, residuals)``; with
    ``with_residuals`` the residuals are what the backward kernel reads
    (the padded key mask, q, k, v, the core's output o, its f32 copy and
    row statistics), else None."""
    dh, t_pad = _checked(x, weights, key_valid, num_heads, rate,
                         "attention_block")
    b, t, d = x.shape
    dev = x.device
    kv = padded_key_mask(key_valid, b, t, t_pad, dev).to(torch.uint8)
    q, k, v, o = (torch.empty((b, num_heads, t_pad, dh), dtype=x.dtype,
                              device=dev) for _ in range(4))
    stats = o32 = None
    if with_residuals:
        stats = torch.empty((b * num_heads * t_pad, 2), dtype=torch.float32,
                            device=dev)
        o32 = o if x.dtype == torch.float32 else torch.empty(
            o.shape, dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    ptrs = [a.data_ptr() for a in (x, *weights, kv, q, k, v, o)]
    fn = _ext.function(SOURCE)
    _ext.check(fn(*ptrs, None if stats is None else stats.data_ptr(),
                  None if o32 is None or o32 is o else o32.data_ptr(),
                  out.data_ptr(), b, t, d, num_heads, dh,
                  _ext.DTYPE_CODES[x.dtype], float(scale),
                  *_dropout_args(rate, seed), _ext.stream_handle(dev)),
               "attention_block")
    attention_block.launches += 1
    residuals = (kv, q, k, v, o, o32, stats) if with_residuals else None
    return out, residuals


def attention_block_bwd(x, weights, residuals, num_heads: int, scale: float,
                        rate: float, seed: int, dout: torch.Tensor):
    """The backward kernel on CUDA tensors (eight device kernels: dxo,
    the dWo partials, the core backward's three (D, the fused pass, the
    dq reduction), the dW{q,k,v} partials, dx and the bias partials),
    then the partials' sums: ``(dx, dwq, dbq,
    dwk, dbk, dwv, dbv, dwo, dbo)``. ``residuals`` are the forward
    kernel's."""
    dh, t_pad = _checked(x, weights, None, num_heads, rate,
                         "attention_block_bwd")
    kv, q, k, v, o, o32, stats = residuals
    b, t, d = x.shape
    hd = num_heads * dh
    dev = x.device
    if dout.shape != x.shape:
        raise ValueError(f"attention_block_bwd: dout {tuple(dout.shape)} != "
                         f"x {tuple(x.shape)}")
    if stats is None or stats.shape != (b * num_heads * t_pad, 2):
        raise ValueError("attention_block_bwd: the forward's residuals are "
                         "missing")
    dout = dout.to(x.dtype).contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    dxo, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
    g32 = [None] * 3 if x.dtype == torch.float32 else [
        torch.empty(q.shape, **f32) for _ in range(3)]
    dvec = torch.empty((b * num_heads * t_pad,), **f32)
    dq_part = torch.empty((b * num_heads, t_pad // KEY_TILE, t_pad, dh),
                          **f32)
    dx = torch.empty_like(x)
    dw_part = torch.empty((3, b, hd, d), **f32)
    dwo_part = torch.empty((b, d, hd), **f32)
    db_part = torch.empty((b, 3, hd), **f32)
    wq, bq, wk, bk, wv, bv, wo, bo = weights
    fn = _ext.function(BWD_SOURCE)
    _ext.check(fn(*(a.data_ptr() for a in (
        x, wq, wk, wv, wo, kv, dout, q, k, v, o, o32, stats, dxo, dvec,
        dq_part, dq, dk, dv)), *(None if a is None else a.data_ptr() for a in g32),
        *(a.data_ptr() for a in (dx, dw_part, dwo_part, db_part)),
        b, t, d, num_heads, dh, _ext.DTYPE_CODES[x.dtype], float(scale),
        *_dropout_args(rate, seed), _ext.stream_handle(dev)),
        "attention_block_bwd")
    attention_block_bwd.launches += 1
    return (dx,) + sum_partials(x, *weights, dw_part, dwo_part, db_part,
                                dout)


class _AttentionBlock(torch.autograd.Function):
    """The custom VJP of the JAX block: gradients for x and all eight
    weights and biases. On the card the residuals are the forward
    kernel's intermediates; on the CPU the plain backward recomputes."""

    @staticmethod
    def forward(ctx, x, wq, bq, wk, bk, wv, bv, wo, bo, key_valid, num_heads,
                scale, rate, seed):
        weights = (wq, bq, wk, bk, wv, bv, wo, bo)
        if x.is_cuda:
            out, residuals = _forward_kernel(x, weights, key_valid, num_heads,
                                             scale, rate, seed, True)
        else:
            out = attention_block_plain(x, *weights, key_valid, num_heads,
                                        scale, rate, seed)
            residuals = ()
        ctx.save_for_backward(x, *weights, key_valid, *residuals)
        ctx.args = (num_heads, scale, rate, seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, *rest = ctx.saved_tensors
        weights, key_valid, residuals = rest[:8], rest[8], rest[9:]
        num_heads, scale, rate, seed = ctx.args
        if x.is_cuda:
            grads = attention_block_bwd(x, weights, residuals, num_heads,
                                        scale, rate, seed, dout)
        else:
            grads = attention_block_bwd_plain(x, *weights, key_valid,
                                              num_heads, scale, rate, seed,
                                              dout)
        return (*grads, None, None, None, None, None)


def attention_block(x: torch.Tensor, wq: torch.Tensor, bq: torch.Tensor,
                    wk: torch.Tensor, bk: torch.Tensor, wv: torch.Tensor,
                    bv: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                    key_valid: Optional[torch.Tensor], num_heads: int,
                    scale: float, rate: float = 0.0,
                    seed: int = 0) -> torch.Tensor:
    """Self-attention of x through its four projections: ``(B, T, D)`` in
    the input dtype (float32 or bfloat16; weights and biases in the same
    dtype), differentiable in x and all eight weights and biases.
    ``rate``: attention-probability dropout with uint32 ``seed``. CPU
    tensors take the plain versions; CUDA tensors launch the kernels or
    raise."""
    weights = (wq, bq, wk, bk, wv, bv, wo, bo)
    tensors = [x, *weights] + ([] if key_valid is None else [key_valid])
    on_cpu = all(a.device.type == "cpu" for a in tensors)
    if torch.is_grad_enabled() and any(a.requires_grad for a in
                                       (x, *weights)):
        if not on_cpu:
            _checked(x, weights, key_valid, num_heads, rate, "attention_block")
        return _AttentionBlock.apply(x, *weights, key_valid, num_heads, scale,
                                     rate, seed)
    if on_cpu:
        return attention_block_plain(x, *weights, key_valid, num_heads, scale,
                                     rate, seed)
    return _forward_kernel(x, weights, key_valid, num_heads, scale, rate,
                           seed, False)[0]


attention_block.launches = 0
attention_block_bwd.launches = 0
