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

import math
from typing import Optional

import torch

from audio8_tpu_torch.ops import _ext
from audio8_tpu_torch.ops.attention import (HEAD_DIMS, KEY_TILE,
                                            attention_core_bwd_f32,
                                            attention_core_plain, round_up)
from audio8_tpu_torch.ops.hashrand import MASK32, keep_threshold

SOURCE = "attention_block_fwd.cu"
BWD_SOURCE = "attention_block_bwd.cu"
# the kernels' GEMM routes, by their code in attention_block_gemm.cuh
GEMM_ROUTES = ("simt", "mma.sync", "wgmma")
# the H100 SXM's SMs, and how many CTAs of each route's weight-gradient
# GEMM fit on one: the K slices fill the card from the shape alone
SMS = 132
CTAS_PER_SM = {"simt": 2, "mma.sync": 4, "wgmma": 1}
K_TILE = {"simt": 8, "mma.sync": 32, "wgmma": 64}


def _tiles(route: str, m: int, n: int) -> int:
    """Output tiles of an (m, n) product on the route: 128 x 128 (SIMT),
    64 x 64 (mma.sync), 128 x 256 where n >= 256 else 128 x 128 (wgmma)."""
    tm = 64 if route == "mma.sync" else 128
    tn = 256 if route == "wgmma" and n >= 256 else tm
    return -(-m // tm) * -(-n // tn)


def gemm_route(dtype: torch.dtype, d_model: int, num_heads: int,
               d_head: int) -> str:
    """The GEMM route of the block's kernels, from the shape alone
    (``block_route`` in ``csrc/attention_block_gemm.cuh``, which the
    kernels check): "wgmma" for bf16 at head dim 64 or 128 and d_model a
    multiple of 64 (TMA's 64 x 64 boxes); "mma.sync" for other bf16
    shapes whose dx K segments, H*dh deep, are whole 32-deep tiles;
    "simt" for float32 (full f32 sums) and the rest."""
    if dtype != torch.bfloat16:
        return "simt"
    if d_head in (64, 128) and d_model % 64 == 0:
        return "wgmma"
    return "mma.sync" if (num_heads * d_head) % 32 == 0 else "simt"


def weight_grad_slices(route: str, b: int, t: int, d_model: int,
                       hd: int) -> tuple:
    """``(s_w, s_wo)``: the fixed number of K slices of the dW{q,k,v}
    product (3 x (H*dh, D) outputs) and of the dWo product ((D, H*dh)),
    each over the rows of all batch rows, at most their k tiles that hold
    real rows. The wgmma route's persistent grid (one CTA per SM) takes as
    many as fill the SMs once; the others launch CTAs in rounds of the
    card's slots and take the S <= 8 with the fewest rounds per unit of
    work (the smallest on ties)."""
    slots = SMS * CTAS_PER_SM[route]
    stages = b * -(-t // K_TILE[route])

    def slices(n):
        if route == "wgmma":
            return max(1, min(stages, slots // n))
        return min(range(1, min(8, stages) + 1),
                   key=lambda s: (-(-n * s // slots) / s, s))

    return (slices(3 * _tiles(route, hd, d_model)),
            slices(_tiles(route, d_model, hd)))


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


def weight_grad_partials(g: torch.Tensor, x: torch.Tensor,
                         slices: int) -> torch.Tensor:
    """``(slices, n, m)`` f32 partials of ``g^T x`` over the rows of all
    batch rows: g ``(B, T_pad, n)`` and x ``(B, T_pad, m)`` flattened to
    B*T_pad rows and cut into ``slices`` runs of whole 64-row tiles (the
    last ones shorter or empty), each run's product in f32."""
    g, x = g.reshape(-1, g.shape[-1]).float(), x.reshape(-1, x.shape[-1])
    rows = g.shape[0]
    per = round_up(-(-rows // slices), 64)
    return torch.stack([torch.matmul(g[i * per:(i + 1) * per].t(),
                                     x[i * per:(i + 1) * per].float())
                        for i in range(slices)])


def sum_partials(x, wq, bq, wk, bk, wv, bv, wo, bo, dw_part, dwo_part,
                 db_part, dout):
    """The weight and bias gradients from their f32 partials (``dw_part``
    (3, S_w, H*dh, D) and ``dwo_part`` (S_wo, D, H*dh), one per K slice;
    ``db_part`` (B, 3, H*dh), one per batch row), each summed by one
    reduction (a fixed order, no atomics: the same bits on every call)
    into one f32 buffer, which is rounded once to the parameters' dtype
    and returned whole (:func:`split_grads` cuts it); ``dbo`` is the f32
    sum of dout over batch and time."""
    hd, d = dw_part.shape[-2:]
    shapes = _grad_shapes(hd, d)
    sizes = [math.prod(s) for s in shapes]
    flat = torch.empty(sum(sizes), dtype=torch.float32,
                       device=dw_part.device)
    dw, dwo, db, dbo = (a.view(s) for a, s in zip(flat.split(sizes), shapes))
    torch.sum(dw_part, 1, out=dw)
    torch.sum(dwo_part, 0, out=dwo)
    torch.sum(db_part, 0, out=db)
    torch.sum(dout, (0, 1), dtype=torch.float32, out=dbo)
    return flat.to(wq.dtype)


def _grad_shapes(hd: int, d: int) -> tuple:
    """dW{q,k,v}, dWo, db{q,k,v}, dbo: the layout of the flat gradient."""
    return (3, hd, d), (d, hd), (3, hd), (d,)


def split_grads(flat: torch.Tensor, hd: int, d: int) -> tuple:
    """The flat gradient of :func:`sum_partials` as ``(dwq, dbq, dwk, dbk,
    dwv, dbv, dwo, dbo)``, views of it."""
    shapes = _grad_shapes(hd, d)
    dw, dwo, db, dbo = (a.view(s) for a, s in zip(
        flat.split([math.prod(s) for s in shapes]), shapes))
    return dw[0], db[0], dw[1], db[1], dw[2], db[2], dwo, dbo


def attention_block_bwd_plain(x, wq, bq, wk, bk, wv, bv, wo, bo,
                              key_valid: Optional[torch.Tensor],
                              num_heads: int, scale: float, rate: float,
                              seed: int, dout: torch.Tensor,
                              slices: tuple = (1, 1)):
    """Plain version of the TPU kernel's backward (``_bwd_kernel``, then
    the sums outside it): ``(dx, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo)``
    by recompute; ``slices`` = (S_w, S_wo) K slices of the dW{q,k,v} and
    dWo products over the B*T_pad rows."""
    dx, flat = _bwd_plain(x, wq, bq, wk, bk, wv, bv, wo, bo, key_valid,
                          num_heads, scale, rate, seed, dout, slices)
    return (dx,) + split_grads(flat, *wq.shape)


def _bwd_plain(x, wq, bq, wk, bk, wv, bv, wo, bo, key_valid, num_heads,
               scale, rate, seed, dout, slices=(1, 1)):
    """:func:`attention_block_bwd_plain` with the weights' and biases'
    gradients in one buffer: ``(dx, flat)``."""
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
    dwo_part = weight_grad_partials(dop, o, slices[1])        # (S, D, HD)
    dxo = dxo.view(b, t_pad, num_heads, -1).permute(0, 2, 1, 3)
    g32 = attention_core_bwd_f32(q, k, v, kv, scale, rate, seed, dxo)
    g = [_merge(a.to(dt)).float() for a in g32]               # (B, T_pad, HD)
    dw_part = torch.stack([weight_grad_partials(a, xp, slices[0])
                           for a in g])                       # (3, S, HD, D)
    db_part = torch.stack([_merge(a).sum(1) for a in g32], 1)
    dx = sum(torch.matmul(a, w.float()) for a, w in zip(g, (wq, wk, wv)))
    return dx[:, :t].to(dt).contiguous(), sum_partials(
        x, wq, bq, wk, bk, wv, bv, wo, bo, dw_part, dwo_part, db_part, dout)


def _workspace(shapes, dtype, device) -> list:
    """Contiguous tensors of ``shapes`` cut from one allocation, each at a
    16-byte aligned offset (every size here is a multiple of 16 bytes)."""
    sizes = [math.prod(s) for s in shapes]
    buf = torch.empty(sum(sizes), dtype=dtype, device=device)
    return [a.view(s) for a, s in zip(buf.split(sizes), shapes)]


def _aligned(a: torch.Tensor) -> torch.Tensor:
    """``a``, or a copy at a 16-byte aligned address (TMA and the 16-byte
    loads of the kernels need one)."""
    return a if a.data_ptr() % 16 == 0 else a.clone()


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
    x, weights = _aligned(x), [_aligned(w) for w in weights]
    route = GEMM_ROUTES.index(gemm_route(x.dtype, d, num_heads, dh))
    kv = padded_key_mask(key_valid, b, t, t_pad, dev).to(torch.uint8)
    heads = (b, num_heads, t_pad, dh)
    if with_residuals:  # the op's outputs: one allocation each
        q, k, v, o = (torch.empty(heads, dtype=x.dtype, device=dev)
                      for _ in range(4))
        stats = torch.empty((b * num_heads * t_pad, 2), dtype=torch.float32,
                            device=dev)
        o32 = o if x.dtype == torch.float32 else torch.empty(
            heads, dtype=torch.float32, device=dev)
    else:
        q, k, v, o = _workspace([heads] * 4, x.dtype, dev)
        stats = o32 = None
    out = torch.empty_like(x)
    ptrs = [a.data_ptr() for a in (x, *weights, kv, q, k, v, o)]
    fn = _ext.function(SOURCE)
    _ext.check(fn(*ptrs, None if stats is None else stats.data_ptr(),
                  None if o32 is None or o32 is o else o32.data_ptr(),
                  out.data_ptr(), b, t, d, num_heads, dh,
                  _ext.DTYPE_CODES[x.dtype], float(scale),
                  *_dropout_args(rate, seed), route,
                  _ext.stream_handle(dev)),
               "attention_block")
    attention_block.launches += 1
    residuals = (kv, q, k, v, o, o32, stats) if with_residuals else None
    return out, residuals


def _backward_kernel(x, weights, residuals, num_heads: int, scale: float,
                     rate: float, seed: int, dout: torch.Tensor):
    """The backward kernel on CUDA tensors (eight device kernels: dxo,
    the dWo partials, the core backward's three (D, the fused pass, the
    dq reduction), the dW{q,k,v} partials, dx and the bias partials),
    then the partials' sums: ``(dx, flat)``, the weights' and biases'
    gradients in one buffer (:func:`split_grads`). ``residuals`` are the
    forward kernel's."""
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
    route = gemm_route(x.dtype, d, num_heads, dh)
    s_w, s_wo = weight_grad_slices(route, b, t, d, hd)
    x, weights = _aligned(x), [_aligned(w) for w in weights]
    dout = _aligned(dout.to(x.dtype).contiguous())
    dxo, dq, dk, dv = _workspace([q.shape] * 4, x.dtype, dev)
    bf16 = x.dtype != torch.float32
    dvec, dq_part, dw_part, dwo_part, db_part, *g32 = _workspace(
        [(b * num_heads * t_pad,), (b * num_heads, t_pad // KEY_TILE, t_pad,
                                     dh), (3, s_w, hd, d), (s_wo, d, hd),
         (b, 3, hd)] + [q.shape] * (3 if bf16 else 0), torch.float32, dev)
    g32 = g32 or [None] * 3
    dx = torch.empty_like(x)
    wq, bq, wk, bk, wv, bv, wo, bo = weights
    fn = _ext.function(BWD_SOURCE)
    _ext.check(fn(*(a.data_ptr() for a in (
        x, wq, wk, wv, wo, kv, dout, q, k, v, o, o32, stats, dxo, dvec,
        dq_part, dq, dk, dv)), *(None if a is None else a.data_ptr() for a in g32),
        *(a.data_ptr() for a in (dx, dw_part, dwo_part, db_part)),
        b, t, d, num_heads, dh, _ext.DTYPE_CODES[x.dtype], float(scale),
        *_dropout_args(rate, seed), GEMM_ROUTES.index(route), s_w, s_wo,
        _ext.stream_handle(dev)),
        "attention_block_bwd")
    attention_block_bwd.launches += 1
    return dx, sum_partials(x, *weights, dw_part, dwo_part, db_part, dout)


# The forward and the backward as custom ops. On the card the backward's
# residuals are the forward kernel's intermediates; the CPU's plain
# backward recomputes, so there they are empty (each fake gives its
# device's shapes). An f32 forward's o32 is ``o``, returned empty.

def _empty(like: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return like.new_empty((0,), dtype=dtype)


_Tensors8 = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                  torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@torch.library.custom_op("a8t::attention_block", mutates_args=(),
                         device_types="cpu")
def attention_block_op(x: torch.Tensor, wq: torch.Tensor, bq: torch.Tensor,
                       wk: torch.Tensor, bk: torch.Tensor, wv: torch.Tensor,
                       bv: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                       key_valid: Optional[torch.Tensor], num_heads: int,
                       scale: float, rate: float, seed: int,
                       with_residuals: bool) -> _Tensors8:
    """``(out, kv, q, k, v, o, o32, stats)``: the output, then the
    backward kernel's residuals (empty unless ``with_residuals`` on a
    CUDA device)."""
    out = attention_block_plain(x, wq, bq, wk, bk, wv, bv, wo, bo, key_valid,
                                num_heads, scale, rate, seed)
    return (out, _empty(x, torch.uint8),
            *(_empty(x) for _ in range(6)))


@attention_block_op.register_kernel("cuda")
def _(x, wq, bq, wk, bk, wv, bv, wo, bo, key_valid, num_heads, scale, rate,
      seed, with_residuals):
    out, res = _forward_kernel(x, (wq, bq, wk, bk, wv, bv, wo, bo),
                               key_valid, num_heads, scale, rate, seed,
                               with_residuals)
    if res is None:
        return (out, _empty(x, torch.uint8),
                *(_empty(x) for _ in range(6)))
    kv, q, k, v, o, o32, stats = res
    return out, kv, q, k, v, o, _empty(x) if o32 is o else o32, stats


@attention_block_op.register_fake
def _(x, wq, bq, wk, bk, wv, bv, wo, bo, key_valid, num_heads, scale, rate,
      seed, with_residuals):
    if not (with_residuals and x.is_cuda):
        return (torch.empty_like(x), _empty(x, torch.uint8),
                *(_empty(x) for _ in range(6)))
    b, t, _ = x.shape
    t_pad = (t + 127) // 128 * 128
    heads = (b, num_heads, t_pad, wq.shape[0] // num_heads)
    o32 = _empty(x) if x.dtype == torch.float32 else \
        x.new_empty(heads, dtype=torch.float32)
    return (torch.empty_like(x), x.new_empty((b, t_pad), dtype=torch.uint8),
            *(x.new_empty(heads) for _ in range(4)), o32,
            x.new_empty((b * num_heads * t_pad, 2), dtype=torch.float32))


@torch.library.custom_op("a8t::attention_block_bwd", mutates_args=(),
                         device_types="cpu")
def attention_block_bwd_op(x: torch.Tensor, wq: torch.Tensor,
                           bq: torch.Tensor, wk: torch.Tensor,
                           bk: torch.Tensor, wv: torch.Tensor,
                           bv: torch.Tensor, wo: torch.Tensor,
                           bo: torch.Tensor,
                           key_valid: Optional[torch.Tensor],
                           kv: torch.Tensor, q: torch.Tensor,
                           k: torch.Tensor, v: torch.Tensor,
                           o: torch.Tensor, o32: torch.Tensor,
                           stats: torch.Tensor, num_heads: int, scale: float,
                           rate: float, seed: int, dout: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dx, flat)``: the weights' and biases' gradients in one buffer
    (:func:`split_grads`); the plain version recomputes from ``x`` and
    ``key_valid`` and ignores the residuals."""
    return _bwd_plain(x, wq, bq, wk, bk, wv, bv, wo, bo, key_valid,
                      num_heads, scale, rate, seed, dout)


@attention_block_bwd_op.register_kernel("cuda")
def _(x, wq, bq, wk, bk, wv, bv, wo, bo, key_valid, kv, q, k, v, o, o32,
      stats, num_heads, scale, rate, seed, dout):
    o32 = o if x.dtype == torch.float32 else o32
    return _backward_kernel(x, (wq, bq, wk, bk, wv, bv, wo, bo),
                            (kv, q, k, v, o, o32, stats), num_heads, scale,
                            rate, seed, dout)


@attention_block_bwd_op.register_fake
def _(x, wq, bq, wk, bk, wv, bv, wo, bo, key_valid, kv, q, k, v, o, o32,
      stats, num_heads, scale, rate, seed, dout):
    hd, d = wq.shape
    return torch.empty_like(x), x.new_empty((4 * hd * d + 3 * hd + d,))


def _setup(ctx, inputs, output):
    x, *weights = inputs[:9]
    key_valid, num_heads, scale, rate, seed, _ = inputs[9:]
    ctx.save_for_backward(x, *weights, key_valid, *output[1:])
    ctx.args = (num_heads, scale, rate, seed)


def _backward(ctx, dout, *_):
    """The custom VJP of the JAX block: gradients for x and all eight
    weights and biases."""
    x, *weights = ctx.saved_tensors[:9]
    key_valid, *residuals = ctx.saved_tensors[9:]
    num_heads, scale, rate, seed = ctx.args
    dx, flat = attention_block_bwd_op(x, *weights, key_valid, *residuals,
                                      num_heads, scale, rate, seed, dout)
    return (dx, *split_grads(flat, *weights[0].shape), None, None, None,
            None, None, None)


attention_block_op.register_autograd(_backward, setup_context=_setup)


def attention_block_bwd(x, weights, residuals, num_heads: int, scale: float,
                        rate: float, seed: int, dout: torch.Tensor):
    """The backward, ``a8t::attention_block_bwd``, from the forward
    kernel's ``residuals`` (:func:`_forward_kernel`): ``(dx, dwq, dbq,
    dwk, dbk, dwv, dbv, dwo, dbo)``."""
    kv, q, k, v, o, o32, stats = residuals
    dx, flat = attention_block_bwd_op(
        x, *weights, None, kv, q, k, v, o, _empty(x) if o32 is o else o32,
        stats, num_heads, scale, rate, seed, dout)
    return (dx,) + split_grads(flat, *weights[0].shape)


def attention_block(x: torch.Tensor, wq: torch.Tensor, bq: torch.Tensor,
                    wk: torch.Tensor, bk: torch.Tensor, wv: torch.Tensor,
                    bv: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                    key_valid: Optional[torch.Tensor], num_heads: int,
                    scale: float, rate: float = 0.0,
                    seed: int = 0) -> torch.Tensor:
    """Self-attention of x through its four projections, the op
    ``a8t::attention_block``: ``(B, T, D)`` in the input dtype (float32 or
    bfloat16; weights and biases in the same dtype), differentiable in x
    and all eight weights and biases. ``rate``: attention-probability
    dropout with uint32 ``seed``. CPU tensors take the plain versions;
    CUDA tensors launch the kernels or raise."""
    weights = (wq, bq, wk, bk, wv, bv, wo, bo)
    with_residuals = torch.is_grad_enabled() and any(
        a.requires_grad for a in (x, *weights))
    return attention_block_op(x, *weights, key_valid, num_heads, scale, rate,
                              seed, with_residuals)[0]


attention_block.launches = 0
attention_block_bwd.launches = 0
