"""Attention core: softmax(q k^T * scale, key mask) [hash dropout] v.

Counterpart of ``audio8_tpu/ops/pallas/attention_kernel.py:attention_core``
and its custom VJP and, with ``xla=True``, of the XLA attention of
``audio8_tpu/nn/transformer.py:MultiHeadAttention`` (the JAX package's
path for ``fused_attention=None`` and wherever its kernel gates refuse).
Layout is the JAX one: q, k, v ``(B, H, T, dh)``, key_valid ``(B, T)``.
Both passes are custom ops, ``a8t::attention_core`` and
``a8t::attention_core_bwd``, with fake implementations. On CUDA tensors
:func:`attention_core` launches ``csrc/attention_fwd.cu`` (on the route
:func:`attention_route` names) and, when a gradient is needed, its
backward launches ``csrc/attention_bwd.cu``. On CPU tensors it runs the
plain versions, :func:`attention_core_plain` and
:func:`attention_core_bwd_plain`. Two
semantics, the same arithmetic otherwise (f32 scores and softmax, the
probabilities and ds cast to the input dtype before their products):

* "kernel" (the TPU kernel's ``_probs``, ``_fwd_kernel``,
  ``_bwd_kernel``): T padded to a multiple of 128, -1e9 for invalid and
  padded keys (a row with no valid key is uniform over T_pad), dropout
  keyed by ``row * T_pad + col`` with seed ``seed + b*H + h``, ds not
  zeroed at masked columns;
* "xla": softmax over the T real keys only, -1e9 for invalid keys (a row
  with no valid key is uniform over its T keys), dropout keyed by the
  flat (B, H, T, T) index with one seed (``_hash_keep_mask``), ds zeroed
  at masked columns (the gradient of ``jnp.where``). With
  ``bf16_softmax`` and bf16 inputs the scaled logits are rounded to bf16
  before the softmax, which then runs in f32 (JAX runs it in bf16: a
  documented deviation).

A block of rows that starts at row ``b0`` of a larger batch (a
data-parallel rank's rows, ``parallel/sharding.py``) passes ``b0``, and
the heads ``h0 .. h0 + H - 1`` of ``heads`` (a tensor-parallel rank's,
``parallel/tensor.py``) pass ``h0`` and ``heads``: its (b, h) draws the
masks of the global head ``g = (b0 + b)*heads + h0 + h`` in both
semantics (the seed ``seed + g``, or the flat (B, heads, T, T) index
from ``g*T*T``). The kernels take ``g`` as ``bh0 + b*hs + h``
(``bh0 = b0*heads + h0``, ``hs = heads``).
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
HEAD_DIMS = (16, 32, 64, 128)
KEY_TILE = 64  # keys per CTA of the backward kernel: one dq partial each


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


# the forward kernel's routes, by their codes in attention_fwd.cu
FWD_ROUTES = ("simt", "mma.sync", "wgmma")


def attention_route(dtype, dh: int, aligned: bool) -> str:
    """The forward kernel's route for a call, from its dtype, head dim and
    whether q, k, v (and the output) are 16-byte aligned; mirrors
    ``attention_fwd.cu:fwd_route``, which the kernel applies: "wgmma"
    (TMA-fed, FlashAttention-3 shaped) for bfloat16 at head dim 64 or
    128, "mma.sync" for other aligned bfloat16, "simt" for float32 and
    misaligned bfloat16."""
    if dtype != torch.bfloat16 or not aligned:
        return "simt"
    return "wgmma" if dh in (64, 128) else "mma.sync"


def hash_keep(t_pad: int, seeds: torch.Tensor, rate: float) -> torch.Tensor:
    """Keep masks ``(G, t_pad, t_pad)`` for per-group uint32 ``seeds``
    (int64 tensor of shape (G,)): bit-exact with ``_hash_keep`` of the TPU
    kernel, whose row stride is ``t_pad``."""
    dev = seeds.device
    r = torch.arange(t_pad, device=dev, dtype=torch.int64)
    idx = (r[:, None] * t_pad + r[None, :]) & _MASK32
    return mix32(idx[None] ^ (seeds[:, None, None] & _MASK32)) \
        >= keep_threshold(rate)


def _round_logits(xla: bool, bf16_softmax: bool, dtype) -> bool:
    return xla and bf16_softmax and dtype == torch.bfloat16


def _semantics_grid(q, xla):
    t = q.shape[2]
    return t if xla else round_up(t, 128)


def global_heads(b: int, h: int, device, b0: int = 0, h0: int = 0,
                 heads: int = 0) -> torch.Tensor:
    """The global head index ``(b0 + b)*heads + h0 + h`` of each of a
    call's (B, H) heads (int64, (B*H,)); ``heads`` 0 means ``h``."""
    hg = heads or h
    rows = torch.arange(b, device=device, dtype=torch.int64) + b0
    cols = torch.arange(h, device=device, dtype=torch.int64) + h0
    return (rows[:, None] * hg + cols[None, :]).reshape(-1)


def _keep(b, h, t_grid, rate, seed, xla, device, b0=0, h0=0, heads=0):
    if rate <= 0.0:
        return None
    g = global_heads(b, h, device, b0, h0, heads)
    if xla:
        n = t_grid * t_grid
        idx = (g[:, None] * n + torch.arange(n, device=device,
                                             dtype=torch.int64)) & _MASK32
        return (mix32(idx ^ (int(seed) & _MASK32)) >= keep_threshold(rate)
                ).view(b, h, t_grid, t_grid)
    return hash_keep(t_grid, (int(seed) + g) & _MASK32, rate).view(
        b, h, t_grid, t_grid)


def _scores(q, k, v, key_valid, scale, xla, bf16_softmax, extra=()):
    """Pads q, k, v (and ``extra``) to the semantics' grid; returns the
    masked f32 scores, the (B, T_grid) key mask and the padded tensors."""
    b, h, t, _ = q.shape
    t_grid = _semantics_grid(q, xla)
    pad = (0, 0, 0, t_grid - t)
    padded = [torch.nn.functional.pad(a, pad) for a in (q, k, v, *extra)]
    qp, kp = padded[0], padded[1]
    s = torch.matmul(qp.float(), kp.float().transpose(-1, -2)) * scale
    if _round_logits(xla, bf16_softmax, q.dtype):
        s = s.to(torch.bfloat16).float()
    valid = (torch.arange(t_grid, device=q.device) < t).expand(b, t_grid)
    if key_valid is not None:
        kv = torch.nn.functional.pad(key_valid.to(torch.bool),
                                     (0, t_grid - t))
        valid = valid & kv
    s = torch.where(valid[:, None, None, :], s,
                    torch.tensor(NEG, device=s.device))
    return s, valid, padded


def attention_core_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         key_valid: Optional[torch.Tensor], scale: float,
                         rate: float = 0.0, seed: int = 0, *,
                         xla: bool = False, bf16_softmax: bool = False,
                         b0: int = 0, h0: int = 0,
                         heads: int = 0) -> torch.Tensor:
    """Plain version of the forward in either semantics (the module
    docstring), computed on the semantics' grid."""
    b, h, t, dh = q.shape
    s, _, (qp, kp, vp) = _scores(q, k, v, key_valid, scale, xla,
                                 bf16_softmax)
    p = torch.softmax(s, dim=-1)
    keep = _keep(b, h, s.shape[-1], rate, seed, xla, q.device, b0, h0,
                 heads)
    if keep is not None:
        p = torch.where(keep, p * (1.0 / (1.0 - rate)),
                        torch.zeros((), device=p.device))
    out = torch.matmul(p.to(q.dtype), vp)
    return out[:, :, :t, :].contiguous()


def attention_core_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, key_valid: Optional[torch.Tensor],
                             scale: float, rate: float, seed: int,
                             dout: torch.Tensor, *, xla: bool = False,
                             bf16_softmax: bool = False, b0: int = 0,
                             h0: int = 0, heads: int = 0):
    """Plain version of the backward: ``(dq, dk, dv)`` by recompute on the
    semantics' grid, in the input dtype."""
    return tuple(g.to(q.dtype) for g in attention_core_bwd_f32(
        q, k, v, key_valid, scale, rate, seed, dout, xla=xla,
        bf16_softmax=bf16_softmax, b0=b0, h0=h0, heads=heads))


def attention_core_bwd_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           key_valid: Optional[torch.Tensor], scale: float,
                           rate: float, seed: int, dout: torch.Tensor, *,
                           xla: bool = False, bf16_softmax: bool = False,
                           b0: int = 0, h0: int = 0, heads: int = 0):
    """:func:`attention_core_bwd_plain` before its final rounding: the f32
    ``(dq, dk, dv)`` that the attention block's bias gradients sum."""
    b, h, t, dh = q.shape
    s, valid, padded = _scores(q, k, v, key_valid, scale, xla,
                               bf16_softmax, extra=(dout,))
    qp, kp, vp, dop = (a.float() for a in padded)
    p = torch.softmax(s, dim=-1)
    dpd = torch.matmul(dop, vp.transpose(-1, -2))
    zero = torch.zeros((), device=p.device)
    keep = _keep(b, h, s.shape[-1], rate, seed, xla, q.device, b0, h0,
                 heads)
    if keep is not None:
        pd = torch.where(keep, p * (1.0 / (1.0 - rate)), zero)
        dp = torch.where(keep, dpd * (1.0 / (1.0 - rate)), zero)
    else:
        pd, dp = p, dpd
    pd = pd.to(q.dtype).float()
    dv = torch.matmul(pd.transpose(-1, -2), dop)
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    if xla:
        ds = torch.where(valid[:, None, None, :], ds, zero)
    ds = ds.to(q.dtype).float()
    dq = torch.matmul(ds, kp) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qp) * scale
    return tuple(x[:, :, :t, :].contiguous() for x in (dq, dk, dv))


def validate(q, k, v, key_valid, rate, what):
    """The kernels' conditions on their inputs, on any device: raises on
    a dtype, shape, head dim or rate the kernels do not take."""
    if q.dtype not in _ext.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"{what}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                        "the kernel takes float32 or bfloat16")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{what}: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}; want equal "
                         "(B, H, T, dh) (self-attention)")
    b, h, t, dh = q.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {dh} not in {HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError(f"{what}: B*H = {b * h} > 65535")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{what}: q, k, v must be contiguous")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"{what}: rate {rate} not in [0, 1)")
    if key_valid is not None and key_valid.shape != (b, t):
        raise ValueError(f"{what}: key_valid {tuple(key_valid.shape)} != "
                         f"{(b, t)}")


def validate_bwd(q, dout, o32, stats, what="attention_core_bwd"):
    """The backward kernel's conditions on the output gradient and the
    forward's residuals, on any device."""
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"{what}: dout {tuple(dout.shape)} {dout.dtype} "
                         f"must match q {tuple(q.shape)} {q.dtype}")
    if o32 is None or o32.shape != q.shape or o32.dtype != torch.float32:
        raise ValueError(f"{what}: o32 must be the forward's f32 output")
    b, h, t, _ = q.shape
    if stats is None or stats.shape != (b * h * t, 2):
        raise ValueError(f"{what}: the forward's row statistics are "
                         "missing")


def _checked(q, k, v, key_valid, rate, what):
    """Validate CUDA inputs; returns the (B, T) uint8 key mask or None."""
    tensors = [q, k, v] + ([] if key_valid is None else [key_valid])
    if not all(a.is_cuda and a.device == q.device for a in tensors):
        raise ValueError(f"{what}: inputs must all be on the CPU or all on "
                         "one CUDA device")
    validate(q, k, v, key_valid, rate, what)
    return None if key_valid is None else \
        key_valid.to(torch.uint8).contiguous()


def aligned(*tensors: torch.Tensor) -> list:
    """The backward kernel moves rows as 16-byte copies: a tensor whose
    data pointer is off a 16-byte boundary is replaced by a fresh
    (aligned) copy."""
    return [a if a.data_ptr() % 16 == 0 else a.clone() for a in tensors]


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _dropout_args(rate: float, seed: int, h: int, b0: int = 0, h0: int = 0,
                  heads: int = 0):
    """The kernels' dropout arguments: 1 / (1 - rate), the threshold, the
    seed, the global head index of head 0 and the head stride (``bh0 =
    b0*heads + h0`` and ``hs = heads``, mod 2**32; ``heads`` 0 means the
    call's ``h``) and whether to drop."""
    hs = heads or h
    return (1.0 / (1.0 - rate), keep_threshold(rate), int(seed) & _MASK32,
            (int(b0) * hs + int(h0)) & _MASK32, hs & _MASK32,
            int(rate > 0.0))


def _forward_kernel(q, k, v, key_valid, scale, rate, seed,
                    with_stats: bool, xla: bool = False,
                    bf16_softmax: bool = False, b0: int = 0, h0: int = 0,
                    heads: int = 0):
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
                  *_dropout_args(rate, seed, h, b0, h0, heads), int(xla),
                  int(_round_logits(xla, bf16_softmax, q.dtype)),
                  _ext.stream_handle(q.device)), "attention_core")
    attention_core.launches += 1
    return o, stats, o32


def _backward_kernel(q, k, v, o32, stats, key_valid, scale, rate, seed,
                     dout, xla, bf16_softmax, f32_copies, b0=0, h0=0,
                     heads=0):
    """Launch ``attention_bwd.cu``: ``(dq, dk, dv)`` and, with
    ``f32_copies``, their f32 copies before the rounding, else None."""
    kv = _checked(q, k, v, key_valid, rate, "attention_core_bwd")
    validate_bwd(q, dout, o32, stats)
    b, h, t, dh = q.shape
    q, k, v, dout, o32 = aligned(q, k, v, dout.contiguous(),
                                 o32.contiguous())
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    f32 = dict(dtype=torch.float32, device=q.device)
    dvec = torch.empty((b * h * t,), **f32)
    dq_part = torch.empty((b * h, -(-t // KEY_TILE), t, dh), **f32)
    copies = [torch.empty(q.shape, **f32) for _ in range(3)] \
        if f32_copies else [None] * 3
    fn = _ext.function(BWD_SOURCE)
    _ext.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o32.data_ptr(),
                  dout.data_ptr(), _ptr(kv), stats.data_ptr(),
                  dvec.data_ptr(), dq_part.data_ptr(), dq.data_ptr(),
                  dk.data_ptr(), dv.data_ptr(), *map(_ptr, copies),
                  b, h, t, dh,
                  _ext.DTYPE_CODES[q.dtype], float(scale),
                  *_dropout_args(rate, seed, h, b0, h0, heads), int(xla),
                  int(_round_logits(xla, bf16_softmax, q.dtype)),
                  _ext.stream_handle(q.device)), "attention_core_bwd")
    attention_core_bwd.launches += 1
    return dq, dk, dv, *copies


# The forward and the backward as custom ops. The backward's residuals
# are the forward kernel's f32 output and row statistics on the card;
# the CPU's plain backward recomputes, so there they are empty tensors
# (each fake gives the shapes of its device). Outputs never alias one
# another: an f32 forward's o32 is ``o`` itself, returned empty.

def _empty(like: torch.Tensor) -> torch.Tensor:
    return like.new_empty((0,), dtype=torch.float32)


def _empties(like: torch.Tensor) -> tuple:
    return _empty(like), _empty(like), _empty(like)


@torch.library.custom_op("a8t::attention_core", mutates_args=(),
                         device_types="cpu")
def attention_core_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      key_valid: Optional[torch.Tensor], scale: float,
                      rate: float, seed: int, xla: bool, bf16_softmax: bool,
                      with_stats: bool, b0: int = 0, h0: int = 0,
                      heads: int = 0
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(o, o32, stats)``; the residuals empty unless ``with_stats`` on a
    CUDA device."""
    return (attention_core_plain(q, k, v, key_valid, scale, rate, seed,
                                 xla=xla, bf16_softmax=bf16_softmax, b0=b0,
                                 h0=h0, heads=heads),
            _empty(q), _empty(q))


@attention_core_op.register_kernel("cuda")
def _(q, k, v, key_valid, scale, rate, seed, xla, bf16_softmax, with_stats,
      b0=0, h0=0, heads=0):
    o, stats, o32 = _forward_kernel(q, k, v, key_valid, scale, rate, seed,
                                    with_stats, xla, bf16_softmax, b0, h0,
                                    heads)
    return (o, _empty(q) if o32 is None or o32 is o else o32,
            _empty(q) if stats is None else stats)


@attention_core_op.register_fake
def _(q, k, v, key_valid, scale, rate, seed, xla, bf16_softmax, with_stats,
      b0=0, h0=0, heads=0):
    if not (with_stats and q.is_cuda):
        return torch.empty_like(q), _empty(q), _empty(q)
    b, h, t, _ = q.shape
    o32 = _empty(q) if q.dtype == torch.float32 else \
        q.new_empty(q.shape, dtype=torch.float32)
    return (torch.empty_like(q), o32,
            q.new_empty((b * h * t, 2), dtype=torch.float32))


@torch.library.custom_op("a8t::attention_core_bwd", mutates_args=(),
                         device_types="cpu")
def attention_core_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          o32: torch.Tensor, stats: torch.Tensor,
                          key_valid: Optional[torch.Tensor], scale: float,
                          rate: float, seed: int, dout: torch.Tensor,
                          xla: bool, bf16_softmax: bool, f32_copies: bool,
                          b0: int = 0, h0: int = 0, heads: int = 0
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` in the input dtype, then their f32 copies (empty
    without ``f32_copies``); the plain version recomputes and ignores
    ``o32`` and ``stats``."""
    g32 = attention_core_bwd_f32(q, k, v, key_valid, scale, rate, seed,
                                 dout, xla=xla, bf16_softmax=bf16_softmax,
                                 b0=b0, h0=h0, heads=heads)
    if not f32_copies:
        return (*(g.to(q.dtype) for g in g32), *_empties(q))
    return (*(g.to(q.dtype, copy=True) for g in g32), *g32)


@attention_core_bwd_op.register_kernel("cuda")
def _(q, k, v, o32, stats, key_valid, scale, rate, seed, dout, xla,
      bf16_softmax, f32_copies, b0=0, h0=0, heads=0):
    dq, dk, dv, *copies = _backward_kernel(
        q, k, v, o32, stats, key_valid, scale, rate, seed, dout, xla,
        bf16_softmax, f32_copies, b0, h0, heads)
    return (dq, dk, dv, *(copies if f32_copies else _empties(q)))


@attention_core_bwd_op.register_fake
def _(q, k, v, o32, stats, key_valid, scale, rate, seed, dout, xla,
      bf16_softmax, f32_copies, b0=0, h0=0, heads=0):
    copies = tuple(q.new_empty(q.shape, dtype=torch.float32) if f32_copies
                   else _empty(q) for _ in range(3))
    return (*(torch.empty_like(q) for _ in range(3)), *copies)


def _setup(ctx, inputs, output):
    (q, k, v, key_valid, scale, rate, seed, xla, bf16_softmax, _, b0, h0,
     heads) = inputs
    o, o32, stats = output
    # an f32 forward's f32 output is o itself
    o32 = o if q.dtype == torch.float32 else o32
    ctx.save_for_backward(q, k, v, key_valid, o32, stats)
    ctx.args = (scale, rate, seed, xla, bf16_softmax, b0, h0, heads)


def _backward(ctx, dout, *_):
    """The custom VJP of the JAX ``attention_core`` (and, with ``xla``,
    the gradient of the XLA attention): residuals are the inputs (plus, on
    the card, the f32 output and the row statistics)."""
    q, k, v, key_valid, o32, stats = ctx.saved_tensors
    scale, rate, seed, xla, bf16_softmax, b0, h0, heads = ctx.args
    dq, dk, dv, *_ = attention_core_bwd_op(
        q, k, v, o32, stats, key_valid, scale, rate, seed, dout, xla,
        bf16_softmax, False, b0, h0, heads)
    return (dq, dk, dv) + (None,) * 10


attention_core_op.register_autograd(_backward, setup_context=_setup)


def attention_core_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       o32: torch.Tensor, stats: torch.Tensor,
                       key_valid: Optional[torch.Tensor], scale: float,
                       rate: float, seed: int, dout: torch.Tensor, *,
                       xla: bool = False, bf16_softmax: bool = False,
                       f32_copies: bool = False, b0: int = 0, h0: int = 0,
                       heads: int = 0):
    """The backward, ``a8t::attention_core_bwd``: ``(dq, dk, dv)`` from the
    forward's inputs, its output in f32 ``o32`` and its row ``stats``
    (both written by the forward kernel when a gradient is needed; the
    CPU's plain version recomputes without them). On the card one pass
    over the keys: the kernel writes one f32 dq partial per 64-key tile
    into a workspace, summed in a fixed order by a last pass. With
    ``f32_copies`` it also returns the gradients in f32 before their
    rounding (what the attention block's bias gradients sum)."""
    out = attention_core_bwd_op(q, k, v, o32, stats, key_valid, scale, rate,
                                seed, dout, xla, bf16_softmax, f32_copies,
                                b0, h0, heads)
    return out if f32_copies else out[:3]


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   key_valid: Optional[torch.Tensor], scale: float,
                   rate: float = 0.0, seed: int = 0, *, xla: bool = False,
                   bf16_softmax: bool = False, b0: int = 0, h0: int = 0,
                   heads: int = 0) -> torch.Tensor:
    """Fused attention core, ``a8t::attention_core``. q/k/v ``(B, H, T,
    dh)`` float32 or bfloat16; key_valid optional ``(B, T)`` bool; ``rate``
    the probability dropout (0 = off) with uint32 ``seed``. ``xla`` picks
    the semantics (the module docstring): False, the TPU kernel's (head
    ``(b, h)`` seeded ``seed + b*H + h``); True, the JAX XLA attention's,
    where ``bf16_softmax`` rounds bf16 logits. ``b0``: the batch row of
    row 0 (a data-parallel rank's row offset); ``h0`` and ``heads``: the
    global index of head 0 and the global head count (a tensor-parallel
    rank's heads; ``heads`` 0 is H). Returns ``(B, H, T, dh)``
    in the input dtype, differentiable in q, k and v. CPU tensors take
    the plain versions; CUDA tensors launch the kernels or raise."""
    with_stats = torch.is_grad_enabled() and any(
        a.requires_grad for a in (q, k, v))
    return attention_core_op(q, k, v, key_valid, scale, rate, seed, xla,
                             bf16_softmax, with_stats, int(b0), int(h0),
                             int(heads))[0]


attention_core.launches = 0
attention_core_bwd.launches = 0
