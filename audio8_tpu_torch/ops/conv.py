"""Stride-2, kernel-3 VALID 1-D convolution over channel-last activations.

Counterpart of ``audio8_tpu/ops/pallas/conv_kernel.py:conv1d_k3s2`` and
its custom VJP. :func:`conv1d_k3s2` is differentiable in ``x`` and ``w``:
its forward is ``csrc/conv_k3s2_fwd.cu`` (on the route :func:`fwd_route`
names), its backward the dgrad and wgrad kernels of
``csrc/conv_k3s2_bwd.cu`` (:func:`conv1d_k3s2_dgrad`,
:func:`conv1d_k3s2_wgrad`). Each kernel is a custom op
(``a8t::conv_k3s2``, ``a8t::conv_k3s2_dgrad``, ``a8t::conv_k3s2_wgrad``)
with a fake implementation, so ``torch.export`` traces through it. On
CPU tensors each op runs its plain version, the same function in plain
PyTorch, which is also what the kernel is checked against on the card;
on CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import math

import torch

from audio8_tpu_torch.ops import _ext

SOURCE = "conv_k3s2_fwd.cu"
BWD_SOURCE = "conv_k3s2_bwd.cu"
# wgrad: the output tiles (3*C_in x C_out in 128x128 tiles) times the
# splits of the row reduction aim at this many CTAs per SM (two waves of
# two resident CTAs); a split keeps at least MIN_SPLIT_ROWS rows
WGRAD_CTAS_PER_SM = 4
MIN_SPLIT_ROWS = 256
# wgrad's and dgrad's routes, by their codes in conv_k3s2_bwd.cu; the
# wgrad wgmma route's K stages are 64 t rows of one batch row
WGRAD_ROUTES = DGRAD_ROUTES = ("simt", "mma.sync", "wgmma")
STAGE_ROWS = 64
# the forward's routes, by their codes in conv_k3s2_fwd.cu
FWD_ROUTES = ("generic", "simt", "mma.sync", "wgmma")


def t_out_of(t_in: int) -> int:
    return (t_in - 3) // 2 + 1


def fwd_route(dtype, c_in: int, c_out: int, aligned: bool = True) -> str:
    """The forward's route for a shape; mirrors
    ``conv_k3s2_fwd.cu:fwd_route``, which the kernel applies (``aligned``:
    x, w and y on 16-byte boundaries): "wgmma" (``csrc/tma_gemm.cuh``'s
    TMA-fed GEMM) for bfloat16 with C_in and C_out multiples of 64 (TMA's
    64 x 64 boxes), "mma.sync" for other bfloat16 with multiples of 8,
    "simt" for float32 with multiples of 4, "generic" otherwise."""
    if not aligned or dtype not in (torch.float32, torch.bfloat16):
        return "generic"
    if dtype == torch.float32:
        return "simt" if c_in % 4 == 0 and c_out % 4 == 0 else "generic"
    if c_in % 64 == 0 and c_out % 64 == 0:
        return "wgmma"
    return "mma.sync" if c_in % 8 == 0 and c_out % 8 == 0 else "generic"


def conv1d_k3s2_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: an overlapping strided view of ``x`` times
    ``w.reshape(3 * C_in, C_out)``. Row t of the view is x[2t:2t+3]
    flattened, i.e. the 3*C_in contiguous elements the kernel reads."""
    b, t, c_in = x.shape
    c_out = w.shape[-1]
    x = x.contiguous()
    rows = x.as_strided((b, t_out_of(t), 3 * c_in), (t * c_in, 2 * c_in, 1),
                        x.storage_offset())
    return torch.matmul(rows, w.reshape(3 * c_in, c_out))


def conv1d_k3s2_dgrad_plain(dy: torch.Tensor, w: torch.Tensor,
                            t_in: int) -> torch.Tensor:
    """Plain dgrad: ``dx`` (B, T_in, C_in) of ``y = conv1d_k3s2(x, w)``.

    Paired rows, as the kernel computes them: row t of a view of dy with
    one zero row in front and one behind is ``[dy[t-1] | dy[t]]``; times
    ``[W2^T; W0^T]`` it is dx[2t], its second half times ``W1^T`` is
    dx[2t+1]. t runs to T_out inclusive, which gives the tail rows
    ``dx[2 T_out] = dy[T_out-1] W2^T`` and a zero ``dx[2 T_out + 1]``
    (even T_in)."""
    b, t_out, c_out = dy.shape
    c_in = w.shape[1]
    dyp = torch.nn.functional.pad(dy, (0, 0, 1, 1))
    rows = dyp.as_strided((b, t_out + 1, 2 * c_out),
                          ((t_out + 2) * c_out, c_out, 1))
    wt = w.transpose(1, 2)  # (3, C_out, C_in)
    even = torch.matmul(rows, torch.cat([wt[2], wt[0]], dim=0))
    odd = torch.matmul(rows[..., c_out:], wt[1])
    dx = torch.stack([even, odd], dim=2).reshape(b, 2 * (t_out + 1), c_in)
    return dx[:, :t_in].contiguous()


def conv1d_k3s2_wgrad_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain wgrad: ``dW`` (3, C_in, C_out) in float32, the sum over rows
    (b, t) of ``x[b, 2t:2t+3]`` flattened (outer) ``dy[b, t]``, from f32
    copies of the operands (a bf16 product is exact in f32)."""
    b, t, c_in = x.shape
    c_out = dy.shape[-1]
    x = x.contiguous()
    rows = x.as_strided((b, t_out_of(t), 3 * c_in), (t * c_in, 2 * c_in, 1),
                        x.storage_offset())
    dw = torch.zeros((3 * c_in, c_out), dtype=torch.float32, device=x.device)
    for i in range(b):
        dw += torch.matmul(rows[i].float().T, dy[i].float())
    return dw.reshape(3, c_in, c_out)


def _check_devices(what: str, *tensors: torch.Tensor,
                   cuda: bool = False) -> None:
    """All on one device (the fakes check it too), a CUDA one with
    ``cuda``."""
    dev = tensors[0].device
    if any(a.device != dev or (cuda and not a.is_cuda) for a in tensors):
        raise ValueError(f"{what}: tensors on "
                         f"{[str(a.device) for a in tensors]}; both must be "
                         "CPU or the same CUDA device")


def _check_cuda(what: str, *tensors: torch.Tensor) -> None:
    _check_devices(what, *tensors, cuda=True)
    dt = tensors[0].dtype
    if dt not in _ext.DTYPE_CODES or any(a.dtype != dt for a in tensors):
        raise TypeError(f"{what}: dtypes {[a.dtype for a in tensors]}; the "
                        "kernel takes float32 or bfloat16, all the same")
    if not all(a.dim() == 3 and a.is_contiguous() for a in tensors):
        raise ValueError(f"{what}: want contiguous 3-d tensors, got "
                         f"{[tuple(a.shape) for a in tensors]}")


def _vectors(what: str, c_in: int, c_out: int,
             *tensors: torch.Tensor) -> list[torch.Tensor]:
    """The backward kernels move channel rows as 16-byte vectors: the
    channel counts must be whole vectors (multiples of 4 in float32, of 8
    in bfloat16), and an input whose data pointer is off a 16-byte
    boundary is replaced by a fresh (aligned) copy."""
    vec = 16 // tensors[0].element_size()
    if c_in % vec or c_out % vec:
        raise ValueError(f"{what}: C_in={c_in}, C_out={c_out}; the kernel "
                         f"wants multiples of {vec} in {tensors[0].dtype}")
    return [a if a.data_ptr() % 16 == 0 else a.clone() for a in tensors]


def _forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The forward kernel on CUDA tensors (the route is the kernel's own
    choice, :func:`fwd_route`)."""
    _check_cuda("conv1d_k3s2", x, w)
    b, t, c_in = x.shape
    c_out = w.shape[2]
    if w.shape[0] != 3 or w.shape[1] != c_in:
        raise ValueError(f"conv1d_k3s2: shapes {tuple(x.shape)} x "
                         f"{tuple(w.shape)}; want (B, T, C_in) x "
                         "(3, C_in, C_out)")
    if t < 3:
        raise ValueError(f"conv1d_k3s2: T={t} < kernel size 3")
    y = torch.empty((b, t_out_of(t), c_out), dtype=x.dtype, device=x.device)
    fn = _ext.function(SOURCE)
    _ext.check(fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), b, t, c_in,
                  c_out, _ext.DTYPE_CODES[x.dtype],
                  _ext.stream_handle(x.device)), "conv1d_k3s2")
    conv1d_k3s2.launches += 1
    return y


def conv1d_k3s2_dgrad(dy: torch.Tensor, w: torch.Tensor,
                      t_in: int) -> torch.Tensor:
    """dgrad: ``dy`` (B, T_out, C_out), ``w`` (3, C_in, C_out) -> ``dx``
    (B, T_in, C_in) in dy's dtype, f32 accumulation: the op
    ``a8t::conv_k3s2_dgrad``. CPU tensors take the plain version; CUDA
    tensors launch the kernel on the route :func:`dgrad_route` names or
    raise (channel counts as :func:`_vectors` sets out)."""
    b, t_out, c_out = dy.shape
    if w.dim() != 3 or w.shape[0] != 3 or w.shape[2] != c_out \
            or t_in < 3 or t_out_of(t_in) != t_out:
        raise ValueError(f"conv1d_k3s2_dgrad: dy {tuple(dy.shape)}, w "
                         f"{tuple(w.shape)}, T_in {t_in} do not fit")
    return conv_k3s2_dgrad_op(dy, w, t_in)


def _dgrad(dy: torch.Tensor, w: torch.Tensor, t_in: int) -> torch.Tensor:
    """The dgrad kernel on CUDA tensors."""
    b, t_out, c_out = dy.shape
    c_in = w.shape[1]
    wgmma = dgrad_route(dy.dtype, c_in, c_out) == "wgmma"
    # the wgmma route reads w's taps as they lie; the others read wt = w^T
    # (3, C_out, C_in), as the TPU's
    wk = w.contiguous() if wgmma else w.transpose(1, 2).contiguous()
    _check_cuda("conv1d_k3s2_dgrad", dy, wk)
    dy, wk = _vectors("conv1d_k3s2_dgrad", c_in, c_out, dy, wk)
    dx = torch.empty((b, t_in, c_in), dtype=dy.dtype, device=dy.device)
    fn = _ext.function(BWD_SOURCE, "dgrad")
    _ext.check(fn(dy.data_ptr(), wk.data_ptr() if wgmma else None,
                  None if wgmma else wk.data_ptr(), dx.data_ptr(), b, t_in,
                  c_in, c_out, _ext.DTYPE_CODES[dy.dtype],
                  _ext.stream_handle(dy.device)), "conv1d_k3s2_dgrad")
    conv1d_k3s2_dgrad.launches += 1
    return dx


def wgrad_splits(rows: int, c_in: int, c_out: int, sms: int
                 ) -> tuple[int, int]:
    """(splits, rows per split) of wgrad's row reduction: enough CTAs for
    ``WGRAD_CTAS_PER_SM`` per SM over the 128x128 output tiles, each split
    at least ``MIN_SPLIT_ROWS`` rows, rows per split a multiple of 64."""
    tiles = math.ceil(3 * c_in / 128) * math.ceil(c_out / 128)
    splits = max(1, min(math.ceil(WGRAD_CTAS_PER_SM * sms / tiles),
                        rows // MIN_SPLIT_ROWS))
    per = math.ceil(math.ceil(rows / splits) / 64) * 64
    return math.ceil(rows / per), per


def wgrad_route(dtype, c_in: int, c_out: int) -> str:
    """wgrad's route for a shape; mirrors ``conv_k3s2_bwd.cu:wgrad_route``,
    which the kernel applies: "wgmma" (``csrc/tma_gemm.cuh``'s TMA-fed
    GEMM) for bfloat16 with C_in and C_out multiples of 64 (TMA's 64 x 64
    boxes), "mma.sync" for other bfloat16, "simt" for float32."""
    if dtype != torch.bfloat16:
        return "simt"
    return "wgmma" if c_in % 64 == 0 and c_out % 64 == 0 else "mma.sync"


def dgrad_route(dtype, c_in: int, c_out: int) -> str:
    """dgrad's route for a shape; mirrors ``conv_k3s2_bwd.cu:dgrad_route``,
    which the kernel applies, and is :func:`wgrad_route`'s rule: "wgmma"
    (the TMA-fed GEMM, one product per half of dx) for bfloat16 with C_in
    and C_out multiples of 64, "mma.sync" for other bfloat16, "simt" for
    float32."""
    return wgrad_route(dtype, c_in, c_out)


def wgrad_wgmma_slices(batch: int, t_in: int, c_in: int, c_out: int,
                       sms: int) -> tuple[int, int]:
    """(S, K stages per slice) of the wgmma route: the K stages are the
    (b, 64-row t tile) pairs, ``batch * ceil(T_out / 64)`` of them, and
    S fixed slices of ``ceil(stages / S)`` consecutive stages each (the
    kernel's own cut) such that the 3 x ceil(C_in / 128) x ceil(C_out /
    BN) output tiles (BN = 256 where C_out >= 256, else 128) times S fill
    the ``sms`` SMs once."""
    stages = batch * -(-t_out_of(t_in) // STAGE_ROWS)
    tiles = 3 * -(-c_in // 128) * -(-c_out // (256 if c_out >= 256 else 128))
    per = -(-stages // max(1, min(stages, sms // tiles)))
    return -(-stages // per), per


def conv1d_k3s2_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """wgrad: ``x`` (B, T_in, C_in), ``dy`` (B, T_out, C_out) -> ``dW``
    (3, C_in, C_out) in float32: the op ``a8t::conv_k3s2_wgrad``. CPU
    tensors take the plain version; CUDA tensors launch the kernel on the
    route :func:`wgrad_route` names (split over the rows, partials summed
    in a fixed order) or raise (channel counts as :func:`_vectors` sets
    out)."""
    b, t_in, c_in = x.shape
    if dy.dim() != 3 or dy.shape[0] != b or t_in < 3 \
            or dy.shape[1] != t_out_of(t_in):
        raise ValueError(f"conv1d_k3s2_wgrad: x {tuple(x.shape)}, dy "
                         f"{tuple(dy.shape)} do not fit")
    return conv_k3s2_wgrad_op(x, dy)


def _wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The wgrad kernel on CUDA tensors."""
    _check_cuda("conv1d_k3s2_wgrad", x, dy)
    b, t_in, c_in = x.shape
    c_out = dy.shape[2]
    x, dy = _vectors("conv1d_k3s2_wgrad", c_in, c_out, x, dy)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    if wgrad_route(x.dtype, c_in, c_out) == "wgmma":
        splits, stages = wgrad_wgmma_slices(b, t_in, c_in, c_out, sms)
        per = STAGE_ROWS * stages  # the padded rows of a slice
    else:
        splits, per = wgrad_splits(b * dy.shape[1], c_in, c_out, sms)
    dw = torch.empty((3, c_in, c_out), dtype=torch.float32, device=x.device)
    part = (torch.empty((splits, 3, c_in, c_out), dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    fn = _ext.function(BWD_SOURCE, "wgrad")
    _ext.check(fn(x.data_ptr(), dy.data_ptr(), dw.data_ptr(),
                  None if part is None else part.data_ptr(), b, t_in, c_in,
                  c_out, splits, per, _ext.DTYPE_CODES[x.dtype],
                  _ext.stream_handle(x.device)), "conv1d_k3s2_wgrad")
    conv1d_k3s2_wgrad.launches += 1
    return dw


# The three kernels as custom ops: "cpu" runs the plain version, "cuda"
# the kernel (or raises), the fake gives the output's shape alone, so a
# trace (torch.export, opcheck) neither picks a route nor counts a launch.

@torch.library.custom_op("a8t::conv_k3s2", mutates_args=(),
                         device_types="cpu")
def conv_k3s2_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return conv1d_k3s2_plain(x, w)


@torch.library.custom_op("a8t::conv_k3s2_dgrad", mutates_args=(),
                         device_types="cpu")
def conv_k3s2_dgrad_op(dy: torch.Tensor, w: torch.Tensor,
                       t_in: int) -> torch.Tensor:
    return conv1d_k3s2_dgrad_plain(dy, w, t_in)


@torch.library.custom_op("a8t::conv_k3s2_wgrad", mutates_args=(),
                         device_types="cpu")
def conv_k3s2_wgrad_op(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    return conv1d_k3s2_wgrad_plain(x, dy)


conv_k3s2_op.register_kernel("cuda")(_forward)
conv_k3s2_dgrad_op.register_kernel("cuda")(_dgrad)
conv_k3s2_wgrad_op.register_kernel("cuda")(_wgrad)


@conv_k3s2_op.register_fake
def _(x, w):
    _check_devices("conv1d_k3s2", x, w)
    b, t, _ = x.shape
    return x.new_empty((b, (t - 3) // 2 + 1, w.shape[2]))


@conv_k3s2_dgrad_op.register_fake
def _(dy, w, t_in):
    _check_devices("conv1d_k3s2_dgrad", dy, w)
    return dy.new_empty((dy.shape[0], t_in, w.shape[1]))


@conv_k3s2_wgrad_op.register_fake
def _(x, dy):
    _check_devices("conv1d_k3s2_wgrad", x, dy)
    return x.new_empty((3, x.shape[2], dy.shape[2]), dtype=torch.float32)


def _setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, dy):
    """The custom VJP of the JAX ``conv1d_k3s2``: the residuals are the
    inputs, ``dW = wgrad(x, dy).astype(w.dtype)``."""
    x, w = ctx.saved_tensors
    dy = dy.contiguous()
    dx = dw = None
    if ctx.needs_input_grad[0]:
        dx = conv1d_k3s2_dgrad(dy, w, x.shape[1])
    if ctx.needs_input_grad[1]:
        dw = conv1d_k3s2_wgrad(x, dy).to(w.dtype)
    return dx, dw


conv_k3s2_op.register_autograd(_backward, setup_context=_setup)


def conv1d_k3s2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, T, C_in) x (3, C_in, C_out) -> (B, (T-3)//2+1, C_out), VALID:
    the op ``a8t::conv_k3s2``.

    f32 or bf16 inputs (both the same dtype), f32 accumulation, output in
    the input dtype; differentiable in both. CPU tensors take the plain
    versions; CUDA tensors launch the kernels or raise."""
    return conv_k3s2_op(x, w)


conv1d_k3s2.launches = 0
conv1d_k3s2_dgrad.launches = 0
conv1d_k3s2_wgrad.launches = 0
