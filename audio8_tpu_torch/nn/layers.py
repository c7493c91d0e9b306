"""Layer primitives of the port (``audio8_tpu/nn/layers.py``).

Conventions follow the JAX package at the module boundary: activations are
channel-last ``(B, T, C)``, every module takes a compute ``dtype`` and keeps
its parameters in float32, casting them to ``dtype`` at use (no autocast).
Parameters keep PyTorch's own layouts and fairseq's names (``weight``,
``bias``, ``weight_v``, ``weight_g``), so a fairseq state dict loads
without transposes; ``models/convert.py`` moves JAX trees across.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from audio8_tpu_torch.ops.conv import conv1d_k3s2
from audio8_tpu_torch.ops.quant import int8_dot, quantize_kernel


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as the JAX package pins it."""
    return F.gelu(x)


class Dense(nn.Linear):
    """``x @ W^T + b`` in the compute dtype; ``weight`` is ``(out, in)``.

    After :meth:`quantize_` (``ops.quant.quantize_model_params``) the
    weight is an int8 buffer beside a float32 ``weight_scale`` buffer and
    the product runs ``ops.quant.int8_dot``, as the JAX ``Dense`` does on
    an int8 kernel."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = dtype

    def reset_parameters(self) -> None:
        """Zeros: no global RNG at construction; ``init_from`` draws the
        random init from an explicit generator."""
        with torch.no_grad():
            self.weight.zero_()
            if self.bias is not None:
                self.bias.zero_()

    def init_from(self, generator: torch.Generator) -> None:
        """LeCun-normal weight (the JAX ``Dense`` init), zero bias."""
        std = 1.0 / math.sqrt(self.in_features)
        with torch.no_grad():
            self.weight.copy_(torch.randn(self.weight.shape,
                                          generator=generator,
                                          device=generator.device) * std)
            if self.bias is not None:
                self.bias.zero_()

    def quantize_(self) -> None:
        """Replace the float weight by its int8 codes and per-output
        scale (``ops.quant.quantize_kernel``), both buffers."""
        codes, scale = quantize_kernel(self.weight)
        del self.weight
        self.register_buffer("weight", codes)
        self.register_buffer("weight_scale", scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Below f32 the JAX ``Dense``'s rounding order: the product is
        rounded to ``dt`` first, then the ``dt`` bias is added with a
        second rounding (``F.linear`` with the bias would round once).
        In f32 the two orders agree, and the bias stays fused."""
        dt = self.compute_dtype
        if self.weight.dtype == torch.int8:
            y = int8_dot(x.to(dt), self.weight, self.weight_scale, dt)
            return y if self.bias is None else y + self.bias.to(dt)
        x, w = x.to(dt), self.weight.to(dt)
        if self.bias is None:
            return F.linear(x, w)
        if dt == torch.float32:
            return F.linear(x, w, self.bias)
        return F.linear(x, w) + self.bias.to(dt)


class Conv1D(nn.Module):
    """Strided VALID 1-D convolution over ``(B, T, C)``, with an optional
    bias (``use_bias``, the layer-norm extractor's conv bias).

    ``weight`` is torch's ``(C_out, C_in, K)``. The k=3, stride-2 layers
    (the wav2vec2 extractor's 512 -> 512 blocks) run the hand-written
    kernel ``ops.conv.conv1d_k3s2``; every other shape stays
    ``F.conv1d``, as the JAX package left it to XLA. The bias is added
    after the product in the compute dtype (``y + bias.astype(dtype)``
    in JAX: the product is rounded first)."""

    def __init__(self, in_features: int, out_features: int, kernel_size: int,
                 stride: int = 1, dtype: torch.dtype = torch.float32,
                 device=None, use_bias: bool = False):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.zeros(
            out_features, in_features, kernel_size, device=device))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(out_features, device=device))
        else:
            self.bias = None

    def init_from(self, generator: torch.Generator) -> None:
        """He-normal on fan_in = K * C_in (the reference's kaiming init),
        zero bias."""
        c_out, c_in, k = self.weight.shape
        std = math.sqrt(2.0 / (k * c_in))
        with torch.no_grad():
            self.weight.copy_(torch.randn(self.weight.shape,
                                          generator=generator,
                                          device=generator.device) * std)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.to(dt)
        if self.kernel_size == 3 and self.stride == 2:
            # (C_out, C_in, 3) -> (3, C_in, C_out), the kernel's layout
            w = self.weight.to(dt).permute(2, 1, 0).contiguous()
            y = conv1d_k3s2(x.contiguous(), w)
        else:
            # cuDNN takes a slow algorithm for a transposed (strided) input
            y = F.conv1d(x.transpose(1, 2).contiguous(), self.weight.to(dt),
                         stride=self.stride).transpose(1, 2)
        return y if self.bias is None else y + self.bias.to(dt)


def grouped_conv1d(x: torch.Tensor, weight: torch.Tensor, padding: int,
                   groups: int) -> torch.Tensor:
    """Stride-1 grouped convolution of ``(B, T, C)`` with ``padding``
    zeros on both sides, in ``x``'s dtype, channel-last out. On the CPU
    the operands are widened to f32 and the result rounded once, as XLA
    and cuDNN sum a bf16 product in f32 (PyTorch's CPU grouped conv in
    bf16 does not)."""
    dt = x.dtype
    xt = x.transpose(1, 2).contiguous()
    w = weight.to(dt)
    if not x.is_cuda:
        xt, w = xt.float(), w.float()
    y = F.conv1d(xt, w, padding=padding, groups=groups)
    return y.to(dt).transpose(1, 2)


class GroupedConv(nn.Module):
    """Stride-1 SAME grouped convolution with ``weight`` ``(C_out,
    C_in/groups, K)`` and an optional bias added after the product in the
    compute dtype (the JAX ``Conv1D`` with ``groups`` and ``padding``):
    data2vec's positional convs and the conformer's depthwise conv."""

    def __init__(self, features: int, kernel_size: int, groups: int,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.groups = groups
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.zeros(
            features, features // groups, kernel_size, device=device))
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)

    def init_from(self, generator: torch.Generator) -> None:
        """He-normal on fan_in = K * C_in/groups, zero bias."""
        _, c_in, k = self.weight.shape
        std = math.sqrt(2.0 / (k * c_in))
        with torch.no_grad():
            self.weight.copy_(torch.randn(self.weight.shape,
                                          generator=generator,
                                          device=generator.device) * std)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = grouped_conv1d(x.to(dt), self.weight, self.kernel_size // 2,
                           self.groups)
        if self.kernel_size % 2 == 0:  # fairseq SamePad
            y = y[:, :-1, :]
        return y if self.bias is None else y + self.bias.to(dt)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with torch epsilon (1e-5) and f32 statistics; output in
    the compute dtype."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__(features, eps=1e-5, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y.to(self.compute_dtype)


class GroupNorm(nn.Module):
    """GroupNorm over ``(B, T, C)``: statistics over (T, channels in group),
    eps 1e-5, f32 math.

    With a ``(B, T)`` validity ``mask`` the statistics cover valid frames
    only and padded frames come out as the bias, so a row's output does not
    depend on how much padding its batch carries. This is the JAX package's
    documented deviation from torch (docs/PARITY.md); ``F.group_norm`` would
    count the padding."""

    def __init__(self, num_groups: int, features: int,
                 dtype: torch.dtype = torch.float32, eps: float = 1e-5,
                 device=None):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, c = x.shape
        g = self.num_groups
        x32 = x.float().reshape(b, t, g, c // g)
        if mask is None:
            mean = x32.mean(dim=(1, 3), keepdim=True)
            var = (x32 - mean).square().mean(dim=(1, 3), keepdim=True)
            y = ((x32 - mean) * torch.rsqrt(var + self.eps)).reshape(b, t, c)
        else:
            # masked sums over time as (1, T) x (T, C) products: one read
            # of the activation each, where elementwise masking would
            # write and re-read full-size temporaries
            m = mask.float()[:, None, :]
            count = (m.sum(dim=2).clamp_min(1.0) * (c // g))[:, :, None]

            def group_sums(z):
                return torch.bmm(m, z.reshape(b, t, c)).reshape(b, g, c // g)

            mean = (group_sums(x32).sum(dim=2, keepdim=True) / count)
            d = x32 - mean[:, None]
            var = group_sums(d * d).sum(dim=2, keepdim=True) / count
            scale = (torch.rsqrt(var + self.eps)[:, None]
                     * self.weight.float().reshape(g, c // g))
            bias = self.bias.float().reshape(g, c // g)
            y = torch.addcmul(bias, d, scale)
            # padded frames come out as the bias, as y * mask + bias would
            y = torch.where(mask[:, :, None, None], y, bias).reshape(b, t, c)
            return y.to(self.compute_dtype)
        y = y * self.weight.float() + self.bias.float()
        return y.to(self.compute_dtype)


class PositionalConv(nn.Module):
    """Weight-normed grouped convolutional positional embedding + GELU
    (``audio8_tpu/nn/layers.py:PositionalConv``; fairseq ``pos_conv.0``).

    ``weight_v`` ``(C, C/groups, K)``, ``weight_g`` ``(1, 1, K)`` (torch
    ``weight_norm`` with ``dim=2``), ``bias`` ``(C,)``. The kernel is
    ``g * v / (||v|| + 1e-12)`` with the norm per tap, as in the JAX module.
    fairseq SamePad: pad K//2 both sides, drop the trailing frame for an
    even K."""

    def __init__(self, features: int, kernel_size: int = 128,
                 groups: int = 16, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.groups = groups
        self.compute_dtype = dtype
        self.weight_v = nn.Parameter(torch.zeros(
            features, features // groups, kernel_size, device=device))
        self.weight_g = nn.Parameter(torch.ones(1, 1, kernel_size,
                                                device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def init_from(self, generator: torch.Generator,
                  dropout_rate: float = 0.1) -> None:
        c_out = self.weight_v.shape[0]
        std = math.sqrt(4.0 * (1.0 - dropout_rate)
                        / (self.kernel_size * c_out))
        with torch.no_grad():
            self.weight_v.copy_(torch.randn(self.weight_v.shape,
                                            generator=generator,
                                            device=generator.device) * std)
            self.weight_g.copy_(self._norm())
            self.bias.zero_()

    def _norm(self) -> torch.Tensor:
        return torch.linalg.vector_norm(self.weight_v.float(), dim=(0, 1),
                                        keepdim=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        kernel = (self.weight_g.float() * self.weight_v.float()
                  / (self._norm() + 1e-12)).to(dt)
        y = grouped_conv1d(x.to(dt), kernel, self.kernel_size // 2,
                           self.groups)
        if self.kernel_size % 2 == 0:
            y = y[:, :-1, :]
        return gelu(y + self.bias.to(dt))


def _plain_layer_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Affine-less LayerNorm over the channels with f32 statistics, in
    ``x``'s dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class StackedPositionalConv(nn.Module):
    """data2vec-audio's positional embedding
    (``audio8_tpu/nn/layers.py:StackedPositionalConv``): ``depth`` blocks
    of [grouped SAME conv with bias, affine-less LayerNorm, GELU], no
    weight norm. Children keep fairseq's names: block ``i``'s conv is
    ``{i}.0`` (``weight`` ``(C, C/groups, K)``, ``bias``)."""

    def __init__(self, features: int, depth: int = 5, kernel_size: int = 19,
                 groups: int = 16, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        for i in range(depth):
            block = nn.Module()
            block.add_module("0", GroupedConv(features, kernel_size, groups,
                                              True, dtype, device))
            self.add_module(str(i), block)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.children():
            x = gelu(_plain_layer_norm(getattr(block, "0")(x)))
        return x
