"""Small inputs for every ``a8t::`` custom op, for
``torch.library.opcheck``: the CPU tests run it on the plain versions,
``chip_smoke.py`` on the kernels. Each op gets inputs at the sizes its
kernel takes (channels in whole 16-byte vectors, head dims of 16 to 128)
with ragged edges (a short key row, odd lengths), gradients required
where the op has a registered autograd, so opcheck's autograd and
``aot_dispatch`` tests run the backward ops too.

    python -c "from audio8_tpu_torch.ops.samples import run_opcheck; \\
        print(run_opcheck('cpu'))"
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from audio8_tpu_torch.ops.adamw import adamw_op
from audio8_tpu_torch.ops.attention import (attention_core_bwd_op,
                                            attention_core_op)
from audio8_tpu_torch.ops.attention_block import (attention_block_bwd_op,
                                                  attention_block_op)
from audio8_tpu_torch.ops.conv import (conv_k3s2_dgrad_op, conv_k3s2_op,
                                       conv_k3s2_wgrad_op)
from audio8_tpu_torch.ops.ctc import ctc_loss_bwd_op, ctc_loss_op
from audio8_tpu_torch.ops.dropout import hash_dropout_op

OPS = {"conv_k3s2": conv_k3s2_op, "conv_k3s2_dgrad": conv_k3s2_dgrad_op,
       "conv_k3s2_wgrad": conv_k3s2_wgrad_op,
       "attention_core": attention_core_op,
       "attention_core_bwd": attention_core_bwd_op,
       "hash_dropout": hash_dropout_op, "ctc_loss": ctc_loss_op,
       "ctc_loss_bwd": ctc_loss_bwd_op,
       "attention_block": attention_block_op,
       "attention_block_bwd": attention_block_bwd_op, "adamw_": adamw_op}
# the ops that take float32 only (the CTC loss and AdamW)
F32_ONLY = ("ctc_loss", "ctc_loss_bwd", "adamw_")


def samples(name: str, device: str, dtype: torch.dtype,
            seed: int = 0) -> Tuple:
    """The positional arguments of one opcheck call of op ``name``."""
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=1.0, grad=False, dt=dtype):
        x = (torch.randn(shape, generator=gen) * scale).to(dt).to(device)
        return x.requires_grad_(grad)

    def empty(dt=torch.float32):
        return torch.empty((0,), dtype=dt, device=device)

    if name == "conv_k3s2":
        return rand(2, 41, 64, grad=True), rand(3, 64, 64, scale=0.1,
                                                grad=True)
    if name == "conv_k3s2_dgrad":
        return rand(2, 20, 64), rand(3, 64, 64, scale=0.1), 41
    if name == "conv_k3s2_wgrad":
        return rand(2, 42, 64), rand(2, 20, 64)
    b, h, t, dh = 2, 2, 70, 64
    key_valid = torch.arange(t, device=device)[None, :] < torch.tensor(
        [[t], [37]], device=device)
    if name == "attention_core":
        return (*(rand(b, h, t, dh, grad=True) for _ in range(3)),
                key_valid, dh ** -0.5, 0.1, 7, True, True, True)
    if name == "attention_core_bwd":
        q, k, v = (rand(b, h, t, dh) for _ in range(3))
        o32, stats = empty(), empty()
        if device != "cpu":  # the kernel reads the forward's residuals
            o, o32, stats = attention_core_op(q, k, v, key_valid, dh ** -0.5,
                                              0.1, 7, True, True, True)
            o32 = o32 if o32.numel() else o.clone()  # f32: o itself
        return (q, k, v, o32, stats, key_valid, dh ** -0.5, 0.1, 7,
                rand(b, h, t, dh), True, True, True)
    if name == "hash_dropout":
        return rand(3, 37, 64, grad=True), 0.1, 11
    lengths = dict(dtype=torch.int32, device=device)
    if name in ("ctc_loss", "ctc_loss_bwd"):
        lp = torch.log_softmax(rand(3, 23, 8, dt=torch.float32), -1)
        il = torch.tensor([23, 17, 0], **lengths)
        tg = torch.tensor([[1, 2, 3, 3], [4, 4, 0, 0], [0, 0, 0, 0]],
                          **lengths)
        tl = torch.tensor([4, 2, 0], **lengths)
        if name == "ctc_loss":
            return lp.requires_grad_(), il, tg, tl, 0, True
        work = ctc_loss_op(lp, il, tg, tl, 0, True)[1]
        return lp, il, tg, tl, work, rand(3, dt=torch.float32), 0
    d, heads = 128, 2
    weights = [rand(*s, scale=0.1, grad=name == "attention_block")
               for s in ((d, d), (d,)) * 3 + ((d, d), (d,))]
    if name == "attention_block":
        return (rand(b, t, d, grad=True), *weights, key_valid, heads,
                (d // heads) ** -0.5, 0.1, 5, True)
    if name == "attention_block_bwd":
        x = rand(b, t, d)
        _, *residuals = attention_block_op(x, *weights, key_valid, heads,
                                           (d // heads) ** -0.5, 0.1, 5, True)
        return (x, *weights, key_valid, *residuals, heads,
                (d // heads) ** -0.5, 0.1, 5, rand(b, t, d))
    if name == "adamw_":
        shapes = ((5,), (40, 70), (16385,))
        leaves = [[rand(*s, dt=torch.float32) for s in shapes]
                  for _ in range(4)]
        leaves[3] = [v.abs() for v in leaves[3]]
        return (*leaves, torch.tensor(0.5, device=device), 1e-3, 0.9, 0.98,
                1e-6, 0.01, 1.1, 1.2)
    raise KeyError(name)


def run_opcheck(device: str, names=None) -> Dict[str, Dict[str, str]]:
    """``torch.library.opcheck`` of every op (or ``names``) in float32 and,
    where the op takes it, bfloat16: ``{"<op> <dtype>": {test: result}}``.
    Raises on the first failure."""
    out = {}
    for name in names or OPS:
        dtypes: List[torch.dtype] = [torch.float32]
        if name not in F32_ONLY:
            dtypes.append(torch.bfloat16)
        for dtype in dtypes:
            out[f"{name} {dtype}"] = torch.library.opcheck(
                OPS[name], samples(name, device, dtype))
    return out
