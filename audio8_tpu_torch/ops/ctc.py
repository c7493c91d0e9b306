"""CTC loss and greedy decoding (``audio8_tpu/ops/ctc.py``).

:func:`ctc_loss` has the JAX function's signature and semantics: log-probs
``(B, T, V)`` already log-softmaxed, padded targets ``(B, U)``, true frame
and label counts, ``sum``/``mean``/``none`` reductions and
``zero_infinity``, all in float32. On CUDA tensors its forward and
backward are the hand-written kernel ``csrc/ctc_loss.cu`` (the port of
the Pallas ``ctc_loss_pallas``, the JAX package's default on its
accelerator: the forward launch runs the alpha and beta sweeps at the
same time, the backward launch forms dE and scatters it); on CPU tensors
it runs :func:`ctc_loss_plain`, the log-semiring scan of
``ctc_forward_alphas`` differentiated by autograd.

Both keep the TPU kernel's conventions: NEG_INF = -1e30 with the
double-where ``logaddexp3``, states past ``2 U_b + 1`` killed, frames at or
past ``input_length`` leaving the state untouched. One consequence: a row
with ``input_length`` 0 (a padding row of a snapped batch) has ll =
NEG_INF, as with the Pallas kernel; the JAX scan starts such a row from
frame 0 anyway. Training weights those rows out either way
(``train/steps.py:row_validity``).
"""
from __future__ import annotations

from typing import Iterable, List

import torch

from audio8_tpu_torch.ops import _ext

SOURCE = "ctc_loss.cu"
NEG_INF = -1e30


def _logaddexp3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    safe = m > NEG_INF / 2
    m_safe = torch.where(safe, m, torch.zeros_like(m))
    s = torch.exp(a - m_safe) + torch.exp(b - m_safe) + torch.exp(c - m_safe)
    out = m_safe + torch.log(torch.where(s > 0, s, torch.ones_like(s)))
    return torch.where(safe, out, torch.full_like(out, NEG_INF))


def extended_labels(targets: torch.Tensor, blank: int) -> torch.Tensor:
    """(B, U) -> (B, 2U+1): [blank, y1, blank, y2, ..., blank]."""
    b, u = targets.shape
    ext = torch.full((b, 2 * u + 1), blank, dtype=torch.int64,
                     device=targets.device)
    ext[:, 1::2] = targets.long()
    return ext


def ctc_loss_plain(log_probs: torch.Tensor, input_lengths: torch.Tensor,
                   targets: torch.Tensor, target_lengths: torch.Tensor,
                   blank: int = 0) -> torch.Tensor:
    """Per-row -log p(y | x) ``(B,)`` by the alpha scan over time
    (``ctc_forward_alphas`` with the TPU kernel's conventions); infeasible
    rows give about 1e30. Differentiable by autograd."""
    bsz, t_max, _ = log_probs.shape
    ext = extended_labels(targets, blank)
    s_n = ext.shape[1]
    dev = log_probs.device
    prev2 = torch.cat([torch.full((bsz, 2), -1, dtype=ext.dtype, device=dev),
                       ext[:, :-2]], dim=1)
    allow_skip = (ext != blank) & (ext != prev2)
    lane = torch.arange(s_n, device=dev)[None, :]
    tl = target_lengths.long().to(dev)[:, None]
    live = lane < 2 * tl + 1
    neg = torch.full((bsz, s_n), NEG_INF, device=dev)
    emits = torch.gather(log_probs.float(), 2,
                         ext[:, None, :].expand(bsz, t_max, s_n))
    emits = torch.where(live[:, None, :], emits, NEG_INF)
    ilen = input_lengths.long().to(dev)[:, None]
    col = torch.full((bsz, 1), NEG_INF, device=dev)
    alpha = neg
    for t in range(t_max):
        e = emits[:, t]
        if t == 0:
            new = torch.where(lane <= 1, e, neg)
        else:
            a1 = torch.cat([col, alpha[:, :-1]], dim=1)
            a2 = torch.cat([col, col, alpha[:, :-2]], dim=1)
            a2 = torch.where(allow_skip, a2, neg)
            new = _logaddexp3(alpha, a1, a2) + e
        alpha = torch.where(t < ilen, new, alpha)
    final = (lane == 2 * tl) | ((lane == 2 * tl - 1) & (tl > 0))
    fin = torch.where(final, alpha, neg)
    m = fin.max(dim=1, keepdim=True).values
    ok = m > NEG_INF / 2
    m_safe = torch.where(ok, m, torch.zeros_like(m))
    terms = torch.where(fin > NEG_INF / 2, torch.exp(fin - m_safe),
                        torch.zeros_like(fin))
    ll = m_safe + torch.log(torch.clamp(terms.sum(dim=1, keepdim=True),
                                        min=1e-37))
    ll = torch.where(ok, ll, torch.full_like(ll, NEG_INF))
    return -ll[:, 0]


def _int32(x: torch.Tensor, device) -> torch.Tensor:
    return x.to(device=device, dtype=torch.int32).contiguous()


class _CTCLoss(torch.autograd.Function):
    """Per-row loss through the kernel. The forward launch runs the alpha
    and (when a gradient is needed) the beta sweep at the same time and
    parks both in the workspace; the backward launch turns them into dE
    and sums it onto the vocabulary."""

    @staticmethod
    def forward(ctx, log_probs, input_lengths, targets, target_lengths,
                blank):
        lp = log_probs.float().contiguous()
        b, t, v = lp.shape
        u = targets.shape[1]
        if 2 * u + 1 > 2048:
            raise ValueError(f"ctc_loss: {u} target labels > 1023, the "
                             "kernel's state limit")
        dev = lp.device
        il, tg, tl = (_int32(x, dev) for x in (input_lengths, targets,
                                               target_lengths))
        ll = torch.empty((b,), dtype=torch.float32, device=dev)
        # alpha and beta_hat (B, T, 2U+1) each, then ll in log2 units
        work = (torch.empty((2 * b * t * (2 * u + 1) + b,),
                            dtype=torch.float32, device=dev)
                if ctx.needs_input_grad[0] else None)
        fn = _ext.function(SOURCE)
        _ext.check(fn(lp.data_ptr(), il.data_ptr(), tg.data_ptr(),
                      tl.data_ptr(), ll.data_ptr(),
                      None if work is None else work.data_ptr(), b, t, v,
                      u, int(blank), _ext.stream_handle(dev)), "ctc_loss")
        ctc_loss.launches += 1
        if work is not None:
            ctx.save_for_backward(lp, il, tg, tl, work)
        ctx.shape = (b, t, v, u, int(blank), log_probs.dtype)
        return -ll

    @staticmethod
    def backward(ctx, g):
        lp, il, tg, tl, work = ctx.saved_tensors
        b, t, v, u, blank, dtype = ctx.shape
        g = g.float().contiguous()
        grad = torch.empty((b, t, v), dtype=torch.float32, device=g.device)
        fn = _ext.function(SOURCE, "bwd")
        _ext.check(fn(lp.data_ptr(), il.data_ptr(), tg.data_ptr(),
                      tl.data_ptr(), work.data_ptr(), g.data_ptr(),
                      grad.data_ptr(), b, t, v, u, blank,
                      _ext.stream_handle(g.device)), "ctc_loss backward")
        return grad.to(dtype), None, None, None, None


def ctc_loss(log_probs: torch.Tensor, input_lengths: torch.Tensor,
             targets: torch.Tensor, target_lengths: torch.Tensor,
             blank: int = 0, reduction: str = "sum",
             zero_infinity: bool = True) -> torch.Tensor:
    """Negative log-likelihood of the target labelling under CTC, with
    the semantics of the JAX ``ctc_loss`` (torch's ``F.ctc_loss``
    reductions: ``mean`` divides each row by its target length, then
    averages). CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    if reduction not in ("sum", "mean", "none"):
        raise ValueError(f"ctc_loss: reduction {reduction!r}")
    if log_probs.device.type == "cpu":
        loss = ctc_loss_plain(log_probs, input_lengths, targets,
                              target_lengths, blank)
    elif log_probs.is_cuda:
        if log_probs.dim() != 3 or targets.dim() != 2 \
                or targets.shape[0] != log_probs.shape[0]:
            raise ValueError(f"ctc_loss: log_probs {tuple(log_probs.shape)}"
                             f", targets {tuple(targets.shape)}")
        loss = _CTCLoss.apply(log_probs, input_lengths, targets,
                              target_lengths, blank)
    else:
        raise ValueError(f"ctc_loss: log_probs on {log_probs.device}")
    if zero_infinity:
        loss = torch.where(loss >= -NEG_INF / 2, torch.zeros_like(loss), loss)
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        per = loss / torch.clamp(target_lengths.to(loss.device).float(),
                                 min=1.0)
        return per.mean()
    return loss


ctc_loss.launches = 0


def ctc_greedy_decode(log_probs: torch.Tensor) -> torch.Tensor:
    """Per-frame argmax ``(B, T)`` int32; blank removal and de-duplication
    happen host-side in :func:`greedy_collapse`."""
    return torch.argmax(log_probs, dim=-1).to(torch.int32)


def greedy_collapse(frames: Iterable[int], blank: int) -> List[int]:
    """Host-side unique_consecutive + blank removal for one utterance."""
    out = []
    prev = None
    for tok in frames:
        tok = int(tok)
        if tok != prev:
            if tok != blank:
                out.append(tok)
            prev = tok
    return out
