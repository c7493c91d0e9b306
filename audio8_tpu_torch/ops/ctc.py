"""CTC loss and greedy decoding (``audio8_tpu/ops/ctc.py``).

:func:`ctc_loss` has the JAX function's signature and semantics: log-probs
``(B, T, V)`` already log-softmaxed, padded targets ``(B, U)``, true frame
and label counts, ``sum``/``mean``/``none`` reductions and
``zero_infinity``, all in float32. Its forward and backward are the
custom ops ``a8t::ctc_loss`` and ``a8t::ctc_loss_bwd``: on CUDA tensors
the hand-written kernel ``csrc/ctc_loss.cu`` (the port of the Pallas
``ctc_loss_pallas``, the JAX package's default on its accelerator: the
forward launch runs the alpha and beta sweeps at the same time, the
backward launch forms dE and scatters it); on CPU tensors
:func:`ctc_loss_plain`, the log-semiring scan of ``ctc_forward_alphas``,
and :func:`ctc_loss_grad_plain`, the same closed-form gradient as the
kernel's (alpha, beta_hat, dE, the sum onto the labels).

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


def _tables(log_probs, targets, target_lengths, blank):
    """The scan's per-state tables: the extended labels, the legal skips
    into each state, the live and the final states, and the emissions
    (B, T, S) with the killed states at NEG_INF."""
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
    final = (lane == 2 * tl) | ((lane == 2 * tl - 1) & (tl > 0))
    emits = torch.gather(log_probs.float(), 2,
                         ext[:, None, :].expand(bsz, t_max, s_n))
    emits = torch.where(live[:, None, :], emits, NEG_INF)
    return ext, allow_skip, lane, live, final, emits


def _alpha_scan(log_probs, input_lengths, targets, target_lengths, blank,
                keep: bool = False):
    """``(ll (B, 1), alphas)``: the forward scan; ``alphas`` the (B, S)
    state after each frame with ``keep``, else None."""
    bsz, t_max, _ = log_probs.shape
    ext, allow_skip, lane, _, final, emits = _tables(
        log_probs, targets, target_lengths, blank)
    s_n = ext.shape[1]
    dev = log_probs.device
    neg = torch.full((bsz, s_n), NEG_INF, device=dev)
    ilen = input_lengths.long().to(dev)[:, None]
    col = torch.full((bsz, 1), NEG_INF, device=dev)
    alpha = neg
    alphas = [] if keep else None
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
        if keep:
            alphas.append(alpha)
    fin = torch.where(final, alpha, neg)
    m = fin.max(dim=1, keepdim=True).values
    ok = m > NEG_INF / 2
    m_safe = torch.where(ok, m, torch.zeros_like(m))
    terms = torch.where(fin > NEG_INF / 2, torch.exp(fin - m_safe),
                        torch.zeros_like(fin))
    ll = m_safe + torch.log(torch.clamp(terms.sum(dim=1, keepdim=True),
                                        min=1e-37))
    return torch.where(ok, ll, torch.full_like(ll, NEG_INF)), alphas


def ctc_loss_plain(log_probs: torch.Tensor, input_lengths: torch.Tensor,
                   targets: torch.Tensor, target_lengths: torch.Tensor,
                   blank: int = 0) -> torch.Tensor:
    """Per-row -log p(y | x) ``(B,)`` by the alpha scan over time
    (``ctc_forward_alphas`` with the TPU kernel's conventions); infeasible
    rows give about 1e30. Differentiable by autograd."""
    ll, _ = _alpha_scan(log_probs, input_lengths, targets, target_lengths,
                        blank)
    return -ll[:, 0]


def ctc_loss_grad_plain(log_probs: torch.Tensor, input_lengths: torch.Tensor,
                        targets: torch.Tensor, target_lengths: torch.Tensor,
                        g: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """Plain version of the gradient launch: ``d(sum_b g_b loss_b) /
    d log_probs`` (B, T, V) f32 in the kernel's closed form, in natural
    log units. beta_hat runs backwards from the emissions at the final
    states for t = input_length - 1; dE(t, s) = -exp(min(alpha +
    beta_hat - E - ll, 0)) at frames before input_length of rows with a
    finite ll, else 0; each label sums its states' dE."""
    bsz, t_max, v = log_probs.shape
    ll, alphas = _alpha_scan(log_probs, input_lengths, targets,
                             target_lengths, blank, keep=True)
    ext, allow_skip, _, live, final, emits = _tables(
        log_probs, targets, target_lengths, blank)
    dev = log_probs.device
    neg = torch.full(ext.shape, NEG_INF, device=dev)
    col = torch.full((bsz, 1), NEG_INF, device=dev)
    skip_from = torch.cat([allow_skip[:, 2:], torch.zeros_like(
        allow_skip[:, :2])], dim=1)  # s + 2 may be reached by a skip
    ilen = input_lengths.long().to(dev)[:, None]
    beta = neg
    betas = [None] * t_max
    for t in range(t_max - 1, -1, -1):
        e = emits[:, t]
        b1 = torch.cat([beta[:, 1:], col], dim=1)
        b2 = torch.where(skip_from, torch.cat([beta[:, 2:], col, col], 1),
                         neg)
        rec = _logaddexp3(beta, b1, b2) + e
        beta = torch.where(t == ilen - 1, torch.where(final, e, neg),
                           torch.where(t < ilen - 1, rec, neg))
        betas[t] = beta
    gamma = torch.stack(alphas, 1) + torch.stack(betas, 1) - emits \
        - ll[:, :, None]
    frames = torch.arange(t_max, device=dev)[None, :, None]
    keep = (frames < ilen[:, :, None]) & live[:, None, :] \
        & (ll[:, :, None] > NEG_INF / 2)
    de = torch.where(keep, -torch.exp(torch.clamp(gamma, max=0.0)),
                     torch.zeros_like(gamma))
    grad = torch.zeros((bsz, t_max, v), dtype=torch.float32, device=dev)
    grad.scatter_add_(2, ext[:, None, :].expand_as(de), de)
    return grad * g.float().to(dev)[:, None, None]


def _int32(x: torch.Tensor, device) -> torch.Tensor:
    return x.to(device=device, dtype=torch.int32).contiguous()


def _launch(log_probs, input_lengths, targets, target_lengths, blank,
            with_grad):
    """The sweep launch on CUDA tensors: ``(loss, work)``. The forward
    runs the alpha and (with a gradient) the beta sweep at the same time
    and parks both in the workspace ``work``, which the gradient launch
    turns into dE and sums onto the vocabulary (empty without one)."""
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
    # alpha and beta_hat (B, T, 2U+1) each, then ll in log2 units; zeroed,
    # so that the op's output is a function of its inputs (the kernel
    # parks only the live states of the frames it steps through)
    work = torch.zeros((_work_size(b, t, u) if with_grad else 0,),
                       dtype=torch.float32, device=dev)
    fn = _ext.function(SOURCE)
    _ext.check(fn(lp.data_ptr(), il.data_ptr(), tg.data_ptr(),
                  tl.data_ptr(), ll.data_ptr(),
                  work.data_ptr() if with_grad else None, b, t, v, u,
                  int(blank), _ext.stream_handle(dev)), "ctc_loss")
    ctc_loss.launches += 1
    return -ll, work


def _launch_bwd(log_probs, input_lengths, targets, target_lengths, work, g,
                blank):
    """The gradient launch on CUDA tensors: ``grad`` (B, T, V) f32."""
    lp = log_probs.float().contiguous()
    b, t, v = lp.shape
    u = targets.shape[1]
    dev = lp.device
    if work.numel() != _work_size(b, t, u):
        raise ValueError("ctc_loss backward: the forward kept no workspace")
    il, tg, tl = (_int32(x, dev) for x in (input_lengths, targets,
                                           target_lengths))
    g = g.float().contiguous()
    grad = torch.empty((b, t, v), dtype=torch.float32, device=dev)
    fn = _ext.function(SOURCE, "bwd")
    _ext.check(fn(lp.data_ptr(), il.data_ptr(), tg.data_ptr(),
                  tl.data_ptr(), work.data_ptr(), g.data_ptr(),
                  grad.data_ptr(), b, t, v, u, int(blank),
                  _ext.stream_handle(dev)), "ctc_loss backward")
    return grad


def _work_size(b: int, t: int, u: int) -> int:
    return 2 * b * t * (2 * u + 1) + b


# The two launches as custom ops. The forward's residual is the sweeps'
# workspace on the card; on the CPU it is empty and the plain backward
# differentiates the scan again (each fake gives its device's shapes).

@torch.library.custom_op("a8t::ctc_loss", mutates_args=(),
                         device_types="cpu")
def ctc_loss_op(log_probs: torch.Tensor, input_lengths: torch.Tensor,
                targets: torch.Tensor, target_lengths: torch.Tensor,
                blank: int, with_grad: bool
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(per-row loss (B,) f32, workspace)``."""
    return (ctc_loss_plain(log_probs, input_lengths, targets,
                           target_lengths, blank),
            log_probs.new_empty((0,), dtype=torch.float32))


@torch.library.custom_op("a8t::ctc_loss_bwd", mutates_args=(),
                         device_types="cpu")
def ctc_loss_bwd_op(log_probs: torch.Tensor, input_lengths: torch.Tensor,
                    targets: torch.Tensor, target_lengths: torch.Tensor,
                    work: torch.Tensor, g: torch.Tensor,
                    blank: int) -> torch.Tensor:
    """The gradient of ``sum(g * loss)`` in ``log_probs``, (B, T, V) f32
    (:func:`ctc_loss_grad_plain`)."""
    return ctc_loss_grad_plain(log_probs, input_lengths, targets,
                               target_lengths, g, blank)


ctc_loss_op.register_kernel("cuda")(_launch)
ctc_loss_bwd_op.register_kernel("cuda")(_launch_bwd)


@ctc_loss_op.register_fake
def _(log_probs, input_lengths, targets, target_lengths, blank, with_grad):
    b, t, _ = log_probs.shape
    n = _work_size(b, t, targets.shape[1]) \
        if with_grad and log_probs.is_cuda else 0
    f32 = dict(dtype=torch.float32)
    return log_probs.new_empty((b,), **f32), log_probs.new_empty((n,), **f32)


@ctc_loss_bwd_op.register_fake
def _(log_probs, input_lengths, targets, target_lengths, work, g, blank):
    return log_probs.new_empty(log_probs.shape, dtype=torch.float32)


def _setup(ctx, inputs, output):
    log_probs, input_lengths, targets, target_lengths, blank, _ = inputs
    ctx.save_for_backward(log_probs, input_lengths, targets, target_lengths,
                          output[1])
    ctx.blank = blank


def _backward(ctx, g, _):
    lp, il, tg, tl, work = ctx.saved_tensors
    grad = ctc_loss_bwd_op(lp, il, tg, tl, work, g, ctx.blank)
    return grad.to(lp.dtype), None, None, None, None, None


ctc_loss_op.register_autograd(_backward, setup_context=_setup)


def ctc_loss(log_probs: torch.Tensor, input_lengths: torch.Tensor,
             targets: torch.Tensor, target_lengths: torch.Tensor,
             blank: int = 0, reduction: str = "sum",
             zero_infinity: bool = True) -> torch.Tensor:
    """Negative log-likelihood of the target labelling under CTC, with
    the semantics of the JAX ``ctc_loss`` (torch's ``F.ctc_loss``
    reductions: ``mean`` divides each row by its target length, then
    averages): the op ``a8t::ctc_loss`` and, for the gradient,
    ``a8t::ctc_loss_bwd``. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if reduction not in ("sum", "mean", "none"):
        raise ValueError(f"ctc_loss: reduction {reduction!r}")
    if log_probs.dim() != 3 or targets.dim() != 2 \
            or targets.shape[0] != log_probs.shape[0]:
        raise ValueError(f"ctc_loss: log_probs {tuple(log_probs.shape)}, "
                         f"targets {tuple(targets.shape)}")
    with_grad = torch.is_grad_enabled() and log_probs.requires_grad
    loss = ctc_loss_op(log_probs, input_lengths, targets, target_lengths,
                       blank, with_grad)[0]
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
