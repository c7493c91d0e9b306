"""RNN-T (transducer) loss (``audio8_tpu/ops/transducer.py``).

:func:`transducer_loss` has the JAX function's signature and semantics:
``log_probs`` (B, T, U+1, V) already log-softmaxed over V, padded
``targets`` (B, U), true frame and label counts, ``none``/``sum``/``mean``
reductions (mean over rows), all lattice math in float32 whatever the
input dtype, NEG_INF = -1e30 with the gradient-safe :func:`_logaddexp`,
emissions at and past a row's label count set to NEG_INF, and
zero_infinity: a row with no frames or no alignment gives 0 (and a zero
gradient, no NaN). Two backward routes, as in JAX:

- ``fused=False`` (the default): autograd through the forward recursion;
- ``fused=True``: the analytic alpha/beta occupancy VJP
  (:class:`_FusedNLL`), one more lattice sweep (beta) and elementwise
  exponentials; each live frame's blank occupancies sum to 1.

**The order of the sums.** JAX scans frames and solves each frame's
column with ``lax.associative_scan`` over the label axis. Here the
lattice runs as an anti-diagonal wavefront: every node on the diagonal
``t + u = d`` depends only on diagonal ``d - 1`` (its blank move from
``(t - 1, u)``, its emit move from ``(t, u - 1)``), so T + U vectorised
steps over (B, U+1) solve it, and beta runs the same wavefront
backwards. A loop over frames with an inner loop over u would take
T·U small steps; a per-frame closed form through ``logcumsumexp`` of
``b - cumsum(a)`` loses about 1e-3 in log space at U = 200 (the
cumulative sums reach -20·U, and NEG_INF entries overflow them). The
wavefront adds the same terms as JAX in another association, so the
per-row loss agrees to float32 rounding (the tests hold it at 1e-5
relative, U up to 200). Nodes with ``t`` outside ``[0, T)`` are kept at
NEG_INF; frames at or past a row's length are computed and never read,
as JAX leaves them out of the result.

No kernel: the JAX loss is XLA, not Pallas, so torch ops carry it on
the card too (each wavefront step is a handful of elementwise launches).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``log(exp(a) + exp(b))``, gradient-safe even when both sides are
    NEG_INF (the JAX ``_logaddexp``)."""
    mx = torch.maximum(a, b)
    mn = torch.minimum(a, b)
    return mx + torch.log1p(torch.exp(torch.clamp(mn - mx, min=NEG_INF)))


def _gather_emissions(log_probs: torch.Tensor, targets: torch.Tensor,
                      label_lengths: torch.Tensor, blank: int):
    """(blank_lp (B, T, U+1), emit_lp (B, T, U)) in float32;
    ``emit_lp[b, t, u] = log P(y_{u+1} | t, u)``, NEG_INF at and past the
    row's label count."""
    u1 = log_probs.shape[2]
    lp = log_probs.float()
    blank_lp = lp[..., blank]
    idx = targets.long()[:, None, :, None].expand(-1, lp.shape[1], -1, 1)
    emit_lp = torch.gather(lp[:, :, :u1 - 1, :], -1, idx)[..., 0]
    live = (torch.arange(u1 - 1, device=lp.device)[None, None, :]
            < label_lengths[:, None, None])
    return blank_lp, torch.where(live, emit_lp,
                                 torch.full_like(emit_lp, NEG_INF))


def _skew_index(t_max: int, width: int, device):
    """Flat gather index and validity of the diagonal layout: entry
    ``(d, u)`` of a (T + width, width) table is node ``(d - u, u)``."""
    d = torch.arange(t_max + width, device=device)[:, None]
    u = torch.arange(width, device=device)[None, :]
    t = d - u
    valid = (t >= 0) & (t < t_max)
    return (t.clamp(0, t_max - 1) * width + u), valid


def _skew(x: torch.Tensor) -> torch.Tensor:
    """(B, T, W) -> (B, T + W, W) with ``out[:, d, u] = x[:, d - u, u]``,
    NEG_INF where ``d - u`` is outside ``[0, T)``."""
    b, t_max, w = x.shape
    idx, valid = _skew_index(t_max, w, x.device)
    out = torch.gather(x.reshape(b, t_max * w), 1,
                       idx.reshape(1, -1).expand(b, -1))
    out = out.reshape(b, t_max + w, w)
    return torch.where(valid[None], out, torch.full_like(out, NEG_INF))


def _unskew(diag: torch.Tensor, t_max: int) -> torch.Tensor:
    """(B, >= T + W - 1, W) diagonals -> (B, T, W) nodes."""
    b, _, w = diag.shape
    t = torch.arange(t_max, device=diag.device)[:, None]
    u = torch.arange(w, device=diag.device)[None, :]
    idx = ((t + u) * w + u).reshape(1, -1).expand(b, -1)
    return torch.gather(diag.reshape(b, -1), 1, idx).reshape(b, t_max, w)


def _alpha_diagonals(blank_lp: torch.Tensor,
                     emit_lp: torch.Tensor) -> torch.Tensor:
    """The alpha lattice as diagonals: (B, T + U + 1, U + 1), entry
    ``(d, u)`` = alpha(d - u, u) (NEG_INF off the lattice).

    alpha(0, 0) = 0; alpha(t, u) = alpha(t - 1, u) + blank(t - 1, u)
    (+) alpha(t, u - 1) + emit(t, u - 1)."""
    bsz, t_max, u1 = blank_lp.shape
    blank_sk = _skew(blank_lp)                                # (B, D, U1)
    emit_sk = _skew(F.pad(emit_lp, (0, 1), value=NEG_INF))[..., :u1 - 1]
    _, valid = _skew_index(t_max, u1, blank_lp.device)
    neg_col = blank_lp.new_full((bsz, 1), NEG_INF)
    alpha = blank_lp.new_full((bsz, u1), NEG_INF)
    alpha[:, 0] = 0.0
    rows = [alpha]
    for d in range(1, t_max + u1):
        from_blank = alpha + blank_sk[:, d - 1]
        from_emit = torch.cat([neg_col, alpha[:, :-1] + emit_sk[:, d - 1]],
                              dim=1)
        alpha = torch.where(valid[d], _logaddexp(from_blank, from_emit),
                            neg_col)
        rows.append(alpha)
    return torch.stack(rows, dim=1)


def _row_nll(alpha_diag, blank_lp, frame_lengths, label_lengths):
    """(ll, loss) per row: ll = alpha(T_b - 1, U_b) + blank(T_b - 1, U_b);
    the loss is -ll, 0 for rows with no frames or no alignment."""
    rows = torch.arange(blank_lp.shape[0], device=blank_lp.device)
    last_t = torch.clamp(frame_lengths - 1, min=0)
    a_end = alpha_diag[rows, last_t + label_lengths, label_lengths]
    ll = a_end + blank_lp[rows, last_t, label_lengths]
    zero = torch.zeros_like(ll)
    loss = torch.where(ll > NEG_INF / 2, -ll, zero)
    return ll, torch.where(frame_lengths > 0, loss, zero)


def _beta_diagonals(blank_lp, emit_lp, frame_lengths, label_lengths):
    """The beta lattice as diagonals, (B, T + U + 1, U + 1), entry
    ``(d, u)`` = beta(d - u, u):

    beta(t, u) = blank(t, u) + beta(t + 1, u) (+) emit(t, u) +
    beta(t, u + 1), and beta(t, u) = [u == U_b ? 0 : NEG_INF] for every
    t >= T_b (the boundary row, which JAX's reverse scan keeps for frames
    past the row's length)."""
    bsz, t_max, u1 = blank_lp.shape
    dev = blank_lp.device
    blank_sk = _skew(blank_lp)
    emit_sk = _skew(F.pad(emit_lp, (0, 1), value=NEG_INF))
    u_idx = torch.arange(u1, device=dev)
    init = torch.where(u_idx[None, :] == label_lengths[:, None],
                       blank_lp.new_zeros(()), blank_lp.new_full((),
                                                                 NEG_INF))
    beta = init
    rows = [beta]
    neg_col = blank_lp.new_full((bsz, 1), NEG_INF)
    for d in range(t_max + u1 - 1, -1, -1):
        from_blank = blank_sk[:, d] + beta
        from_emit = emit_sk[:, d] + torch.cat([beta[:, 1:], neg_col], dim=1)
        past = (d - u_idx)[None, :] >= frame_lengths[:, None]
        beta = torch.where(past, init, _logaddexp(from_blank, from_emit))
        rows.append(beta)
    return torch.stack(rows[::-1], dim=1)


class _FusedNLL(torch.autograd.Function):
    """Per-row NLL (B,) with the analytic occupancy backward:

      d ll / d blank(t, u) = exp(alpha(t,u) + blank(t,u) + beta(t+1,u) - ll)
      d ll / d emit(t, u)  = exp(alpha(t,u) + emit(t,u) + beta(t,u+1) - ll)

    first-order only, as JAX's ``custom_vjp``."""

    @staticmethod
    def forward(ctx, log_probs, frame_lengths, targets, label_lengths,
                blank):
        blank_lp, emit_lp = _gather_emissions(log_probs, targets,
                                              label_lengths, blank)
        alpha_diag = _alpha_diagonals(blank_lp, emit_lp)
        ll, loss = _row_nll(alpha_diag, blank_lp, frame_lengths,
                            label_lengths)
        ctx.save_for_backward(alpha_diag, ll, blank_lp, emit_lp,
                              frame_lengths, targets, label_lengths)
        ctx.blank, ctx.vocab, ctx.in_dtype = (blank, log_probs.shape[-1],
                                              log_probs.dtype)
        return loss

    @staticmethod
    def backward(ctx, cot):
        (alpha_diag, ll, blank_lp, emit_lp, frame_lengths, targets,
         label_lengths) = ctx.saved_tensors
        bsz, t_max, u1 = blank_lp.shape
        beta_diag = _beta_diagonals(blank_lp, emit_lp, frame_lengths,
                                    label_lengths)
        alphas = _unskew(alpha_diag, t_max)
        betas = _unskew(beta_diag, t_max)
        beta_nexts = _unskew(beta_diag[:, 1:], t_max)  # beta(t + 1, u)
        # live nodes of rows that survive zero_infinity: the mask gates
        # the where (not a product after it), since a degenerate row puts
        # NaN (-inf - -inf) into the exponent
        ok = ((ll > NEG_INF / 2) & (frame_lengths > 0))[:, None, None]
        live = (torch.arange(t_max, device=ll.device)[None, :]
                < frame_lengths[:, None])[..., None] & ok
        scale = -cot[:, None, None]
        norm = ll[:, None, None]
        zero = blank_lp.new_zeros(())
        occ_blank = torch.where(live, torch.exp(torch.clamp(
            alphas + blank_lp + beta_nexts - norm, max=0.0)), zero) * scale
        occ_emit = torch.where(live, torch.exp(torch.clamp(
            alphas[:, :, :-1] + emit_lp + betas[:, :, 1:] - norm, max=0.0)),
            zero) * scale
        g = blank_lp.new_zeros((bsz, t_max, u1, ctx.vocab))
        g[..., ctx.blank] = occ_blank
        idx = targets.long()[:, None, :, None].expand(-1, t_max, -1, 1)
        g[:, :, :-1].scatter_add_(-1, idx, occ_emit[..., None])
        return g.to(ctx.in_dtype), None, None, None, None


def transducer_loss(log_probs: torch.Tensor, frame_lengths: torch.Tensor,
                    targets: torch.Tensor, label_lengths: torch.Tensor,
                    blank: int = 0, reduction: str = "mean",
                    fused: bool = False) -> torch.Tensor:
    """Negative log-likelihood of each row's label sequence.

    log_probs: (B, T, U+1, V) log-softmaxed joint outputs; targets:
    (B, U) int padded; reduction: 'none' | 'sum' | 'mean' (mean over
    rows). ``fused=True`` takes the analytic occupancy backward (same
    loss values; gradients equal to float32 rounding); it supports
    first-order reverse mode only."""
    frame_lengths = frame_lengths.long()
    label_lengths = label_lengths.long()
    if fused:
        loss = _FusedNLL.apply(log_probs, frame_lengths, targets,
                               label_lengths, blank)
    else:
        blank_lp, emit_lp = _gather_emissions(log_probs, targets,
                                              label_lengths, blank)
        _, loss = _row_nll(_alpha_diagonals(blank_lp, emit_lp), blank_lp,
                           frame_lengths, label_lengths)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.mean()


def transducer_loss_from_logits(logits: torch.Tensor, frame_lengths,
                                targets, label_lengths, blank: int = 0,
                                reduction: str = "mean",
                                fused: bool = False) -> torch.Tensor:
    """Raw joint logits (B, T, U+1, V) -> loss (log-softmax in f32)."""
    return transducer_loss(torch.log_softmax(logits.float(), dim=-1),
                           frame_lengths, targets, label_lengths,
                           blank=blank, reduction=reduction, fused=fused)
