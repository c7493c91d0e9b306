"""The CTC fine-tuning step factory (``audio8_tpu/train/steps.py:
make_ctc_steps``).

``grad_fn`` runs one forward and backward and returns the summed loss,
one gradient per parameter (zeros for parameters that got none, as JAX
returns for frozen ones), the real-row count and the token count;
``update_fn`` scales the (accumulated) gradient by 1/total_examples, clips
it by global norm and steps; ``grad_fn.train_step`` fuses the two for
``--grad_accum 1``; ``eval_fn`` returns the loss and greedy frames.
Randomness comes from the trainer's ``torch.Generator``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from audio8_tpu_torch.ops.ctc import ctc_loss
from audio8_tpu_torch.utils import Offsets


def clean_targets(targets: torch.Tensor, token_lengths: torch.Tensor):
    """Drop PAD/EOS from CTC targets: they only occur as a suffix, so the
    lengths are recounted and the targets kept."""
    keep = (targets != Offsets.PAD) & (targets != Offsets.EOS)
    return targets, keep.sum(dim=-1)


def row_validity(batch) -> torch.Tensor:
    """1.0 for real rows, 0.0 for the padding rows of batch-size snapping
    (``signal_lengths == 0``)."""
    return (batch["signal_lengths"] > 0).float()


def accumulate_grads(acc: Optional[Dict[str, torch.Tensor]],
                     grads: Dict[str, torch.Tensor]):
    """Sum gradients over micro-steps (in place into ``acc``)."""
    if acc is None:
        return grads
    for k, g in grads.items():
        acc[k].add_(g)
    return acc


def make_ctc_steps(model, clip: float = 25.0, loss_reduction: str = "sum"):
    """Returns ``(grad_fn, update_fn, eval_fn)`` for CTC fine-tuning of
    ``model``; ``update_fn`` and ``grad_fn.train_step`` step a
    :class:`~audio8_tpu_torch.train.optim.TrainState` over the model's
    parameters, the latter fusing grad and update. Batches are dicts of tensors on the
    model's device (``signal``, ``signal_lengths``, ``token_ids``,
    ``token_lengths``)."""

    def masked_ctc(log_probs, frame_lengths, targets, target_lengths, rows):
        per_row = ctc_loss(log_probs, frame_lengths, targets, target_lengths,
                           blank=Offsets.GO, reduction="none")
        if loss_reduction == "sum":
            return torch.sum(per_row * rows)
        per = per_row / torch.clamp(target_lengths.float(), min=1.0)
        return torch.sum(per * rows) / torch.clamp(rows.sum(), min=1.0)

    def grad_fn(batch, generator: Optional[torch.Generator],
                freeze: bool = True):
        targets, target_lengths = clean_targets(batch["token_ids"],
                                                batch["token_lengths"])
        rows = row_validity(batch)
        for p in model.parameters():
            p.grad = None
        log_probs, pad_mask = model(batch["signal"], batch["signal_lengths"],
                                    generator=generator, freeze=freeze)
        loss = masked_ctc(log_probs, pad_mask.sum(dim=-1), targets,
                          target_lengths, rows)
        loss.backward()
        grads = {}
        for n, p in model.named_parameters():
            grads[n] = torch.zeros_like(p) if p.grad is None else p.grad
            p.grad = None
        num_tokens = (target_lengths * rows).sum().float()
        return loss.detach(), grads, rows.sum(), num_tokens

    def update_fn(state_, grads, total_examples):
        """Step with the summed gradient over ``total_examples`` rows
        (a number or a 0-dim tensor); returns ``(state, gnorm)``."""
        total = torch.as_tensor(total_examples, dtype=torch.float32)
        gnorm = state_.apply_gradients(
            grads, grad_scale=1.0 / torch.clamp(total, min=1.0),
            clip_norm=clip)
        return state_, gnorm

    def train_step(state_, batch, generator, freeze: bool = True):
        loss, grads, bsz, toks = grad_fn(batch, generator, freeze)
        state_.apply_gradients(grads,
                               grad_scale=1.0 / torch.clamp(bsz, min=1.0),
                               clip_norm=clip)
        return state_, loss, bsz, toks

    @torch.no_grad()
    def eval_fn(batch):
        targets, target_lengths = clean_targets(batch["token_ids"],
                                                batch["token_lengths"])
        log_probs, pad_mask = model(batch["signal"], batch["signal_lengths"])
        frame_lengths = pad_mask.sum(dim=-1)
        loss = masked_ctc(log_probs, frame_lengths, targets, target_lengths,
                          row_validity(batch))
        frames = torch.argmax(log_probs, dim=-1).to(torch.int32)
        return loss, frames, frame_lengths

    grad_fn.train_step = train_step
    return grad_fn, update_fn, eval_fn
