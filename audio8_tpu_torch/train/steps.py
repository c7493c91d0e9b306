"""The step factories of CTC fine-tuning, contrastive pretraining,
seq2seq and paired pretraining (``audio8_tpu/train/steps.py``:
``make_ctc_steps``, ``make_pretrain_steps``, ``make_seq2seq_steps``,
``make_paired_steps``).

CTC: ``grad_fn`` runs one forward and backward and returns the summed loss,
one gradient per parameter (zeros for parameters that got none, as JAX
returns for frozen ones), the real-row count and the token count;
``update_fn`` scales the (accumulated) gradient by 1/total_examples, clips
it by global norm and steps; ``grad_fn.train_step`` fuses the two for
``--grad_accum 1``; ``eval_fn`` returns the loss and greedy frames.
Randomness comes from the trainer's ``torch.Generator``.

Pretraining: ``train_step`` runs the model and the InfoNCE + diversity
loss at the annealed Gumbel temperature, clips the gradient at global
norm 1.0 and steps (no 1/B scaling: the loss is a slot average);
``eval_step`` returns the loss and metrics with the time mask still drawn
and the quantizer's argmax. Both take the step's seeds
(``models.wav2vec2.PretrainSeeds``) as an argument, as the JAX steps
take their rng.

Seq2seq: teacher forcing shifts the targets (``token_ids[:, :-1]`` in,
``token_ids[:, 1:]`` scored by :func:`sequence_loss`), the decoder
lengths clamp at 0 (padding rows), and the grad/update pair is CTC's;
``decode_fn`` decodes greedily or with a beam, ``eval_loss_fn`` scores
teacher-forced. Paired: one optimizer over the model and the loss
module's ``logit_scale`` (``models.dual_encoder.PairedModule``), each
tower frozen or not by its own flag. A frozen leaf still takes its zero
gradient through AdamW, weight decay included, as optax steps every
leaf.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from audio8_tpu_torch.config import END_TEMP, START_TEMP, TEMP_DECAY_FACTOR
from audio8_tpu_torch.models.wav2vec2 import wav2vec2_pretrain_loss
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


def _take_grads(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter's gradient by name (zeros where none arrived, as
    JAX returns for a frozen leaf); the ``.grad`` fields are cleared."""
    grads = {}
    for n, p in module.named_parameters():
        grads[n] = torch.zeros_like(p) if p.grad is None else p.grad
        p.grad = None
    return grads


def _scaled_update(clip: float):
    def update_fn(state_, grads, total_examples):
        """Step with the summed gradient over ``total_examples`` rows
        (a number or a 0-dim tensor); returns ``(state, gnorm)``."""
        total = torch.as_tensor(total_examples, dtype=torch.float32)
        gnorm = state_.apply_gradients(
            grads, grad_scale=1.0 / torch.clamp(total, min=1.0),
            clip_norm=clip)
        return state_, gnorm

    return update_fn


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
        grads = _take_grads(model)
        num_tokens = (target_lengths * rows).sum().float()
        return loss.detach(), grads, rows.sum(), num_tokens

    update_fn = _scaled_update(clip)

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


def current_temperature(step: int, start: float = START_TEMP,
                        end: float = END_TEMP,
                        decay: float = TEMP_DECAY_FACTOR) -> float:
    """Gumbel temperature ``max(start * decay ** step, end)`` in float32,
    evaluated at the step count before the update."""
    t = np.float32(start) * np.float32(decay) ** np.float32(step)
    return float(max(t, np.float32(end)))


def make_pretrain_steps(model, clip: float = 1.0, n_negatives: int = 100):
    """Returns ``(train_step, eval_step)`` for contrastive pretraining of a
    ``Wav2Vec2Model``. ``train_step(state, signal, seeds, generator)``
    steps the :class:`~audio8_tpu_torch.train.optim.TrainState` and
    returns ``(state, metrics)`` (metrics as 0-dim tensors, plus
    ``temperature``); ``eval_step(signal, seeds, step)`` returns ``(loss,
    metrics)``. ``signal`` is a dense (B, T) batch on the model's
    device."""
    cfg = model.config
    n_vars = cfg.num_vq_vars * cfg.num_vq_groups

    def temperature(step: int) -> float:
        return current_temperature(step, cfg.start_temp, cfg.end_temp,
                                   cfg.temp_decay_factor)

    def train_step(state, signal, seeds, generator):
        temp = temperature(state.step)
        for p in model.parameters():
            p.grad = None
        c, t, ppl, valid = model(signal, seeds, generator=generator,
                                 temperature=temp)
        loss, metrics = wav2vec2_pretrain_loss(c, t, ppl, valid,
                                               seeds.negatives, n_vars,
                                               n_negatives)
        loss.backward()
        grads = []
        for p in model.parameters():
            grads.append(torch.zeros_like(p) if p.grad is None else p.grad)
            p.grad = None
        gnorm = state.apply_gradients(grads, clip_norm=clip)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return state, dict(metrics, loss=loss.detach(), grad_norm=gnorm,
                           temperature=temp)

    @torch.no_grad()
    def eval_step(signal, seeds, step: int):
        c, t, ppl, valid = model(signal, seeds,
                                 temperature=temperature(step))
        return wav2vec2_pretrain_loss(c, t, ppl, valid, seeds.negatives,
                                      n_vars, n_negatives)

    return train_step, eval_step


def sequence_loss(log_probs: torch.Tensor, targets: torch.Tensor,
                  reduction: str = "sum") -> torch.Tensor:
    """NLL over the non-PAD target positions, summed (``sum``) or per
    token (``token``)."""
    nll = -torch.gather(log_probs, -1, targets[..., None].long())[..., 0]
    mask = (targets != Offsets.PAD).float()
    total = (nll * mask).sum()
    if reduction == "sum":
        return total
    return total / torch.clamp(mask.sum(), min=1.0)


def _teacher_forcing(batch):
    """(decoder input, scored targets, decoder lengths)."""
    ids = batch["token_ids"]
    return (ids[:, :-1], ids[:, 1:],
            torch.clamp(batch["token_lengths"] - 1, min=0))


def make_seq2seq_steps(model, clip: float = 25.0,
                       loss_reduction: str = "sum"):
    """Returns ``(grad_fn, update_fn, decode_fn, eval_loss_fn)`` for a
    ``models.seq2seq.Seq2Seq``: ``grad_fn(batch, generator, freeze)`` ->
    (summed loss, gradients by name, real rows, decoder tokens);
    ``decode_fn(batch, max_output_len, beam)`` -> (tokens, lengths);
    ``eval_loss_fn(batch)`` -> the teacher-forced loss."""

    def grad_fn(batch, generator: Optional[torch.Generator],
                freeze: bool = True):
        rows = row_validity(batch)
        dst, tgt, dst_lengths = _teacher_forcing(batch)
        for p in model.parameters():
            p.grad = None
        log_probs = model(batch["signal"], batch["signal_lengths"], dst,
                          dst_lengths, generator=generator, freeze=freeze)
        loss = sequence_loss(log_probs, tgt, loss_reduction)
        loss.backward()
        num_tokens = (dst_lengths * rows).sum().float()
        return loss.detach(), _take_grads(model), rows.sum(), num_tokens

    def decode_fn(batch, max_output_len: int = 100, beam: int = 1):
        if beam > 1:
            return model.decode_beam(batch["signal"],
                                     batch["signal_lengths"], beam,
                                     max_output_len)
        return model.decode(batch["signal"], batch["signal_lengths"],
                            max_output_len)

    @torch.no_grad()
    def eval_loss_fn(batch):
        dst, tgt, dst_lengths = _teacher_forcing(batch)
        log_probs = model(batch["signal"], batch["signal_lengths"], dst,
                          dst_lengths)
        return sequence_loss(log_probs, tgt, loss_reduction)

    return grad_fn, _scaled_update(clip), decode_fn, eval_loss_fn


def make_paired_steps(module, clip: float = 25.0):
    """Returns ``(grad_fn, update_fn, eval_fn)`` for paired pretraining of
    a ``models.dual_encoder.PairedModule`` (``module.model`` the dual
    encoder, ``module.loss`` the CLIP loss with its temperature):
    ``grad_fn(batch, generator, freeze_audio, freeze_text)`` -> (loss,
    metrics, gradients by name, real rows, text tokens); ``eval_fn(batch)``
    -> (loss, metrics)."""

    def grad_fn(batch, generator: Optional[torch.Generator],
                freeze_audio: bool = True, freeze_text: bool = True):
        rows = row_validity(batch)
        for p in module.parameters():
            p.grad = None
        a, t = module.model(batch["signal"], batch["signal_lengths"],
                            batch["token_ids"], batch["token_lengths"],
                            generator=generator, freeze_audio=freeze_audio,
                            freeze_text=freeze_text)
        loss, metrics = module.loss(a, t, rows)
        loss.backward()
        num_tokens = (batch["token_lengths"] * rows).sum().float()
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (loss.detach(), metrics, _take_grads(module), rows.sum(),
                num_tokens)

    @torch.no_grad()
    def eval_fn(batch):
        a, t = module.model(batch["signal"], batch["signal_lengths"],
                            batch["token_ids"], batch["token_lengths"])
        return module.loss(a, t, row_validity(batch))

    return grad_fn, _scaled_update(clip), eval_fn
