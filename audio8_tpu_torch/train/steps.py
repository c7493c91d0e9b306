"""The step factories of CTC fine-tuning, contrastive pretraining, HuBERT
and data2vec pretraining, seq2seq, paired pretraining and RNN-T
(``audio8_tpu/train/steps.py``: ``make_ctc_steps``,
``make_pretrain_steps``, ``make_hubert_steps``, ``make_data2vec_steps``,
``make_seq2seq_steps``, ``make_paired_steps``,
``make_transducer_steps``, ``make_lm_steps``).

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

HuBERT and data2vec: the pretraining step's shape (a clipped step at
norm 1.0 on a frame-averaged loss, explicit mask seeds). HuBERT's batches
are the supervised pipeline's with frame cluster ids; data2vec steps the
student, then moves the teacher by the EMA at the new step's decay
(``audio8_tpu/train/steps.py:276-282``).

Seq2seq: teacher forcing shifts the targets (``token_ids[:, :-1]`` in,
``token_ids[:, 1:]`` scored by :func:`sequence_loss`), the decoder
lengths clamp at 0 (padding rows), and the grad/update pair is CTC's;
``decode_fn`` decodes greedily or with a beam, ``eval_loss_fn`` scores
teacher-forced. Paired: one optimizer over the model and the loss
module's ``logit_scale`` (``models.dual_encoder.PairedModule``), each
tower frozen or not by its own flag. A frozen leaf still takes its zero
gradient through AdamW, weight decay included, as optax steps every
leaf. RNN-T: CTC's conventions (blank = GO, the ``sum`` loss scaled by
1/total_examples at update, ``freeze`` a plain flag, the fused
``train_step`` for ``--grad_accum 1``, padding rows weighted out) over
``ops.transducer.transducer_loss`` with either backward route;
``decode_fn`` decodes greedily or, with ``beam > 1``, returns the beam
search's 1-best. Text LM: the token-mean NLL of packed blocks, clipped,
then AdamW.

MoE: a model whose encoder has MoE layers adds ``moe_aux_weight *
aux`` (the layers' summed load-balance losses, collected by
``nn.moe.AuxLosses`` around the forward) to its objective, times
``max(real rows, 1)`` where the update scales the gradient by
1/total_examples (CTC, seq2seq, paired, RNN-T), so the per-example
weight survives. Pretraining, HuBERT, data2vec and paired report it as
``moe_aux``; data2vec collects it from the student alone, in its
evaluation too (the JAX steps).

Data parallelism: a factory given a process ``group`` runs each rank's
block of the global batch (``parallel/sharding.py``). Each step runs its
forward and backward under ``sharding.data_parallel`` with the batch's
``row_offset`` (a dict key, or the pretraining steps' argument), so the
hash draws are the global batch's and the denominators (rows, tokens,
slots, frames) are summed over the ranks. The factories that return the
summed loss and counts (CTC, seq2seq, paired, RNN-T) return this rank's
share; their ``update_fn`` (and the fused ``train_step``) sums the
gradients over the ranks with one all-reduce and the example count it is
given (this rank's) before it scales and clips, once per update under
gradient accumulation. The others all-reduce the gradients before their
clipped step, and their metrics are the global batch's. Without a group
nothing changes.

ZeRO-1 and FSDP (``parallel/zero.py``): the sums go through the state
(``TrainState.reduce_grads``), which reduce-scatters into its rank's
chunk when it is sharded; under FSDP the backward has done so already.
A step's forward and backward run in ``zero.gathered``, which keeps the
model's root gathered until the backward has passed it, a decode in
``gathered(whole=True)`` (its loops call layers' other methods), and
the paired evaluation in ``gathered`` (it calls the root's parts); an
evaluation's forward gathers by itself.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from audio8_tpu_torch.config import END_TEMP, START_TEMP, TEMP_DECAY_FACTOR
from audio8_tpu_torch.models.data2vec import (data2vec_loss,
                                              data2vec_targets,
                                              ema_decay_schedule, ema_update)
from audio8_tpu_torch.models.hubert import hubert_pretrain_loss
from audio8_tpu_torch.models.wav2vec2 import (moe_aux_weight,
                                              wav2vec2_pretrain_loss)
from audio8_tpu_torch.nn.moe import AuxLosses
from audio8_tpu_torch.ops.ctc import ctc_loss
from audio8_tpu_torch.ops.transducer import transducer_loss
from audio8_tpu_torch.parallel.sharding import data_parallel, global_sum
from audio8_tpu_torch.parallel.zero import (gathered, module_shards,
                                            sharded_tensors)
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


def collecting_aux(aux_w: float, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` and the MoE aux loss it recorded (the JAX
    ``apply_collecting_aux``): ``(out, aux)``, ``aux`` None when
    ``aux_w`` is 0 (nothing is collected)."""
    if aux_w <= 0.0:
        return fn(*args, **kwargs), None
    with AuxLosses() as aux:
        out = fn(*args, **kwargs)
    return out, aux.total()


def _per_example_aux(loss, aux_w: float, aux, rows):
    """``loss + aux_w * aux * max(rows, 1)`` (the factories whose update
    divides by the real-row count)."""
    if aux is None:
        return loss
    return loss + aux_w * aux * torch.clamp(global_sum(rows.sum()), min=1.0)


def _with_aux(loss, metrics, aux_w: float, aux):
    """``loss + aux_w * aux`` and ``moe_aux`` in the metrics."""
    if aux is None:
        return loss, metrics
    return loss + aux_w * aux, dict(metrics, moe_aux=aux)


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
    JAX returns for a frozen leaf); the ``.grad`` fields are cleared.
    Under FSDP: the rank's chunk gradients (``zero.ShardGrads``)."""
    shards = module_shards(module)
    if shards is not None:
        return shards.take_grads()
    grads = {}
    for n, p in module.named_parameters():
        grads[n] = torch.zeros_like(p) if p.grad is None else p.grad
        p.grad = None
    return grads


def _row_offset(batch) -> int:
    return int(batch.get("row_offset", 0))


def _reduce(state, grads, total_examples, group):
    """The gradients and the example count summed over ``group``'s ranks
    (unchanged without a group; the state's chunks when it is
    sharded)."""
    total = torch.as_tensor(total_examples, dtype=torch.float32)
    if group is None:
        return grads, total
    grads = state.reduce_grads(grads, group)
    dev = next(iter(grads.values()) if isinstance(grads, dict)
               else iter(grads)).device
    with data_parallel(group):
        return grads, global_sum(total.to(dev))


def _scaled_update(clip: float, group=None):
    def update_fn(state_, grads, total_examples):
        """Step with the summed gradient over ``total_examples`` rows
        (a number or a 0-dim tensor; this rank's rows under a process
        group, whose gradients and counts are summed first); returns
        ``(state, gnorm)``."""
        grads, total = _reduce(state_, grads, total_examples, group)
        gnorm = state_.apply_gradients(
            grads, grad_scale=1.0 / torch.clamp(total, min=1.0),
            clip_norm=clip)
        return state_, gnorm

    return update_fn


def make_ctc_steps(model, clip: float = 25.0, loss_reduction: str = "sum",
                   group=None):
    """Returns ``(grad_fn, update_fn, eval_fn)`` for CTC fine-tuning of
    ``model``; ``update_fn`` and ``grad_fn.train_step`` step a
    :class:`~audio8_tpu_torch.train.optim.TrainState` over the model's
    parameters, the latter fusing grad and update. Batches are dicts of
    tensors on the model's device (``signal``, ``signal_lengths``,
    ``token_ids``, ``token_lengths``; ``row_offset`` an int under a
    process ``group``). The loss, rows and tokens that ``grad_fn``
    returns, and ``eval_fn``'s loss, are this rank's shares: the global
    values are their sums over the ranks."""

    def masked_ctc(log_probs, frame_lengths, targets, target_lengths, rows):
        per_row = ctc_loss(log_probs, frame_lengths, targets, target_lengths,
                           blank=Offsets.GO, reduction="none")
        if loss_reduction == "sum":
            return torch.sum(per_row * rows)
        per = per_row / torch.clamp(target_lengths.float(), min=1.0)
        return torch.sum(per * rows) / torch.clamp(global_sum(rows.sum()),
                                                   min=1.0)

    aux_w = moe_aux_weight(model.config)

    def grad_fn(batch, generator: Optional[torch.Generator],
                freeze: bool = True):
        targets, target_lengths = clean_targets(batch["token_ids"],
                                                batch["token_lengths"])
        rows = row_validity(batch)
        for p in model.parameters():
            p.grad = None
        with gathered(model), data_parallel(group, _row_offset(batch)):
            (log_probs, pad_mask), aux = collecting_aux(
                aux_w, model, batch["signal"], batch["signal_lengths"],
                generator=generator, freeze=freeze)
            loss = masked_ctc(log_probs, pad_mask.sum(dim=-1), targets,
                              target_lengths, rows)
            loss = _per_example_aux(loss, aux_w, aux, rows)
            loss.backward()
        grads = _take_grads(model)
        num_tokens = (target_lengths * rows).sum().float()
        return loss.detach(), grads, rows.sum(), num_tokens

    update_fn = _scaled_update(clip, group)

    def train_step(state_, batch, generator, freeze: bool = True):
        loss, grads, bsz, toks = grad_fn(batch, generator, freeze)
        grads, total = _reduce(state_, grads, bsz, group)
        state_.apply_gradients(grads,
                               grad_scale=1.0 / torch.clamp(total, min=1.0),
                               clip_norm=clip)
        return state_, loss, bsz, toks

    @torch.no_grad()
    def eval_fn(batch):
        targets, target_lengths = clean_targets(batch["token_ids"],
                                                batch["token_lengths"])
        log_probs, pad_mask = model(batch["signal"], batch["signal_lengths"])
        frame_lengths = pad_mask.sum(dim=-1)
        with data_parallel(group, _row_offset(batch)):
            loss = masked_ctc(log_probs, frame_lengths, targets,
                              target_lengths, row_validity(batch))
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


def make_pretrain_steps(model, clip: float = 1.0, n_negatives: int = 100,
                        group=None):
    """Returns ``(train_step, eval_step)`` for contrastive pretraining of a
    ``Wav2Vec2Model``. ``train_step(state, signal, seeds, generator,
    row_offset=0)`` steps the
    :class:`~audio8_tpu_torch.train.optim.TrainState` and returns
    ``(state, metrics)`` (metrics as 0-dim tensors, plus
    ``temperature``); ``eval_step(signal, seeds, step, row_offset=0)``
    returns ``(loss, metrics)``. ``signal`` is a dense (B, T) batch on the
    model's device, rows ``row_offset ..`` of the global batch under a
    process ``group`` (the metrics are then the global batch's)."""
    cfg = model.config
    n_vars = cfg.num_vq_vars * cfg.num_vq_groups
    aux_w = moe_aux_weight(cfg)

    def temperature(step: int) -> float:
        return current_temperature(step, cfg.start_temp, cfg.end_temp,
                                   cfg.temp_decay_factor)

    def train_step(state, signal, seeds, generator, row_offset: int = 0):
        temp = temperature(state.step)
        for p in model.parameters():
            p.grad = None
        with gathered(model), data_parallel(group, row_offset):
            (c, t, ppl, valid), aux = collecting_aux(
                aux_w, model, signal, seeds, generator=generator,
                temperature=temp)
            loss, metrics = wav2vec2_pretrain_loss(c, t, ppl, valid,
                                                   seeds.negatives, n_vars,
                                                   n_negatives)
            loss, metrics = _with_aux(loss, metrics, aux_w, aux)
            loss.backward()
        grads = state.reduce_grads(_take_grads(model), group)
        gnorm = state.apply_gradients(grads, clip_norm=clip)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return state, dict(metrics, loss=loss.detach(), grad_norm=gnorm,
                           temperature=temp)

    @torch.no_grad()
    def eval_step(signal, seeds, step: int, row_offset: int = 0):
        with data_parallel(group, row_offset):
            c, t, ppl, valid = model(signal, seeds,
                                     temperature=temperature(step))
            return wav2vec2_pretrain_loss(c, t, ppl, valid, seeds.negatives,
                                          n_vars, n_negatives)

    return train_step, eval_step


def _step_grads(model, state, loss, clip: float, group=None):
    """Backward (unless ``loss`` is None: it ran already), every
    parameter's gradient (zeros where none arrived) summed over
    ``group``'s ranks, then one clipped optimizer step; returns the global
    norm."""
    if loss is not None:
        loss.backward()
    grads = state.reduce_grads(_take_grads(model), group)
    return state.apply_gradients(grads, clip_norm=clip)


def make_hubert_steps(model, clip: float = 1.0, group=None):
    """Returns ``(train_step, eval_step)`` for HuBERT masked-prediction
    pretraining of a ``models.hubert.HubertPretrainModel``.
    ``train_step(state, batch, seeds, generator)`` steps the
    :class:`~audio8_tpu_torch.train.optim.TrainState` (the loss is a frame
    average: no 1/B scaling) and returns ``(state, metrics)``;
    ``eval_step(batch, seeds)`` returns ``(loss, metrics)`` with the time
    mask still drawn. Batches are the supervised pipeline's dicts with
    ``token_ids`` the frame cluster ids (``TGT_KM``, padded -1); a padding
    row (``signal_lengths == 0``) has an empty pad mask and adds
    nothing. Under a process ``group`` a batch is a rank's row block
    (its ``row_offset``) and the metrics are the global batch's."""
    cfg = model.config
    aux_w = moe_aux_weight(cfg)

    def loss_of(batch, seeds, generator):
        logits, time_mask, pad_mask = model(
            batch["signal"], batch["signal_lengths"], seeds,
            generator=generator)
        return hubert_pretrain_loss(
            logits, time_mask, pad_mask, batch["token_ids"],
            batch["token_lengths"], cfg.pred_masked_weight,
            cfg.pred_unmasked_weight)

    def train_step(state, batch, seeds, generator):
        for p in model.parameters():
            p.grad = None
        with gathered(model), data_parallel(group, _row_offset(batch)):
            (loss, metrics), aux = collecting_aux(aux_w, loss_of, batch,
                                                  seeds, generator)
            loss, metrics = _with_aux(loss, metrics, aux_w, aux)
            loss.backward()
        gnorm = _step_grads(model, state, None, clip, group)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return state, dict(metrics, loss=loss.detach(), grad_norm=gnorm)

    @torch.no_grad()
    def eval_step(batch, seeds):
        with data_parallel(group, _row_offset(batch)):
            return loss_of(batch, seeds, None)

    return train_step, eval_step


def make_data2vec_steps(model, teacher, clip: float = 1.0, group=None):
    """Returns ``(train_step, eval_step)`` for data2vec masked regression
    of a ``models.data2vec.Data2VecAudioModel`` (the student) against
    ``teacher``, a module of the same config (at the start a copy of the
    student). ``train_step(state, batch, mask_seed, generator)`` runs the
    teacher under ``torch.no_grad()`` in evaluation mode (no dropout, no
    LayerDrop, no mask) for the targets, steps the student, then moves the
    teacher by the EMA with the decay at the new step; it returns
    ``(state, metrics)``. ``eval_step(batch, mask_seed)`` returns ``(loss,
    metrics)``. Under a process ``group`` as HuBERT's; every rank's
    teacher moves by the same EMA of the same student."""
    cfg = model.config
    aux_w = moe_aux_weight(cfg)

    def loss_of(batch, mask_seed, generator):
        signal, lengths = batch["signal"], batch.get("signal_lengths")
        with torch.no_grad():
            hiddens, _, _ = teacher(signal, lengths, collect_hiddens=True)
            target = data2vec_targets(hiddens, cfg.average_top_k_layers)
        (pred, time_mask, pad_mask), aux = collecting_aux(
            aux_w, model, signal, lengths, mask_seed, generator=generator)
        loss, metrics = data2vec_loss(pred, target, time_mask, pad_mask)
        return _with_aux(loss, metrics, aux_w, aux)

    def train_step(state, batch, mask_seed, generator):
        for p in model.parameters():
            p.grad = None
        with gathered(model), data_parallel(group, _row_offset(batch)):
            loss, metrics = loss_of(batch, mask_seed, generator)
            loss.backward()
        gnorm = _step_grads(model, state, None, clip, group)
        decay = ema_decay_schedule(state.step, cfg.ema_decay,
                                   cfg.ema_end_decay, cfg.ema_anneal_steps)
        # the EMA on whatever holds the weights: the parameters, or
        # under FSDP the rank's chunks (elementwise either way)
        ema_update(sharded_tensors(teacher), sharded_tensors(model), decay)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return state, dict(metrics, loss=loss.detach(), grad_norm=gnorm,
                           ema_decay=decay)

    @torch.no_grad()
    def eval_step(batch, mask_seed):
        with data_parallel(group, _row_offset(batch)):
            return loss_of(batch, mask_seed, None)

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
    return total / torch.clamp(global_sum(mask.sum()), min=1.0)


def _teacher_forcing(batch):
    """(decoder input, scored targets, decoder lengths)."""
    ids = batch["token_ids"]
    return (ids[:, :-1], ids[:, 1:],
            torch.clamp(batch["token_lengths"] - 1, min=0))


def make_seq2seq_steps(model, clip: float = 25.0,
                       loss_reduction: str = "sum", group=None):
    """Returns ``(grad_fn, update_fn, decode_fn, eval_loss_fn)`` for a
    ``models.seq2seq.Seq2Seq``: ``grad_fn(batch, generator, freeze)`` ->
    (summed loss, gradients by name, real rows, decoder tokens);
    ``decode_fn(batch, max_output_len, beam)`` -> (tokens, lengths);
    ``eval_loss_fn(batch)`` -> the teacher-forced loss. Under a process
    ``group``, CTC's conventions (this rank's shares; ``update_fn`` sums
    the gradients and rows)."""
    aux_w = moe_aux_weight(model.encoder_config)

    def grad_fn(batch, generator: Optional[torch.Generator],
                freeze: bool = True):
        rows = row_validity(batch)
        dst, tgt, dst_lengths = _teacher_forcing(batch)
        for p in model.parameters():
            p.grad = None
        with gathered(model), data_parallel(group, _row_offset(batch)):
            log_probs, aux = collecting_aux(
                aux_w, model, batch["signal"], batch["signal_lengths"], dst,
                dst_lengths, generator=generator, freeze=freeze)
            loss = sequence_loss(log_probs, tgt, loss_reduction)
            loss = _per_example_aux(loss, aux_w, aux, rows)
            loss.backward()
        num_tokens = (dst_lengths * rows).sum().float()
        return loss.detach(), _take_grads(model), rows.sum(), num_tokens

    def decode_fn(batch, max_output_len: int = 100, beam: int = 1):
        with gathered(model, whole=True):
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
        with data_parallel(group, _row_offset(batch)):
            return sequence_loss(log_probs, tgt, loss_reduction)

    return grad_fn, _scaled_update(clip, group), decode_fn, eval_loss_fn


def make_paired_steps(module, clip: float = 25.0, group=None):
    """Returns ``(grad_fn, update_fn, eval_fn)`` for paired pretraining of
    a ``models.dual_encoder.PairedModule`` (``module.model`` the dual
    encoder, ``module.loss`` the CLIP loss with its temperature):
    ``grad_fn(batch, generator, freeze_audio, freeze_text)`` -> (loss,
    metrics, gradients by name, real rows, text tokens); ``eval_fn(batch)``
    -> (loss, metrics). Under a process ``group`` the loss and metrics
    are the global batch's on every rank (the CLIP similarities over all
    ranks' rows), the rows and tokens this rank's; ``update_fn`` sums the
    gradients and rows."""
    aux_w = moe_aux_weight(module.model.audio_encoder.config)

    def grad_fn(batch, generator: Optional[torch.Generator],
                freeze_audio: bool = True, freeze_text: bool = True):
        rows = row_validity(batch)
        for p in module.parameters():
            p.grad = None
        with gathered(module), data_parallel(group, _row_offset(batch)):
            (a, t), aux = collecting_aux(
                aux_w, module.model, batch["signal"],
                batch["signal_lengths"], batch["token_ids"],
                batch["token_lengths"], generator=generator,
                freeze_audio=freeze_audio, freeze_text=freeze_text)
            loss, metrics = module.loss(a, t, rows)
            if aux is not None:
                loss = _per_example_aux(loss, aux_w, aux, rows)
                metrics = dict(metrics, moe_aux=aux)
            loss.backward()
        num_tokens = (batch["token_lengths"] * rows).sum().float()
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (loss.detach(), metrics, _take_grads(module), rows.sum(),
                num_tokens)

    @torch.no_grad()
    def eval_fn(batch):
        with gathered(module):
            a, t = module.model(batch["signal"], batch["signal_lengths"],
                                batch["token_ids"], batch["token_lengths"])
            with data_parallel(group, _row_offset(batch)):
                return module.loss(a, t, row_validity(batch))

    return grad_fn, _scaled_update(clip, group), eval_fn


def make_transducer_steps(model, clip: float = 25.0,
                          loss_reduction: str = "sum",
                          fused_loss: bool = False, group=None):
    """Returns ``(grad_fn, update_fn, decode_fn, eval_loss_fn)`` for a
    ``models.transducer.Transducer``: ``grad_fn(batch, generator,
    freeze)`` -> (loss, gradients by name, real rows, label tokens) and
    ``grad_fn.train_step`` fusing it with the update;
    ``decode_fn(batch, max_output_len, max_symbols, beam)`` -> (tokens,
    lengths); ``eval_loss_fn(batch)`` -> the loss. ``sum`` sums the
    rows' NLL, ``mean`` averages each row's NLL per label over the real
    rows. Under a process ``group``, CTC's conventions."""

    def masked_loss(log_probs, frame_lengths, targets, target_lengths,
                    rows):
        per_row = transducer_loss(log_probs, frame_lengths, targets,
                                  target_lengths, blank=Offsets.GO,
                                  reduction="none", fused=fused_loss)
        if loss_reduction == "sum":
            return torch.sum(per_row * rows)
        per = per_row / torch.clamp(target_lengths.float(), min=1.0)
        return torch.sum(per * rows) / torch.clamp(global_sum(rows.sum()),
                                                   min=1.0)

    aux_w = moe_aux_weight(model.config)

    def grad_fn(batch, generator: Optional[torch.Generator],
                freeze: bool = True):
        targets, target_lengths = clean_targets(batch["token_ids"],
                                                batch["token_lengths"])
        rows = row_validity(batch)
        for p in model.parameters():
            p.grad = None
        with gathered(model), data_parallel(group, _row_offset(batch)):
            (log_probs, pad_mask), aux = collecting_aux(
                aux_w, model, batch["signal"], batch["signal_lengths"],
                targets, generator=generator, freeze=freeze)
            loss = masked_loss(log_probs, pad_mask.sum(dim=-1), targets,
                               target_lengths, rows)
            loss = _per_example_aux(loss, aux_w, aux, rows)
            loss.backward()
        num_tokens = (target_lengths * rows).sum().float()
        return loss.detach(), _take_grads(model), rows.sum(), num_tokens

    def train_step(state_, batch, generator, freeze: bool = True):
        loss, grads, bsz, toks = grad_fn(batch, generator, freeze)
        grads, total = _reduce(state_, grads, bsz, group)
        state_.apply_gradients(grads,
                               grad_scale=1.0 / torch.clamp(total, min=1.0),
                               clip_norm=clip)
        return state_, loss, bsz, toks

    @torch.no_grad()
    def decode_fn(batch, max_output_len: int = 200, max_symbols: int = 4,
                  beam: int = 1):
        with gathered(model, whole=True):
            if beam > 1:
                toks, n, _ = model.decode_beam(
                    batch["signal"], batch["signal_lengths"], beam,
                    max_output_len, max_symbols)
                return toks[:, 0], n[:, 0]
            return model.decode(batch["signal"], batch["signal_lengths"],
                                max_output_len, max_symbols)

    @torch.no_grad()
    def eval_loss_fn(batch):
        targets, target_lengths = clean_targets(batch["token_ids"],
                                                batch["token_lengths"])
        log_probs, pad_mask = model(batch["signal"], batch["signal_lengths"],
                                    targets)
        with data_parallel(group, _row_offset(batch)):
            return masked_loss(log_probs, pad_mask.sum(dim=-1), targets,
                               target_lengths, row_validity(batch))

    grad_fn.train_step = train_step
    return grad_fn, _scaled_update(clip, group), decode_fn, eval_loss_fn


def make_lm_steps(model, clip: float = 1.0, group=None):
    """Returns ``(train_step, eval_fn)`` for causal text-LM training of a
    ``models.text.CausalTextLM`` (``cli/train_lm.py``). Batches are
    ``{"ids": (B, L + 1)}`` packed token blocks: position t predicts
    t + 1, and PAD targets (the tail of the last partial block) are
    masked out of the token-mean NLL. ``train_step(state, batch,
    generator)`` clips the gradient at ``clip`` and steps the
    :class:`~audio8_tpu_torch.train.optim.TrainState`, returning
    ``(state, {"loss", "tokens", "grad_norm"})``; ``eval_fn(batch)``
    returns ``(loss, tokens)`` without dropout. Under a process ``group``
    a batch is a rank's row block (``row_offset``) and the loss and tokens
    are the global batch's."""
    pad = Offsets.PAD

    def nll(ids, generator):
        lp = model(ids[:, :-1], generator=generator)
        tgt = ids[:, 1:].long()
        tok_lp = torch.gather(lp, 2, tgt[..., None])[..., 0]
        valid = (tgt != pad).float()
        n = torch.clamp(global_sum(valid.sum()), min=1.0)
        return -global_sum((tok_lp * valid).sum() / n), n

    def train_step(state, batch, generator):
        for p in model.parameters():
            p.grad = None
        with data_parallel(group, _row_offset(batch)):
            loss, ntok = nll(batch["ids"], generator)
            loss.backward()
        gnorm = _step_grads(model, state, None, clip, group)
        return state, {"loss": loss.detach(), "tokens": ntok,
                       "grad_norm": gnorm}

    @torch.no_grad()
    def eval_fn(batch):
        with data_parallel(group, _row_offset(batch)):
            return nll(batch["ids"], None)

    return train_step, eval_fn
