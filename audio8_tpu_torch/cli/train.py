"""CTC fine-tuning entry point of the port (``a8t-train`` on PyTorch).

Counterpart of ``audio8_tpu/cli/train.py``: letter/BPE-target CTC
training of a wav2vec2 acoustic model with gradient accumulation, the
summed gradient scaled by the global example count, global-norm clipping,
warmup + decay LR, the encoder frozen up to ``--unfreeze_enc_after_step``,
periodic validation with WER/CER and best-metric checkpoints. It runs on
``--device`` (the CUDA card by default; it raises without one), through
the attention, CTC, dropout and AdamW kernels, and with ``--freeze_fx
false`` the conv backward kernels.

  python -m audio8_tpu_torch.cli.train --root_dir corpus \\
      --train_dataset train.tsv --valid_dataset valid.tsv --basedir run

Checkpoints are fairseq-layout CTC files (``checkpoint-step-N.pt``,
``checkpoint-best.pt``) that ``cli.transcribe`` and ``cli.test`` read,
each with a resume file beside it (``train/checkpoint.py``).
``--restart_from`` warm-starts from a fairseq ``.pt`` or an HF
``save_pretrained`` directory (a pretrained one into the encoder) or
resumes a run from its directory
(``cli/common.py:resolve_restart``); on SIGTERM the trainer saves at the
next step boundary and exits 0 (``train/preempt.py``). ``--verbose``
prints a beam-decoded (``--beam``, ``--lm``) validation sample.
``--speed_perturb`` and ``--noise_manifest`` augment the training
utterances (``data/audio.py``), ``--remat`` recomputes each encoder
layer in the backward on its replayed dropout seeds, ``--optim sgd``
steps plain SGD, and ``--profile_dir`` writes a Chrome trace of the
five steps after the tenth (``train/profiler.py``). The flags are the JAX trainer's; those
of parts not ported yet raise: parallelism and ``--distributed``.
``--layer_drop`` and every topology flag or preset but MoE train.
``--lane_align`` (TPU tiling) is not a flag here.
"""
from __future__ import annotations

import logging
import os
import time
from argparse import ArgumentParser

import numpy as np
import torch

from audio8_tpu_torch.cli.common import (add_augmentation_args,
                                        add_beam_args,
                                        add_common_model_args,
                                        apply_preset, check_ported,
                                        encoder_kwargs, resolve_device,
                                        resolve_restart, train_augmentation)
from audio8_tpu_torch.config import AcousticConfig
from audio8_tpu_torch.data.datasets import (AudioTextLetterDataset,
                                            PrefetchLoader)
from audio8_tpu_torch.models.text import TextVectorizer, read_vocab_list
from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
from audio8_tpu_torch.ops import metrics as M
from audio8_tpu_torch.ops.beam import PrefixBeamSearch
from audio8_tpu_torch.train.checkpoint import save_checkpoint
from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                          create_optimizer)
from audio8_tpu_torch.train.preempt import PreemptionGuard
from audio8_tpu_torch.train.profiler import StepProfiler
from audio8_tpu_torch.train.steps import accumulate_grads, make_ctc_steps
from audio8_tpu_torch.utils import Average, Offsets, revlut, str2bool

logger = logging.getLogger("audio8_tpu_torch.train")

def parse_args(argv=None):
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--basedir", type=str)
    parser.add_argument("--root_dir")
    parser.add_argument("--train_dataset", type=str)
    parser.add_argument("--valid_dataset", type=str)
    parser.add_argument("--dict_file", type=str, default="dict.{}.txt")
    parser.add_argument("--dataset_key", default="LibriSpeech")
    parser.add_argument("--grad_accum", type=int, default=2)
    parser.add_argument("--loss_reduction_type", default="sum",
                        choices=["sum", "mean"])
    parser.add_argument("--pipeline_parallel", type=int, default=1,
                        help="not ported yet")
    parser.add_argument("--pp_microbatches", type=int, default=4,
                        help="inert without --pipeline_parallel")
    parser.add_argument("--num_train_workers", type=int, default=4)
    parser.add_argument("--max_sample_len", type=int)
    parser.add_argument("--lr_scheduler", default="cosine")
    parser.add_argument("--lr_alpha", type=float, default=0.0)
    parser.add_argument("--optim", default="adamw")
    parser.add_argument("--lr", type=float, default=1.0e-4)
    parser.add_argument("--clip", type=float, default=25.0)
    parser.add_argument("--weight_decay", type=float, default=0.0)
    parser.add_argument("--restart_from", type=str,
                        help="fairseq .pt to warm-start from, or a run's "
                             "directory to resume")
    parser.add_argument("--restart_tt", choices=["step", "ignore"],
                        help="ignore: a params-only restore of a "
                             "directory's checkpoint starts at step 0; a "
                             "matching resume file beside it takes "
                             "precedence and restores its own step")
    parser.add_argument("--warmup_steps", type=int, default=10000)
    parser.add_argument("--plateau_steps", type=int, default=0)
    parser.add_argument("--unfreeze_enc_after_step", type=int, default=10_000)
    parser.add_argument("--timestep_masking", type=float, default=0.5)
    parser.add_argument("--timestep_mask_len", type=int, default=10)
    parser.add_argument("--channel_masking", type=float, default=0.1)
    parser.add_argument("--channel_mask_len", type=int, default=64)
    parser.add_argument("--train_steps", type=int, default=320_000)
    parser.add_argument("--valid_steps", type=int, default=1000)
    parser.add_argument("--steps_per_checkpoint", type=int, default=2400)
    parser.add_argument("--verbose", type=str2bool, default=False,
                        help="print a beam-decoded validation sample")
    parser.add_argument("--distributed", type=str2bool, default=False,
                        help="not ported yet")
    parser.add_argument("--vocab_file")
    parser.add_argument("--early_stopping_metric", type=str)
    parser.add_argument("--target_tokens_per_batch", type=int,
                        default=700_000)
    parser.add_argument("--target_type", choices=["wrd", "ltr", "bpe"],
                        default="ltr")
    parser.add_argument("--freeze_fx", type=str2bool, default=True)
    parser.add_argument("--pad_to_multiple", type=int, default=16_000)
    add_augmentation_args(parser)
    parser.add_argument("--length_buckets", type=int, nargs="*",
                        help="audio-length grid (samples); pads each batch "
                             "up to the next bucket")
    parser.add_argument("--profile_dir", type=str,
                        help="write a torch.profiler Chrome trace of "
                             "steps 11-15 here")
    parser.add_argument("--seed", type=int, default=1234,
                        help="seed of the generator that dropout and "
                             "masking draw from")
    add_beam_args(parser)
    add_common_model_args(parser)
    return apply_preset(parser.parse_args(argv))


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(v).to(device, non_blocking=True)
            for k, v in batch.items() if isinstance(v, np.ndarray)}


def train(argv=None):
    """Run the trainer; returns the :class:`TrainState`, whose ``log``
    lists each optimizer step's wall seconds, audio seconds, loss and
    frozen flag."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    device = resolve_device(args.device)
    check_ported(args, "train")
    preempt = PreemptionGuard()  # catch SIGTERM from here on
    try:
        return _train(args, device, preempt)
    finally:
        preempt.close()


def _train(args, device: torch.device, preempt: PreemptionGuard):
    args.dict_file = args.dict_file.format(args.target_type)
    if args.basedir is None:
        args.basedir = f"wav2vec2-{args.dataset_key}-{os.getpid()}"
    os.makedirs(args.basedir, exist_ok=True)
    if device.type == "cuda" and not args.bf16:
        # float32 means float32: no TF32 in cuBLAS or cuDNN
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    Offsets.remap_fairseq_ctc()
    vocab_file = args.vocab_file or os.path.join(args.root_dir,
                                                 args.dict_file)
    vocab_list = read_vocab_list(vocab_file)
    vocab = {v: i for i, v in enumerate(vocab_list)}
    vec = TextVectorizer(vocab)
    index2vocab = revlut(vocab)
    postproc = (M.postproc_bpe if args.target_type == "bpe"
                else M.postproc_letters)

    common = dict(input_sample_rate=args.input_sample_rate,
                  target_sample_rate=args.target_sample_rate,
                  tgt_type=args.target_type,
                  pad_to_multiple=args.pad_to_multiple,
                  length_grid=args.length_buckets)
    train_set = AudioTextLetterDataset(
        os.path.join(args.root_dir, args.train_dataset), vec,
        args.target_tokens_per_batch, args.max_sample_len, shuffle=True,
        **common, **train_augmentation(args))
    valid_set = AudioTextLetterDataset(
        os.path.join(args.root_dir, args.valid_dataset), vec,
        args.target_tokens_per_batch, args.max_sample_len, shuffle=False,
        is_infinite=False, **common)
    logger.info("Loaded datasets")

    cfg = AcousticConfig(
        num_labels=len(vocab), sample_rate=args.target_sample_rate // 1000,
        d_model=args.d_model, num_heads=args.num_heads,
        num_layers=args.num_layers, d_ff=args.d_ff, dropout=args.dropout,
        attention_dropout=args.attention_dropout,
        timestep_masking=args.timestep_masking,
        timestep_mask_len=args.timestep_mask_len,
        channel_masking=args.channel_masking,
        channel_mask_len=args.channel_mask_len,
        layer_drop=args.layer_drop, freeze_fx=args.freeze_fx,
        **encoder_kwargs(args))
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = Wav2Vec2AcousticModel(
        cfg, dtype, generator=torch.Generator().manual_seed(0)).to(device)

    lr_sched = create_lrs(args.lr, args.train_steps, args.lr_scheduler,
                          alpha=args.lr_alpha, warmup_steps=args.warmup_steps,
                          plateau_steps=args.plateau_steps)
    state = TrainState(model, create_optimizer(lr_sched, args.optim,
                                               args.weight_decay))
    resolve_restart(args.restart_from, state, ctc=True,
                    restart_tt=args.restart_tt)
    state.log = []
    ctc_decoder = (PrefixBeamSearch(vocab_list, alpha=args.alpha,
                                    beta=args.beta, beam=args.beam,
                                    lm_file=args.lm)
                   if args.verbose else None)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info("Model has %s parameters on %s", f"{n_params:,}", device)

    grad_fn, update_fn, eval_fn = make_ctc_steps(
        model, clip=args.clip, loss_reduction=args.loss_reduction_type)
    validate_on = min(args.train_steps // 2, args.steps_per_checkpoint)
    report_on = max(10, args.steps_per_checkpoint) // 10
    model_base = os.path.join(args.basedir, "checkpoint")
    sr = args.target_sample_rate

    train_itr = iter(PrefetchLoader(train_set,
                                    num_workers=args.num_train_workers,
                                    prefetch=4))
    avg_loss = Average("average_train_loss")
    step_time = Average("average_step_time")
    batch_size_sent = Average("batch_size")
    batch_size_toks = Average("batch_toks")
    best_metric = 1e8
    generator = torch.Generator().manual_seed(args.seed)
    fused = args.grad_accum == 1
    profiler = StepProfiler(args.profile_dir, device=device)

    acc_grads, acc_examples, acc_tokens, acc_audio = None, 0.0, 0.0, 0.0
    iters, gstep = 0, state.step
    start = time.time()
    while gstep < args.train_steps:
        freeze = gstep <= args.unfreeze_enc_after_step
        iters += 1
        batch = next(train_itr)
        tbatch = _to_device(batch, device)
        if fused:
            _, loss, _, _ = grad_fn.train_step(state, tbatch, generator,
                                               freeze=freeze)
        else:
            loss, grads, _, _ = grad_fn(tbatch, generator, freeze=freeze)
            acc_grads = accumulate_grads(acc_grads, grads)
        acc_examples += batch["num_real"]
        acc_tokens += float(batch["token_lengths"].sum())
        acc_audio += float(batch["signal_lengths"].sum()) / sr
        if iters % 8 == 0:  # subsample the loss fetch (host sync)
            avg_loss.update(float(loss), n=8)

        if iters % args.grad_accum == 0:
            if not fused:
                update_fn(state, acc_grads, acc_examples)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            elapsed = time.time() - start
            state.log.append({"step": gstep + 1, "seconds": elapsed,
                              "audio_s": acc_audio, "loss": float(loss),
                              "frozen": freeze})
            batch_size_sent.update(acc_examples)
            batch_size_toks.update(acc_tokens)
            acc_grads, acc_examples, acc_tokens, acc_audio = \
                None, 0.0, 0.0, 0.0
            gstep += 1
            profiler.step(gstep)
            step_time.update(elapsed)
            start = time.time()

            if gstep % report_on == 0 and step_time.avg:
                sps = 1.0 / step_time.avg
                logger.info("%s, steps/min %.2f, LR %.6f, batch (samples "
                            "%.2f, toks %.2f, toks/min %.2f)", avg_loss,
                            sps * 60, state.current_lr, batch_size_sent.avg,
                            batch_size_toks.avg, batch_size_toks.avg * sps * 60)

            if gstep % validate_on == 0:
                valid_metrics = validate(eval_fn, valid_set, index2vocab,
                                         args.valid_steps, postproc, device,
                                         model, ctc_decoder)
                logger.info({"average_train_loss": avg_loss.avg})
                logger.info(valid_metrics)
                save_checkpoint(state, f"{model_base}-step-{gstep}.pt", "ctc")
                esm = args.early_stopping_metric
                if esm and valid_metrics.get(esm, 1e9) < best_metric:
                    best_metric = valid_metrics[esm]
                    logger.info("New best metric %.4f", best_metric)
                    save_checkpoint(state, f"{model_base}-best.pt", "ctc")
                start = time.time()
            if preempt.should_save(gstep):
                save_checkpoint(state, f"{model_base}-step-{gstep}.pt", "ctc")
                logger.warning("preempted: saved step %d, exiting", gstep)
                break
    train_itr.close()  # stops the prefetch threads
    profiler.close()
    state.profile_trace = profiler.path
    return state


def validate(eval_fn, valid_set, index2vocab, valid_steps, postproc,
             device, model=None, ctc_decoder=None) -> dict:
    """Loss and greedy WER/CER over up to ``valid_steps`` + 1 batches;
    with a ``ctc_decoder`` it prints the beam transcript of each batch's
    first utterance, as the reference's verbose validation does."""
    avg_valid_loss = Average("average_valid_loss")
    c_errors = c_total = w_errors = w_total = 0
    valid_start = time.time()
    for j, batch in enumerate(iter(valid_set)):
        if j > valid_steps:
            break
        loss, frames, frame_lengths = eval_fn(_to_device(batch, device))
        n_real = batch["num_real"]
        sm = M.ctc_metrics(frames.cpu().numpy()[:n_real],
                           batch["token_ids"][:n_real],
                           frame_lengths.cpu().numpy()[:n_real], index2vocab,
                           postproc_fn=postproc)
        c_errors += sm["c_errors"]
        w_errors += sm["w_errors"]
        c_total += sm["c_total"]
        w_total += sm["w_total"]
        avg_valid_loss.update(float(loss))
        if ctc_decoder is not None and n_real > 0:
            tbatch = _to_device(batch, device)
            with torch.no_grad():
                lp, pad_mask = model(tbatch["signal"][:1],
                                     tbatch["signal_lengths"][:1])
            print("".join(ctc_decoder.run(
                lp.float().cpu().numpy(),
                pad_mask.sum(dim=-1).cpu().numpy(), n_best=1)[0]))
    return {"average_valid_loss": avg_valid_loss.avg,
            "valid_elapsed_epoch": time.time() - valid_start,
            "cer": (c_errors / max(c_total, 1)) * 100,
            "wer": (w_errors / max(w_total, 1)) * 100}


def main():
    train()


if __name__ == "__main__":
    main()
