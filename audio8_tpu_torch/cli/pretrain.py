"""Contrastive pretraining entry point of the port (``a8t-pretrain`` on
PyTorch).

Counterpart of ``audio8_tpu/cli/pretrain.py``: wav2vec 2.0
self-supervised pretraining (Gumbel VQ + InfoNCE + diversity loss) over
dense min-cropped (optionally bucketed) batches, AdamW with warmup and
decay, the Gumbel temperature annealed with the global step, fairseq-
layout checkpoints every ``--steps_per_checkpoint`` steps and validation
every 10x that (at ``(step + 1) % period == 0``, as the JAX entry point
does). It runs on ``--device`` (the CUDA card by default; it raises
without one), through the conv forward and backward, attention, dropout
and AdamW kernels.

  python -m audio8_tpu_torch.cli.pretrain --manifest_dir corpus \\
      --basedir run

Each checkpoint has a resume file beside it (``train/checkpoint.py``):
``--restart_from <basedir>`` continues a run at its latest step, with
its AdamW moments, LR schedule and Gumbel temperature; a fairseq ``.pt``
named directly warm-starts the weights at step 0
(``cli/common.py:resolve_restart``). On SIGTERM the loop saves at the
next step boundary and exits 0 (``train/preempt.py``).

The flags are the JAX entry point's, with the same names and defaults,
plus ``--device``, ``--seed`` (the generator that dropout, masks, Gumbel
noise and negatives draw their seeds from) and ``--restart_tt``.
``--remat`` recomputes each encoder layer in the backward on its
replayed dropout seeds, ``--optim sgd`` steps plain SGD, and
``--profile_dir`` writes a Chrome trace of the five steps after the
tenth (``train/profiler.py``). Those of parts not ported yet raise:
parallelism and ``--distributed`` and the MoE flags. ``--lane_align``
(TPU tiling) is not a flag here.
"""
from __future__ import annotations

import logging
import os
import time
from argparse import ArgumentParser

import torch

from audio8_tpu_torch.cli.common import (add_common_model_args,
                                        apply_preset, check_ported,
                                        encoder_kwargs, resolve_device,
                                        resolve_restart)
from audio8_tpu_torch.config import PretrainConfig
from audio8_tpu_torch.data.datasets import (AudioFileDataset,
                                            BucketingAudioDataset,
                                            PrefetchLoader)
from audio8_tpu_torch.models.wav2vec2 import PretrainSeeds, Wav2Vec2Model
from audio8_tpu_torch.train.checkpoint import save_checkpoint
from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                          create_optimizer)
from audio8_tpu_torch.train.preempt import PreemptionGuard
from audio8_tpu_torch.train.profiler import StepProfiler
from audio8_tpu_torch.train.steps import make_pretrain_steps
from audio8_tpu_torch.utils import Average, str2bool

logger = logging.getLogger("audio8_tpu_torch.pretrain")

DEFAULT_BUCKETS = [11111, 35714, 38461, 41666, 45454, 50000, 55555, 62500,
                   71428, 83333, 100000, 125000, 166666, 250000]

def parse_args(argv=None):
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--basedir", type=str)
    parser.add_argument("--manifest_dir", required=True)
    parser.add_argument("--train_manifest_file", default="train.tsv")
    parser.add_argument("--valid_manifest_file", default="valid.tsv")
    parser.add_argument("--dataset_key", default="ls")
    parser.add_argument("--num_vq_vars", type=int, default=320)
    parser.add_argument("--num_vq_groups", type=int, default=2)
    parser.add_argument("--final_dim", type=int, default=None,
                        help="VQ/contrastive projection width (the preset's: "
                             "256 base, 768 large)")
    parser.add_argument("--num_train_workers", type=int, default=4)
    parser.add_argument("--tokens_per_batch", type=int, default=1_400_000)
    parser.add_argument("--max_sample_len", type=int, default=325_000)
    parser.add_argument("--lr_scheduler", default="cosine")
    parser.add_argument("--lr_alpha", type=float, default=0.0)
    parser.add_argument("--optim", default="adamw")
    parser.add_argument("--lr", type=float, default=2.0e-4)
    parser.add_argument("--clip", type=float, default=1.0)
    parser.add_argument("--weight_decay", type=float, default=1.0e-2)
    parser.add_argument("--bucketing", type=str2bool, default=False)
    parser.add_argument("--buckets", type=int, nargs="+",
                        default=DEFAULT_BUCKETS)
    parser.add_argument("--train_steps", type=int, default=400_000)
    parser.add_argument("--valid_steps", type=int, default=10_000)
    parser.add_argument("--restart_from", type=str,
                        help="a run's directory to resume, or a fairseq "
                             ".pt to warm-start from")
    parser.add_argument("--restart_tt", choices=["step", "ignore"],
                        help="ignore: a params-only restore of a "
                             "directory's checkpoint starts at step 0; a "
                             "matching resume file beside it takes "
                             "precedence and restores its own step")
    parser.add_argument("--warmup_steps", type=int, default=10000)
    parser.add_argument("--plateau_steps", type=int, default=0)
    parser.add_argument("--steps_per_checkpoint", type=int, default=1000)
    parser.add_argument("--distributed", type=str2bool, default=False,
                        help="not ported yet")
    parser.add_argument("--n_negatives", type=int, default=100)
    parser.add_argument("--profile_dir", type=str,
                        help="write a torch.profiler Chrome trace of "
                             "steps 11-15 here")
    parser.add_argument("--seed", type=int, default=1234,
                        help="seed of the generator that dropout, masks, "
                             "Gumbel noise and negatives draw from")
    add_common_model_args(parser)
    return apply_preset(parser.parse_args(argv))


def _datasets(args):
    train_manifest = os.path.join(args.manifest_dir, args.train_manifest_file)
    valid_manifest = os.path.join(args.manifest_dir, args.valid_manifest_file)
    if args.bucketing:
        return tuple(BucketingAudioDataset(
            args.buckets, m, args.max_sample_len, args.tokens_per_batch)
            for m in (train_manifest, valid_manifest))
    return tuple(AudioFileDataset(m, args.max_sample_len,
                                  args.tokens_per_batch,
                                  length_grid=args.buckets)
                 for m in (train_manifest, valid_manifest))


def train(argv=None):
    """Run the pretraining loop; returns the :class:`TrainState`, whose
    ``log`` lists each step's wall seconds, audio seconds, batch shape
    (rows, samples), loss, code perplexity, accuracy, temperature and
    gradient norm."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    device = resolve_device(args.device)
    check_ported(args, "pretrain")
    preempt = PreemptionGuard()  # catch SIGTERM from here on
    try:
        return _train(args, device, preempt)
    finally:
        preempt.close()


def _train(args, device: torch.device, preempt: PreemptionGuard):
    if args.basedir is None:
        args.basedir = f"wav2vec2-{args.dataset_key}-{os.getpid()}"
    os.makedirs(args.basedir, exist_ok=True)
    if device.type == "cuda" and not args.bf16:
        # float32 means float32: no TF32 in cuBLAS or cuDNN
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    train_set, valid_set = _datasets(args)
    logger.info("Loaded datasets")

    cfg = PretrainConfig(
        sample_rate=args.target_sample_rate // 1000,
        num_vq_vars=args.num_vq_vars, num_vq_groups=args.num_vq_groups,
        final_dim=args.final_dim, d_model=args.d_model,
        num_heads=args.num_heads, num_layers=args.num_layers, d_ff=args.d_ff,
        dropout=args.dropout, attention_dropout=args.attention_dropout,
        layer_drop=args.layer_drop, n_negatives=args.n_negatives,
        **encoder_kwargs(args))
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = Wav2Vec2Model(
        cfg, dtype, generator=torch.Generator().manual_seed(0)).to(device)

    lr_sched = create_lrs(args.lr, args.train_steps, args.lr_scheduler,
                          alpha=args.lr_alpha, warmup_steps=args.warmup_steps,
                          plateau_steps=args.plateau_steps)
    state = TrainState(model, create_optimizer(lr_sched, args.optim,
                                               args.weight_decay))
    resolve_restart(args.restart_from, state, ctc=False,
                    restart_tt=args.restart_tt)
    state.log = []
    n_params = sum(p.numel() for p in model.parameters())
    logger.info("Model has %s parameters on %s", f"{n_params:,}", device)

    train_step, eval_step = make_pretrain_steps(
        model, clip=args.clip, n_negatives=args.n_negatives)

    update_on = args.steps_per_checkpoint
    validate_on = update_on * 10
    report_on = max(10, update_on) // 10
    model_base = os.path.join(args.basedir, "checkpoint")
    sr = args.target_sample_rate

    train_itr = iter(PrefetchLoader(train_set,
                                    num_workers=args.num_train_workers,
                                    prefetch=4))
    avg_loss = Average("average_train_loss")
    step_time = Average("average_step_time")
    start_of_run = time.time()
    generator = torch.Generator().manual_seed(args.seed)
    profiler = StepProfiler(args.profile_dir, device=device)

    steps = state.step
    while steps < args.train_steps:
        start = time.time()
        batch = next(train_itr)
        signal = torch.from_numpy(batch).to(device, non_blocking=True)
        state, metrics = train_step(state, signal,
                                    PretrainSeeds.draw(generator), generator)
        steps += 1
        profiler.step(steps)
        loss = float(metrics["loss"])  # synchronises with the card
        avg_loss.update(loss)
        elapsed = time.time() - start
        step_time.update(elapsed)
        state.log.append({
            "step": steps, "seconds": elapsed, "audio_s": batch.size / sr,
            "rows": batch.shape[0], "samples": batch.shape[1], "loss": loss,
            "code_perplexity": float(metrics["code_perplexity"]),
            "accuracy": float(metrics["accuracy"]),
            "temperature": metrics["temperature"],
            "grad_norm": float(metrics["grad_norm"])})

        if (steps + 1) % report_on == 0 and step_time.avg:
            logger.info("%s, steps/min %.2f, LR %.6f, temp %.4f, ppl %.1f, "
                        "acc %.3f", avg_loss, 60.0 / step_time.avg,
                        state.current_lr, metrics["temperature"],
                        float(metrics["code_perplexity"]),
                        float(metrics["accuracy"]))
        if (steps + 1) % update_on == 0:
            save_checkpoint(state, f"{model_base}-step-{steps}.pt",
                            "pretrain")
        if preempt.should_save(steps):
            save_checkpoint(state, f"{model_base}-step-{steps}.pt",
                            "pretrain")
            logger.warning("preempted: saved step %d, exiting", steps)
            break
        if (steps + 1) % validate_on == 0:
            logger.info(validate(eval_step, valid_set, args.valid_steps,
                                 generator, state.step, device, {
                                     "train_elapsed_min":
                                         (time.time() - start_of_run) / 60,
                                     "average_train_loss": avg_loss.avg}))
    train_itr.close()  # stops the prefetch threads
    profiler.close()
    state.profile_trace = profiler.path
    return state


def validate(eval_step, valid_set, valid_steps, generator, step, device,
             m: dict) -> dict:
    """The average loss over up to ``valid_steps`` validation batches."""
    avg_valid = Average("average_valid_loss")
    vstart = time.time()
    valid_itr = iter(valid_set)
    for _ in range(valid_steps):
        try:
            signal = torch.from_numpy(next(valid_itr)).to(device)
        except StopIteration:
            break
        loss, _ = eval_step(signal, PretrainSeeds.draw(generator), step)
        avg_valid.update(float(loss))
    return dict(m, average_valid_loss=avg_valid.avg,
                valid_elapsed_epoch=(time.time() - vstart) / 60)


def main():
    train()


if __name__ == "__main__":
    main()
