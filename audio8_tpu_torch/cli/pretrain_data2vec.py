"""data2vec-audio masked-regression pretraining entry point of the port
(``a8t-pretrain-data2vec`` on PyTorch).

Counterpart of ``audio8_tpu/cli/pretrain_data2vec.py``: the student
regresses an EMA teacher's instance-normalised average of its top-k layer
outputs at masked frames (``models/data2vec.py``), over the unsupervised
pipeline's dense min-cropped batches (``AudioFileDataset``, as
``cli.pretrain``). The teacher starts as a copy of the student and moves
by the annealed EMA after every step. Validation and a checkpoint every
``min(train_steps // 2, steps_per_checkpoint)`` steps: the student as a
fairseq-layout ``checkpoint-step-N.pt`` with its resume file, the
teacher beside it as ``teacher-step-N.pt``. It runs on ``--device`` (the
CUDA card by default; it raises without one), through the conv forward
and backward, attention, dropout and AdamW kernels.

  python -m audio8_tpu_torch.cli.pretrain_data2vec --manifest_dir corpus \\
      --basedir run --preset data2vec-base

``--preset data2vec-base`` trains the data2vec-audio layout (the
layer-norm extractor and five stacked positional convs); any other
transformer layout trains too. ``--restart_from <basedir>`` resumes the
student with its AdamW moments and the latest ``teacher-step-N.pt``
(without one, the teacher is the restored student); a ``.pt`` named
directly warm-starts the student at step 0. The checkpoint warm-starts
``cli.train``'s CTC encoder. On SIGTERM the loop saves both at the next
step boundary and exits 0.

The flags are the JAX entry point's, with the same names and defaults,
plus ``--device`` and ``--seed`` (the generator that dropout and the mask
draw their seeds from). ``--distributed true`` under ``torchrun`` trains
data-parallel (``parallel/sharding.py``): each rank reads its row block
of the same min-cropped batches, the mask is the global batch's, the
loss and the collapse monitors are taken over all ranks' frames, and
every rank's teacher moves by the same EMA. Those of parts not ported
yet raise: parallelism beyond data parallelism, and ``--moe_experts``
under ``--distributed``. The MoE flags train a
Mixture-of-Experts student (its teacher is the EMA of the same
layout) and log ``moe_aux``.
"""
from __future__ import annotations

import copy
import logging
import os
import time
from argparse import ArgumentParser

import torch

from audio8_tpu_torch.cli.common import (add_common_model_args,
                                        apply_preset, check_ported,
                                        encoder_kwargs, moe_aux,
                                        resolve_restart, save_on_rank0,
                                        shard_kwargs, start_distributed)
from audio8_tpu_torch.config import Data2VecPretrainConfig
from audio8_tpu_torch.data.datasets import AudioFileDataset, PrefetchLoader
from audio8_tpu_torch.models.convert import save_fairseq_pretrained
from audio8_tpu_torch.models.data2vec import Data2VecAudioModel
from audio8_tpu_torch.ops.hashrand import draw_seed
from audio8_tpu_torch.parallel import shard_like, shard_state
from audio8_tpu_torch.parallel.sharding import sync_from_rank0
from audio8_tpu_torch.train.checkpoint import (TEACHER_BASE, load_teacher,
                                               save_checkpoint)
from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                          create_optimizer)
from audio8_tpu_torch.train.preempt import PreemptionGuard
from audio8_tpu_torch.train.steps import make_data2vec_steps
from audio8_tpu_torch.utils import Average, str2bool

logger = logging.getLogger("audio8_tpu_torch.pretrain_data2vec")


def parse_args(argv=None):
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--basedir", type=str)
    parser.add_argument("--manifest_dir", required=True)
    parser.add_argument("--train_manifest_file", default="train.tsv")
    parser.add_argument("--valid_manifest_file", default="valid.tsv")
    parser.add_argument("--dataset_key", default="ls")
    parser.add_argument("--average_top_k_layers", type=int, default=8)
    parser.add_argument("--ema_decay", type=float, default=0.999)
    parser.add_argument("--ema_end_decay", type=float, default=0.9999)
    parser.add_argument("--ema_anneal_steps", type=int, default=30_000)
    parser.add_argument("--num_train_workers", type=int, default=4)
    parser.add_argument("--tokens_per_batch", type=int, default=1_400_000)
    parser.add_argument("--max_sample_len", type=int, default=325_000)
    parser.add_argument("--lr_scheduler", default="cosine")
    parser.add_argument("--lr_alpha", type=float, default=0.0)
    parser.add_argument("--optim", default="adamw")
    parser.add_argument("--lr", type=float, default=5.0e-4)
    parser.add_argument("--clip", type=float, default=1.0)
    parser.add_argument("--weight_decay", type=float, default=1.0e-2)
    parser.add_argument("--buckets", type=int, nargs="*")
    parser.add_argument("--restart_from", type=str,
                        help="a run's directory to resume (student and "
                             "teacher), or a .pt to warm-start from")
    parser.add_argument("--restart_tt", choices=["step", "ignore"])
    parser.add_argument("--warmup_steps", type=int, default=10_000)
    parser.add_argument("--plateau_steps", type=int, default=0)
    parser.add_argument("--timestep_masking", type=float, default=0.65)
    parser.add_argument("--timestep_mask_len", type=int, default=10)
    parser.add_argument("--train_steps", type=int, default=400_000)
    parser.add_argument("--valid_steps", type=int, default=10)
    parser.add_argument("--steps_per_checkpoint", type=int, default=1000)
    parser.add_argument("--distributed", type=str2bool, default=False,
                        help="data-parallel over the ranks torchrun "
                             "starts, one card each")
    parser.add_argument("--seed", type=int, default=1234,
                        help="seed of the generator that dropout and the "
                             "mask draw from")
    add_common_model_args(parser)
    return apply_preset(parser.parse_args(argv))


def build_config(args) -> Data2VecPretrainConfig:
    return Data2VecPretrainConfig(
        average_top_k_layers=args.average_top_k_layers,
        ema_decay=args.ema_decay, ema_end_decay=args.ema_end_decay,
        ema_anneal_steps=args.ema_anneal_steps,
        sample_rate=args.target_sample_rate // 1000,
        d_model=args.d_model, num_heads=args.num_heads,
        num_layers=args.num_layers, d_ff=args.d_ff, dropout=args.dropout,
        attention_dropout=args.attention_dropout,
        timestep_masking=args.timestep_masking,
        timestep_mask_len=args.timestep_mask_len,
        layer_drop=args.layer_drop, freeze_fx=False, **encoder_kwargs(args))


def make_teacher(state, restart_from) -> torch.nn.Module:
    """The EMA teacher: a copy of the (restored) student, then the latest
    ``teacher-step-N.pt`` beside ``restart_from`` when there is one."""
    teacher = copy.deepcopy(state.model).requires_grad_(False)
    if restart_from:
        path = load_teacher(teacher, restart_from)
        if path:
            logger.info("restored teacher from %s", path)
        else:
            logger.info("no teacher checkpoint found; teacher = student")
    return teacher


def train(argv=None):
    """Run the pretraining loop; returns ``(state, teacher)``. The
    state's ``log`` lists each step's wall seconds, audio seconds, batch
    shape (rows, samples), loss, target and prediction std, EMA decay and
    gradient norm."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    check_ported(args, "pretrain_data2vec")
    device, rank, world, group = start_distributed(args)
    preempt = PreemptionGuard(group)  # catch SIGTERM from here on
    try:
        return _train(args, device, preempt, rank, world, group)
    finally:
        preempt.close()


def _train(args, device: torch.device, preempt: PreemptionGuard,
           rank: int = 0, world: int = 1, group=None):
    if args.basedir is None:
        args.basedir = f"data2vec-{args.dataset_key}-{os.getpid()}"
    os.makedirs(args.basedir, exist_ok=True)
    if device.type == "cuda" and not args.bf16:
        # float32 means float32: no TF32 in cuBLAS or cuDNN
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    train_set, valid_set = (AudioFileDataset(
        os.path.join(args.manifest_dir, m), args.max_sample_len,
        args.tokens_per_batch, length_grid=args.buckets,
        **shard_kwargs(rank, world))
        for m in (args.train_manifest_file, args.valid_manifest_file))
    logger.info("Loaded datasets")

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = Data2VecAudioModel(
        build_config(args), dtype,
        generator=torch.Generator().manual_seed(0)).to(device)
    lr_sched = create_lrs(args.lr, args.train_steps, args.lr_scheduler,
                          alpha=args.lr_alpha, warmup_steps=args.warmup_steps,
                          plateau_steps=args.plateau_steps)
    state = TrainState(model, create_optimizer(lr_sched, args.optim,
                                               args.weight_decay))
    resolve_restart(args.restart_from, state, ctc=False,
                    restart_tt=args.restart_tt, kind="data2vec")
    if group is not None:
        sync_from_rank0(model, group)
    teacher = make_teacher(state, args.restart_from)
    state.log = []
    n_params = sum(p.numel() for p in model.parameters())
    logger.info("Model has %s parameters on %s (x2 with the EMA teacher)",
                f"{n_params:,}", device)

    # ZeRO-1 / FSDP: the whole state restored and broadcast, now
    # sharded (nothing without a group or at one rank)
    shard_state(state, group, zero1=args.zero1, fsdp=args.fsdp)
    shard_like(teacher, state)
    train_step, eval_step = make_data2vec_steps(model, teacher,
                                                clip=args.clip, group=group)
    validate_on = min(args.train_steps // 2, args.steps_per_checkpoint)
    report_on = max(10, args.steps_per_checkpoint) // 10
    model_base = os.path.join(args.basedir, "checkpoint")
    teacher_base = os.path.join(args.basedir, TEACHER_BASE)
    sr = args.target_sample_rate

    def save(step: int) -> None:
        save_checkpoint(state, f"{model_base}-step-{step}.pt", "data2vec")
        save_fairseq_pretrained(teacher, f"{teacher_base}-step-{step}.pt")

    def save_all(step: int) -> None:
        save_on_rank0(group, save, step, whole=(state, teacher))

    train_itr = iter(PrefetchLoader(train_set,
                                    num_workers=args.num_train_workers,
                                    prefetch=4))
    avg_loss = Average("average_train_loss")
    target_std = Average("target_std")
    step_time = Average("average_step_time")
    generator = torch.Generator().manual_seed(args.seed)

    gstep = state.step
    start = time.time()
    while gstep < args.train_steps:
        signal = next(train_itr)
        batch = {"signal": torch.from_numpy(signal).to(device,
                                                       non_blocking=True),
                 "signal_lengths": None,
                 "row_offset": rank * signal.shape[0]}
        state, metrics = train_step(state, batch, draw_seed(generator),
                                    generator)
        gstep += 1
        loss = float(metrics["loss"])  # synchronises with the card
        avg_loss.update(loss)
        target_std.update(float(metrics["target_std"]))
        elapsed = time.time() - start
        step_time.update(elapsed)
        state.log.append({
            "step": gstep, "seconds": elapsed,
            "audio_s": signal.size * world / sr,
            "rows": signal.shape[0] * world, "samples": signal.shape[1],
            "loss": loss, "target_std": float(metrics["target_std"]),
            "pred_std": float(metrics["pred_std"]),
            "ema_decay": metrics["ema_decay"],
            "grad_norm": float(metrics["grad_norm"]), **moe_aux(metrics)})
        start = time.time()

        if gstep % report_on == 0 and step_time.avg:
            logger.info("%s, %s, steps/min %.2f, LR %.6f, ema %.5f",
                        avg_loss, target_std, 60.0 / step_time.avg,
                        state.current_lr, metrics["ema_decay"])
        if gstep % validate_on == 0:
            state.valid = validate(eval_step, valid_set, args.valid_steps,
                                   generator, device, rank)
            logger.info(state.valid)
            save_all(gstep)
            start = time.time()
        if preempt.should_save(gstep):
            save_all(gstep)
            logger.warning("preempted: saved step %d, exiting", gstep)
            break
    train_itr.close()  # stops the prefetch threads
    return state, teacher


def validate(eval_step, valid_set, valid_steps: int, generator,
             device: torch.device, rank: int = 0) -> dict:
    """The average loss over up to ``valid_steps`` validation batches
    (the global batches' under data parallelism)."""
    avg_loss = Average("average_valid_loss")
    t0 = time.time()
    itr = iter(valid_set)
    for _ in range(valid_steps):
        try:
            signal = torch.from_numpy(next(itr)).to(device)
        except StopIteration:
            break
        loss, _ = eval_step({"signal": signal, "signal_lengths": None,
                             "row_offset": rank * signal.shape[0]},
                            draw_seed(generator))
        avg_loss.update(float(loss))
    return {"average_valid_loss": avg_loss.avg,
            "valid_elapsed_epoch": time.time() - t0}


def main():
    train()


if __name__ == "__main__":
    main()
