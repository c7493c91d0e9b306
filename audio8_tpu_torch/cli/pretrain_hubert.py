"""HuBERT masked-prediction pretraining entry point of the port
(``a8t-pretrain-hubert`` on PyTorch).

Counterpart of ``audio8_tpu/cli/pretrain_hubert.py``: the encoder
predicts offline k-means cluster ids at masked frames
(``models/hubert.py``), read from the ``.km`` file beside each TSV
manifest (``cli.cluster_targets`` writes them) through the supervised
pipeline, padded -1. AdamW with warmup and decay, the masked
cross-entropy clipped at norm ``--clip``, validation (loss and masked
accuracy) and a fairseq-layout HuBERT checkpoint every ``min(train_steps
// 2, steps_per_checkpoint)`` steps, as the JAX entry point does. It
runs on ``--device`` (the CUDA card by default; it raises without one),
through
the conv forward and backward, attention, dropout and AdamW kernels.

  python -m audio8_tpu_torch.cli.cluster_targets --root_dir corpus \\
      --manifests train.tsv valid.tsv
  python -m audio8_tpu_torch.cli.pretrain_hubert --root_dir corpus \\
      --train_dataset train.tsv --valid_dataset valid.tsv --basedir run

Each checkpoint has a resume file beside it (``train/checkpoint.py``):
``--restart_from <basedir>`` continues a run at its latest step with its
AdamW moments; a ``.pt`` named directly warm-starts the weights at step 0
(``cli/common.py:resolve_restart``). The checkpoint warm-starts
``cli.train``'s CTC encoder (its two heads dropped) and
``cli.cluster_targets --checkpoint`` (iteration 2). On SIGTERM the loop
saves at the next step boundary and exits 0 (``train/preempt.py``).

The flags are the JAX entry point's, with the same names and defaults,
plus ``--device`` and ``--seed`` (the generator that dropout and the
masks draw their seeds from). ``--distributed true`` under ``torchrun``
trains data-parallel (``parallel/sharding.py``): each rank reads its row
block of the same batches, the masks are the global batch's and the
loss and accuracy are taken over all ranks' frames. Those of parts not
ported yet raise: parallelism beyond data parallelism. The MoE flags
train a Mixture-of-Experts encoder (under ``--distributed`` too) and
log ``moe_aux``. ``--lane_align`` (TPU
tiling) is not a flag here.
"""
from __future__ import annotations

import logging
import os
import time
from argparse import ArgumentParser

import numpy as np
import torch

from audio8_tpu_torch.cli.common import (add_common_model_args,
                                        apply_preset, check_ported,
                                        encoder_kwargs, moe_aux,
                                        resolve_restart, save_on_rank0,
                                        shard_kwargs, start_distributed)
from audio8_tpu_torch.config import HubertPretrainConfig
from audio8_tpu_torch.data.datasets import (AudioTextLetterDataset,
                                            PrefetchLoader)
from audio8_tpu_torch.models.hubert import HubertPretrainModel, HubertSeeds
from audio8_tpu_torch.parallel import shard_state
from audio8_tpu_torch.parallel.sharding import (global_sum_scalars,
                                                sync_from_rank0)
from audio8_tpu_torch.train.checkpoint import save_checkpoint
from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                          create_optimizer)
from audio8_tpu_torch.train.preempt import PreemptionGuard
from audio8_tpu_torch.train.steps import make_hubert_steps
from audio8_tpu_torch.utils import Average, str2bool

logger = logging.getLogger("audio8_tpu_torch.pretrain_hubert")


def parse_args(argv=None):
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--basedir", type=str)
    parser.add_argument("--root_dir")
    parser.add_argument("--train_dataset", type=str,
                        help="TSV manifest; targets come from the sibling "
                             ".km file (cli.cluster_targets)")
    parser.add_argument("--valid_dataset", type=str)
    parser.add_argument("--dataset_key", default="LibriSpeech")
    parser.add_argument("--num_clusters", type=int, default=100)
    parser.add_argument("--final_dim", type=int, default=256)
    parser.add_argument("--logit_temp", type=float, default=0.1)
    parser.add_argument("--pred_masked_weight", type=float, default=1.0)
    parser.add_argument("--pred_unmasked_weight", type=float, default=0.0)
    parser.add_argument("--num_train_workers", type=int, default=4)
    parser.add_argument("--max_sample_len", type=int, default=325_000)
    parser.add_argument("--lr_scheduler", default="cosine")
    parser.add_argument("--lr_alpha", type=float, default=0.0)
    parser.add_argument("--optim", default="adamw")
    parser.add_argument("--lr", type=float, default=5.0e-4)
    parser.add_argument("--clip", type=float, default=1.0)
    parser.add_argument("--weight_decay", type=float, default=0.01)
    parser.add_argument("--restart_tt", choices=["step", "ignore"])
    parser.add_argument("--restart_from", type=str,
                        help="a run's directory to resume, or a .pt to "
                             "warm-start from")
    parser.add_argument("--warmup_steps", type=int, default=32_000)
    parser.add_argument("--plateau_steps", type=int, default=0)
    parser.add_argument("--timestep_masking", type=float, default=0.80)
    parser.add_argument("--timestep_mask_len", type=int, default=10)
    parser.add_argument("--train_steps", type=int, default=250_000)
    parser.add_argument("--valid_steps", type=int, default=100)
    parser.add_argument("--steps_per_checkpoint", type=int, default=2400)
    parser.add_argument("--distributed", type=str2bool, default=False,
                        help="data-parallel over the ranks torchrun "
                             "starts, one card each")
    parser.add_argument("--target_tokens_per_batch", type=int,
                        default=1_400_000)
    parser.add_argument("--pad_to_multiple", type=int, default=16_000)
    parser.add_argument("--length_buckets", type=int, nargs="*")
    parser.add_argument("--seed", type=int, default=1234,
                        help="seed of the generator that dropout and the "
                             "masks draw from")
    add_common_model_args(parser)
    return apply_preset(parser.parse_args(argv))


def make_dataset(args, tsv: str, shuffle: bool = True,
                 infinite: bool = True, rank: int = 0,
                 world: int = 1) -> AudioTextLetterDataset:
    """The supervised pipeline over ``tsv`` and its ``.km`` targets,
    row-sharded for rank ``rank`` of ``world``."""
    return AudioTextLetterDataset(
        os.path.join(args.root_dir, tsv), None,
        args.target_tokens_per_batch, args.max_sample_len,
        input_sample_rate=args.input_sample_rate,
        target_sample_rate=args.target_sample_rate,
        shuffle=shuffle, is_infinite=infinite,
        tgt_type=AudioTextLetterDataset.TGT_KM,
        max_dst_length=2048,  # frames at 50 Hz; >= max_sample_len / 320
        pad_to_multiple=args.pad_to_multiple,
        length_grid=args.length_buckets, **shard_kwargs(rank, world))


def build_config(args) -> HubertPretrainConfig:
    return HubertPretrainConfig(
        num_clusters=args.num_clusters, final_dim=args.final_dim,
        logit_temp=args.logit_temp,
        pred_masked_weight=args.pred_masked_weight,
        pred_unmasked_weight=args.pred_unmasked_weight,
        sample_rate=args.target_sample_rate // 1000,
        d_model=args.d_model, num_heads=args.num_heads,
        num_layers=args.num_layers, d_ff=args.d_ff, dropout=args.dropout,
        attention_dropout=args.attention_dropout,
        timestep_masking=args.timestep_masking,
        timestep_mask_len=args.timestep_mask_len,
        layer_drop=args.layer_drop, freeze_fx=False, **encoder_kwargs(args))


def to_device(batch: dict, device: torch.device) -> dict:
    out = {k: torch.from_numpy(v).to(device, non_blocking=True)
           for k, v in batch.items() if isinstance(v, np.ndarray)}
    if batch.get("row_offset"):  # a row-sharded block past row 0
        out["row_offset"] = batch["row_offset"]
    return out


def train(argv=None):
    """Run the pretraining loop; returns the :class:`TrainState`, whose
    ``log`` lists each step's wall seconds, audio seconds, batch shape
    (rows, samples), loss, masked accuracy and gradient norm."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    check_ported(args, "pretrain_hubert")
    device, rank, world, group = start_distributed(args)
    preempt = PreemptionGuard(group)  # catch SIGTERM from here on
    try:
        return _train(args, device, preempt, rank, world, group)
    finally:
        preempt.close()


def _train(args, device: torch.device, preempt: PreemptionGuard,
           rank: int = 0, world: int = 1, group=None):
    if args.basedir is None:
        args.basedir = f"hubert-{args.dataset_key}-{os.getpid()}"
    os.makedirs(args.basedir, exist_ok=True)
    if device.type == "cuda" and not args.bf16:
        # float32 means float32: no TF32 in cuBLAS or cuDNN
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    train_set = make_dataset(args, args.train_dataset, rank=rank,
                             world=world)
    valid_set = make_dataset(args, args.valid_dataset, shuffle=False,
                             infinite=False, rank=rank, world=world)
    logger.info("Loaded datasets")

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = HubertPretrainModel(
        build_config(args), dtype,
        generator=torch.Generator().manual_seed(0)).to(device)
    lr_sched = create_lrs(args.lr, args.train_steps, args.lr_scheduler,
                          alpha=args.lr_alpha, warmup_steps=args.warmup_steps,
                          plateau_steps=args.plateau_steps)
    state = TrainState(model, create_optimizer(lr_sched, args.optim,
                                               args.weight_decay))
    resolve_restart(args.restart_from, state, ctc=False,
                    restart_tt=args.restart_tt, kind="hubert")
    if group is not None:
        sync_from_rank0(model, group)
    state.log = []
    n_params = sum(p.numel() for p in model.parameters())
    logger.info("Model has %s parameters on %s", f"{n_params:,}", device)

    # ZeRO-1 / FSDP: the whole state restored and broadcast, now
    # sharded (nothing without a group or at one rank)
    shard_state(state, group, zero1=args.zero1, fsdp=args.fsdp)
    train_step, eval_step = make_hubert_steps(model, clip=args.clip,
                                              group=group)
    validate_on = min(args.train_steps // 2, args.steps_per_checkpoint)
    report_on = max(10, args.steps_per_checkpoint) // 10
    model_base = os.path.join(args.basedir, "checkpoint")
    sr = args.target_sample_rate

    train_itr = iter(PrefetchLoader(train_set,
                                    num_workers=args.num_train_workers,
                                    prefetch=4))
    avg_loss = Average("average_train_loss")
    avg_acc = Average("masked_accuracy")
    step_time = Average("average_step_time")
    generator = torch.Generator().manual_seed(args.seed)

    gstep = state.step
    start = time.time()
    while gstep < args.train_steps:
        batch = next(train_itr)
        state, metrics = train_step(state, to_device(batch, device),
                                    HubertSeeds.draw(generator), generator)
        gstep += 1
        loss = float(metrics["loss"])  # synchronises with the card
        acc = float(metrics["acc_masked"])
        avg_loss.update(loss)
        avg_acc.update(acc)
        elapsed = time.time() - start
        step_time.update(elapsed)
        audio_s, = global_sum_scalars(
            [float(batch["signal_lengths"].sum()) / sr], group).tolist()
        state.log.append({
            "step": gstep, "seconds": elapsed, "audio_s": audio_s,
            "rows": batch["signal"].shape[0] * world,
            "samples": batch["signal"].shape[1], "loss": loss,
            "acc_masked": acc, "grad_norm": float(metrics["grad_norm"]),
            **moe_aux(metrics)})
        start = time.time()

        if gstep % report_on == 0 and step_time.avg:
            logger.info("%s, %s, steps/min %.2f, LR %.6f", avg_loss,
                        avg_acc, 60.0 / step_time.avg, state.current_lr)
        if gstep % validate_on == 0:
            state.valid = validate(eval_step, valid_set, args.valid_steps,
                                   generator, device)
            logger.info(state.valid)
            save_on_rank0(group, save_checkpoint, state,
                          f"{model_base}-step-{gstep}.pt", "hubert")
            start = time.time()
        if preempt.should_save(gstep):
            save_on_rank0(group, save_checkpoint, state,
                          f"{model_base}-step-{gstep}.pt", "hubert")
            logger.warning("preempted: saved step %d, exiting", gstep)
            break
    train_itr.close()  # stops the prefetch threads
    return state


def validate(eval_step, valid_set, valid_steps: int, generator,
             device: torch.device) -> dict:
    """The loss over up to ``valid_steps`` + 1 batches and the masked
    accuracy weighted by each batch's masked frames, as the JAX entry point
    reports them."""
    avg_loss = Average("average_valid_loss")
    correct = total = 0.0
    t0 = time.time()
    for j, batch in enumerate(iter(valid_set)):
        if j > valid_steps:
            break
        loss, metrics = eval_step(to_device(batch, device),
                                  HubertSeeds.draw(generator))
        avg_loss.update(float(loss))
        n = float(metrics["n_masked"])
        correct += float(metrics["acc_masked"]) * n
        total += n
    return {"average_valid_loss": avg_loss.avg,
            "valid_masked_accuracy": correct / max(total, 1.0),
            "valid_elapsed_epoch": time.time() - t0}


def main():
    train()


if __name__ == "__main__":
    main()
