"""Paired audio <-> text contrastive (CLIP-style) pretraining entry point
of the port (``a8t-pretrain-paired`` on PyTorch).

Counterpart of ``audio8_tpu/cli/pretrain_paired.py``: a pooled wav2vec2
audio tower and a transformer (rpr attention) or bag-of-words text
tower, each projected to ``--output_dim`` through ``--stacking_layers``,
trained with the symmetric InfoNCE loss and its temperature
(``--init_temp``, learned with ``--learn_temp``) by one AdamW over both
(``models/dual_encoder.py``), each tower frozen up to its own
``--unfreeze_{audio,text}_after_step``. Targets are words
(``--target_type wrd``, the root's ``dict.wrd.txt``) or BPE pieces
(``--target_type bpe`` with ``--subword_model_file`` and
``--subword_vocab_file``, e.g. from ``cli.learn_bpe``). It runs on
``--device`` (the CUDA card by default; it raises without one), through
the attention, dropout and AdamW kernels and the conv forward; the text
tower's rpr attention is the torch composition (``nn/transformer.py``).

  python -m audio8_tpu_torch.cli.pretrain_paired --root_dir corpus \\
      --train_dataset train.tsv --valid_dataset valid.tsv --basedir run

Checkpoints are the port's paired ``.pt`` files with a resume file
beside each (``train/checkpoint.py``); ``--restart_from`` loads one at
step 0 or resumes a run from its directory. On SIGTERM the trainer saves
at the next step boundary and exits 0. ``--warmstart_text`` overlays a
pretrained transformer LM's ``.npz`` on the text tower
(``models/warmstart.py``) before the restart resolves, ``--remat``
recomputes each audio encoder layer in the backward on its replayed
dropout seeds, ``--optim sgd`` steps plain SGD. ``--distributed true``
under ``torchrun`` trains data-parallel (``parallel/sharding.py``): each
rank reads its row block, the CLIP similarities are the global batch's
(every rank gathers all ranks' embeddings; its gradient reaches its own
rows, the temperature's rank 0's), and rank 0 alone writes checkpoints.
The flags are the JAX trainer's; those of parts not ported yet raise:
parallelism beyond data parallelism, and ``--moe_experts`` under
``--distributed``. ``--lane_align`` (TPU tiling) is not a flag here.
"""
from __future__ import annotations

import logging
import os
import time
from argparse import ArgumentParser

import torch

from audio8_tpu_torch.cli.common import (add_common_model_args, apply_preset,
                                        check_ported, encoder_kwargs,
                                        moe_aux, resolve_restart,
                                        save_on_rank0, shard_kwargs,
                                        start_distributed)
from audio8_tpu_torch.cli.train import _to_device, real_rows_here
from audio8_tpu_torch.config import PooledConfig, TextEncoderConfig
from audio8_tpu_torch.data.datasets import (AudioTextLetterDataset,
                                            PrefetchLoader)
from audio8_tpu_torch.models.dual_encoder import (DualEncoderModel,
                                                  PairedModule,
                                                  SymmetricCLIPLoss)
from audio8_tpu_torch.models.text import (BPEVectorizer, TextVectorizer,
                                          read_vocab_file)
from audio8_tpu_torch.models.warmstart import load_tlm_npz
from audio8_tpu_torch.parallel import shard_state
from audio8_tpu_torch.parallel.sharding import (global_sum_scalars,
                                                sync_from_rank0)
from audio8_tpu_torch.train.checkpoint import save_checkpoint
from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                          create_optimizer)
from audio8_tpu_torch.train.preempt import PreemptionGuard
from audio8_tpu_torch.train.steps import accumulate_grads, make_paired_steps
from audio8_tpu_torch.utils import Average, str2bool

logger = logging.getLogger("audio8_tpu_torch.paired")


def parse_args(argv=None):
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--basedir", type=str)
    parser.add_argument("--root_dir")
    parser.add_argument("--train_dataset", type=str)
    parser.add_argument("--valid_dataset", type=str)
    parser.add_argument("--dataset_key", default="LibriSpeech")
    parser.add_argument("--grad_accum", type=int, default=1)
    parser.add_argument("--num_train_workers", type=int, default=4)
    parser.add_argument("--max_sample_len", type=int)
    parser.add_argument("--lr_scheduler", default="cosine")
    parser.add_argument("--lr_alpha", type=float, default=0.0)
    parser.add_argument("--optim", default="adamw")
    parser.add_argument("--lr", type=float, default=2.0e-5)
    parser.add_argument("--clip", type=float, default=25.0)
    parser.add_argument("--weight_decay", type=float, default=1.0e-2)
    parser.add_argument("--restart_from", type=str,
                        help="a paired .pt to load, or a run's directory "
                             "to resume")
    parser.add_argument("--warmup_steps", type=int, default=10000)
    parser.add_argument("--plateau_steps", type=int, default=0)
    parser.add_argument("--unfreeze_audio_after_step", type=int,
                        default=100_000)
    parser.add_argument("--unfreeze_text_after_step", type=int,
                        default=100_000)
    parser.add_argument("--train_steps", type=int, default=400_000)
    parser.add_argument("--valid_steps", type=int, default=1000)
    parser.add_argument("--steps_per_checkpoint", type=int, default=1000)
    parser.add_argument("--distributed", type=str2bool, default=False,
                        help="data-parallel over the ranks torchrun "
                             "starts, one card each")
    parser.add_argument("--target_tokens_per_batch", type=int,
                        default=700_000)
    parser.add_argument("--target_type", choices=["wrd", "bpe"],
                        default="wrd")
    parser.add_argument("--vocab_file")
    parser.add_argument("--dict_file", default="dict.{}.txt")
    parser.add_argument("--subword_model_file")
    parser.add_argument("--subword_vocab_file")
    parser.add_argument("--warmstart_text", type=str,
                        help="a pretrained transformer LM's .npz (flax-path, "
                             "torch-style or converted HF BERT keys) to "
                             "warm-start the text tower from")
    parser.add_argument("--init_temp", type=float, default=1.0)
    parser.add_argument("--learn_temp", type=str2bool, default=True)
    parser.add_argument("--output_dim", type=int, default=256)
    parser.add_argument("--stacking_layers", type=int, nargs="*",
                        default=[])
    parser.add_argument("--audio_reduction_type", default="max")
    parser.add_argument("--audio_d_k", type=int, default=64)
    parser.add_argument("--text_encoder_type", default="transformer",
                        choices=["transformer", "bow"])
    parser.add_argument("--text_d_model", type=int, default=512)
    parser.add_argument("--text_num_heads", type=int, default=8)
    parser.add_argument("--text_num_layers", type=int, default=8)
    parser.add_argument("--text_d_ff", type=int, default=2048)
    parser.add_argument("--text_rpr_k", type=int, default=8)
    parser.add_argument("--text_reduction_type", default="max")
    parser.add_argument("--text_d_k", type=int, default=64)
    parser.add_argument("--pad_to_multiple", type=int, default=16_000)
    parser.add_argument("--length_buckets", type=int, nargs="*",
                        help="audio-length grid (samples); pads each batch "
                             "up to the next bucket")
    parser.add_argument("--seed", type=int, default=1234,
                        help="seed of the generator that dropout and "
                             "masking draw from")
    add_common_model_args(parser)
    return apply_preset(parser.parse_args(argv))


def build_module(args, vocab_size: int, dtype: torch.dtype) -> PairedModule:
    """The JAX trainer's configs (``--attention_dropout`` inert), the
    model's parameters drawn from a generator seeded 0."""
    audio = PooledConfig(
        sample_rate=args.target_sample_rate // 1000, d_model=args.d_model,
        num_heads=args.num_heads, num_layers=args.num_layers, d_ff=args.d_ff,
        dropout=args.dropout, layer_drop=args.layer_drop,
        reduction_type=args.audio_reduction_type,
        reduction_d_k=args.audio_d_k, **encoder_kwargs(args))
    text = TextEncoderConfig(
        vocab_size=vocab_size, d_model=args.text_d_model,
        num_heads=args.text_num_heads, num_layers=args.text_num_layers,
        d_ff=args.text_d_ff, rpr_k=args.text_rpr_k,
        reduction_type=args.text_reduction_type, reduction_d_k=args.text_d_k,
        encoder_type=args.text_encoder_type)
    model = DualEncoderModel(audio, text, tuple(args.stacking_layers),
                             args.output_dim, dtype)
    model.init_from(torch.Generator().manual_seed(0))
    return PairedModule(model, SymmetricCLIPLoss(args.init_temp,
                                                 args.learn_temp))


def datasets(args, rank: int = 0, world: int = 1):
    """(vocab, train set, valid set) of parsed ``args`` (``dict_file``
    already formatted): BPE pieces with ``--subword_model_file``, else the
    dict's words; row-sharded for rank ``rank`` of ``world``."""
    if args.target_type == "bpe" and args.subword_model_file:
        vec = BPEVectorizer(args.subword_model_file, args.subword_vocab_file,
                            ["<s>"], ["</s>"])
        vocab = vec.vocab
    else:
        vocab = read_vocab_file(args.vocab_file or os.path.join(
            args.root_dir, args.dict_file))
        vec = TextVectorizer(vocab)
    common = dict(input_sample_rate=args.input_sample_rate,
                  target_sample_rate=args.target_sample_rate,
                  tgt_type=args.target_type,
                  pad_to_multiple=args.pad_to_multiple,
                  length_grid=args.length_buckets)
    train_set = AudioTextLetterDataset(
        os.path.join(args.root_dir, args.train_dataset), vec,
        args.target_tokens_per_batch, args.max_sample_len, shuffle=True,
        **common, **shard_kwargs(rank, world))
    valid_set = AudioTextLetterDataset(
        os.path.join(args.root_dir, args.valid_dataset), vec,
        args.target_tokens_per_batch, args.max_sample_len, shuffle=False,
        is_infinite=False, **common, **shard_kwargs(rank, world))
    return vocab, train_set, valid_set


def train(argv=None):
    """Run the trainer; returns the :class:`TrainState`, whose ``log``
    lists each optimizer step's wall seconds, audio seconds, loss,
    ``clip_accuracy``, ``logit_scale`` and frozen flags, and ``valid``
    each validation's loss and accuracy, and ``warmstart`` the
    ``--warmstart_text`` report (``None`` without it)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    check_ported(args, "pretrain_paired")
    device, rank, world, group = start_distributed(args)
    preempt = PreemptionGuard(group)  # catch SIGTERM from here on
    try:
        return _train(args, device, preempt, rank, world, group)
    finally:
        preempt.close()


def _train(args, device: torch.device, preempt: PreemptionGuard,
           rank: int = 0, world: int = 1, group=None):
    args.dict_file = args.dict_file.format(args.target_type)
    if args.basedir is None:
        args.basedir = f"paired-{args.dataset_key}-{os.getpid()}"
    os.makedirs(args.basedir, exist_ok=True)
    if device.type == "cuda" and not args.bf16:
        # float32 means float32: no TF32 in cuBLAS or cuDNN
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    vocab, train_set, valid_set = datasets(args, rank, world)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    module = build_module(args, len(vocab), dtype).to(device)
    warmstart = None
    if args.warmstart_text:
        warmstart = load_tlm_npz(module.model.text_encoder,
                                 args.warmstart_text)
        logger.info("warmstart_text: loaded=%d unexpected=%s",
                    len(warmstart["loaded"]), warmstart["unexpected"][:5])
    lr_sched = create_lrs(args.lr, args.train_steps, args.lr_scheduler,
                          alpha=args.lr_alpha, warmup_steps=args.warmup_steps,
                          plateau_steps=args.plateau_steps)
    state = TrainState(module, create_optimizer(lr_sched, args.optim,
                                                args.weight_decay))
    resolve_restart(args.restart_from, state, ctc=False, kind="paired")
    if group is not None:
        sync_from_rank0(module, group)
    state.log, state.valid, state.warmstart = [], [], warmstart
    n_params = sum(p.numel() for p in module.parameters())
    logger.info("Model has %s parameters on %s", f"{n_params:,}", device)

    # ZeRO-1 / FSDP: the whole state restored and broadcast, now
    # sharded (nothing without a group or at one rank)
    shard_state(state, group, zero1=args.zero1, fsdp=args.fsdp)
    grad_fn, update_fn, eval_fn = make_paired_steps(module, clip=args.clip,
                                                    group=group)
    validate_on = min(args.train_steps // 2, args.steps_per_checkpoint)
    report_on = max(10, args.steps_per_checkpoint) // 10
    model_base = os.path.join(args.basedir, "checkpoint")
    sr = args.target_sample_rate
    train_itr = iter(PrefetchLoader(train_set,
                                    num_workers=args.num_train_workers,
                                    prefetch=4))
    avg_loss = Average("average_train_loss")
    step_time = Average("average_step_time")
    generator = torch.Generator().manual_seed(args.seed)
    acc_grads, acc_examples, acc_audio = None, 0.0, 0.0
    iters, gstep = 0, state.step
    start = time.time()
    while gstep < args.train_steps:
        flags = dict(freeze_audio=gstep <= args.unfreeze_audio_after_step,
                     freeze_text=gstep <= args.unfreeze_text_after_step)
        iters += 1
        batch = next(train_itr)
        loss, metrics, grads, _, _ = grad_fn(_to_device(batch, device),
                                             generator, **flags)
        acc_grads = accumulate_grads(acc_grads, grads)
        acc_examples += real_rows_here(batch)
        acc_audio += float(batch["signal_lengths"].sum()) / sr
        if iters % args.grad_accum:
            continue
        update_fn(state, acc_grads, acc_examples)
        acc_audio, = global_sum_scalars([acc_audio], group).tolist()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        elapsed = time.time() - start
        avg_loss.update(float(loss))
        state.log.append({"step": gstep + 1, "seconds": elapsed,
                          "audio_s": acc_audio, "loss": float(loss),
                          "clip_accuracy": float(metrics["clip_accuracy"]),
                          "logit_scale": float(metrics["logit_scale"]),
                          "rows": int(batch["signal"].shape[0]) * world,
                          **flags,
                          **moe_aux(metrics)})
        acc_grads, acc_examples, acc_audio = None, 0.0, 0.0
        gstep += 1
        step_time.update(elapsed)
        start = time.time()
        if gstep % report_on == 0 and step_time.avg:
            logger.info("%s, steps/min %.2f, LR %.6f, acc %.3f, T %.3f",
                        avg_loss, 60.0 / step_time.avg, state.current_lr,
                        float(metrics["clip_accuracy"]),
                        float(metrics["logit_scale"]))
        if gstep % validate_on == 0:
            vm = validate(eval_fn, valid_set, args.valid_steps, device)
            state.valid.append(vm)
            logger.info(vm)
            save_on_rank0(group, save_checkpoint, state,
                          f"{model_base}-step-{gstep}.pt", "paired")
            start = time.time()
        if preempt.should_save(gstep):
            save_on_rank0(group, save_checkpoint, state,
                          f"{model_base}-step-{gstep}.pt", "paired")
            logger.warning("preempted: saved step %d, exiting", gstep)
            break
    train_itr.close()  # stops the prefetch threads
    return state


def validate(eval_fn, valid_set, valid_steps, device) -> dict:
    """Average loss and ``clip_accuracy`` over up to ``valid_steps`` + 1
    batches."""
    avg_valid = Average("average_valid_loss")
    accs = Average("valid_accuracy")
    for j, batch in enumerate(iter(valid_set)):
        if j > valid_steps:
            break
        loss, metrics = eval_fn(_to_device(batch, device))
        avg_valid.update(float(loss))
        accs.update(float(metrics["clip_accuracy"]))
    return {"average_valid_loss": avg_valid.avg,
            "valid_accuracy": accs.avg}


def main():
    train()


if __name__ == "__main__":
    main()
