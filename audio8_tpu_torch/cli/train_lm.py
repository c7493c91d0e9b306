"""Causal text-LM training entry point of the port (``a8t-train-lm`` on
PyTorch), for n-best rescoring of CTC and RNN-T output.

Counterpart of ``audio8_tpu/cli/train_lm.py``: a small decoder-only
transformer (``models/text.py:CausalTextLM``) trained on the transcript
files the CTC recipes use, whose basedir ``cli.test --lm_rescore`` then
reads. Lines pack into ``(B, block_len + 1)`` token blocks (EOS-separated,
the stream opened by GO, :func:`pack_token_stream`); each step draws its
rows from ``numpy.random.RandomState(seed + 1)`` as the JAX trainer
does, runs the token-mean NLL with dropout on kernel 4, clips and steps
AdamW on kernel 5 (``train/steps.py:make_lm_steps``). It validates on
``--valid_text`` and saves an ``lm`` checkpoint with its resume file at
every ``--steps_per_checkpoint`` and at the last step
(``train/checkpoint.py``); on SIGTERM it saves at the next step and exits
0. ``lm_config.json`` (the config and the absolute ``--dict_file``) lets
the rescorer configure itself from the basedir.

  python -m audio8_tpu_torch.cli.train_lm --text train.ltr \\
      --valid_text valid.ltr --dict_file dict.ltr.txt --basedir runs/lm

The flags are the JAX trainer's with the same defaults, plus
``--device`` (the CUDA card by default; it raises without one) and
``--restart_from`` (a run's directory or one of its ``.pt`` files: the
weights, and with the resume file beside it the AdamW moments and the
step; the block draws of the steps already taken are replayed, the
dropout seeds are drawn afresh). ``--distributed true`` under
``torchrun`` trains data-parallel as the JAX entry point does
(``parallel/sharding.py``): every rank draws ``batch_size // world``
blocks from the same seeded ``RandomState`` (so, as in JAX, each rank
holds the same blocks and the global batch holds each of them once per
rank), the loss is the token mean over the global batch, and rank 0
alone writes checkpoints.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from argparse import ArgumentParser

import numpy as np
import torch

from audio8_tpu_torch.cli.common import (restore_full_state, save_on_rank0,
                                        start_distributed)
from audio8_tpu_torch.config import TextLMConfig
from audio8_tpu_torch.models.text import (CausalTextLM, TextVectorizer,
                                          read_vocab_list)
from audio8_tpu_torch.parallel.sharding import sync_from_rank0
from audio8_tpu_torch.train.checkpoint import (find_latest_checkpoint,
                                               load_model_weights,
                                               load_resume,
                                               parse_checkpoint_step,
                                               save_checkpoint)
from audio8_tpu_torch.train.orbax import is_orbax_dir, load_checkpoint
from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                          create_optimizer)
from audio8_tpu_torch.train.preempt import PreemptionGuard
from audio8_tpu_torch.train.steps import make_lm_steps
from audio8_tpu_torch.utils import Average, Offsets, str2bool

logger = logging.getLogger("audio8_tpu_torch.train_lm")


def pack_token_stream(files, vec, block_len: int, seed: int = 0,
                      shuffle: bool = True) -> np.ndarray:
    """Whitespace-token lines -> ``(N, block_len + 1)`` int32 blocks.

    The lines are shuffled by ``RandomState(seed)``; each ends with EOS
    and the stream starts with GO (the scoring convention,
    ``CausalTextLM.sequence_logp``). The stream is cut into blocks that
    overlap by one token, so every token is a target exactly once; the
    last partial block pads with PAD (masked in the loss)."""
    lines: list = []
    for path in files:
        with open(path) as f:
            lines.extend(line.split() for line in f if line.strip())
    if shuffle:
        np.random.RandomState(seed).shuffle(lines)
    ids = [Offsets.GO]
    for toks in lines:
        ids.extend(int(i) for i in vec.run(toks))
        ids.append(Offsets.EOS)
    n_blocks = max((len(ids) - 1 + block_len - 1) // block_len, 1)
    out = np.full((n_blocks, block_len + 1), Offsets.PAD, np.int32)
    for b in range(n_blocks):
        chunk = ids[b * block_len: b * block_len + block_len + 1]
        out[b, :len(chunk)] = chunk
    return out


def parse_args(argv=None):
    p = ArgumentParser(description=__doc__)
    p.add_argument("--basedir", type=str)
    p.add_argument("--text", nargs="+", required=True,
                   help=".ltr/.wrd/.bpe transcript files (whitespace tokens)")
    p.add_argument("--valid_text", nargs="+", default=[])
    p.add_argument("--dict_file", required=True)
    p.add_argument("--d_model", type=int, default=512)
    p.add_argument("--num_heads", type=int, default=8)
    p.add_argument("--num_layers", type=int, default=6)
    p.add_argument("--d_ff", type=int, default=2048)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--rpr_k", type=int, default=8)
    p.add_argument("--block_len", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=3.0e-4)
    p.add_argument("--lr_scheduler", default="cosine")
    p.add_argument("--warmup_steps", type=int, default=1000)
    p.add_argument("--clip", type=float, default=1.0)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--train_steps", type=int, default=50_000)
    p.add_argument("--steps_per_checkpoint", type=int, default=2000)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--distributed", type=str2bool, default=False,
                   help="not ported yet")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--restart_from",
                   help="a run's directory (its latest checkpoint) or an "
                        "LM .pt: resume from it")
    p.add_argument("--device", default="cuda",
                   help="cuda[:N] (default; raises without a card) or cpu")
    return p.parse_args(argv)


def validate(eval_fn, valid_blocks: np.ndarray, batch: int,
             device: torch.device, rank: int = 0) -> dict:
    """Token-mean NLL and perplexity over the validation blocks (every
    rank scores the same ``batch`` blocks a step, as in JAX; the mean is
    the global batch's)."""
    nll, ntok = 0.0, 0.0
    for i0 in range(0, len(valid_blocks), batch):
        ids = torch.from_numpy(valid_blocks[i0:i0 + batch]).to(device)
        loss, n = eval_fn({"ids": ids, "row_offset": rank * batch})
        nll += float(loss) * float(n)
        ntok += float(n)
    mean = nll / max(ntok, 1)
    return {"valid_nll": mean, "valid_ppl": float(np.exp(min(mean, 20.0)))}


def train(argv=None):
    """Run the trainer; returns the :class:`TrainState`, whose ``log``
    lists each step's loss, gradient norm, tokens and wall seconds, and
    ``valid`` each validation's metrics."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    device, rank, world, group = start_distributed(args)
    preempt = PreemptionGuard(group)  # catch SIGTERM from here on
    try:
        return _train(args, device, preempt, rank, world, group)
    finally:
        preempt.close()


def _train(args, device: torch.device, preempt: PreemptionGuard,
           rank: int = 0, world: int = 1, group=None):
    if args.basedir is None:
        args.basedir = f"textlm-{os.getpid()}"
    os.makedirs(args.basedir, exist_ok=True)
    if device.type == "cuda" and not args.bf16:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    vocab_list = read_vocab_list(args.dict_file)
    vec = TextVectorizer({v: i for i, v in enumerate(vocab_list)})
    cfg = TextLMConfig(vocab_size=len(vocab_list), d_model=args.d_model,
                       num_heads=args.num_heads, num_layers=args.num_layers,
                       d_ff=args.d_ff, dropout=args.dropout,
                       rpr_k=args.rpr_k, block_len=args.block_len)
    # the rescorer configures itself from this sidecar
    with open(os.path.join(args.basedir, "lm_config.json"), "w") as f:
        json.dump(dict(dataclasses.asdict(cfg),
                       dict_file=os.path.abspath(args.dict_file)), f)

    blocks = pack_token_stream(args.text, vec, args.block_len, args.seed)
    valid_blocks = (pack_token_stream(args.valid_text, vec, args.block_len,
                                      shuffle=False)
                    if args.valid_text else None)
    logger.info("packed %d train blocks of %d tokens (%s)", len(blocks),
                args.block_len, [os.path.basename(t) for t in args.text])

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = CausalTextLM(cfg, dtype,
                         generator=torch.Generator().manual_seed(0))
    model = model.to(device)
    state = TrainState(model, create_optimizer(
        create_lrs(args.lr, args.train_steps, args.lr_scheduler,
                   warmup_steps=args.warmup_steps),
        weight_decay=args.weight_decay))
    if args.restart_from:
        restore(state, args.restart_from)
    if group is not None:
        sync_from_rank0(model, group)
    state.log, state.valid = [], []
    logger.info("LM has %s parameters on %s",
                f"{sum(p.numel() for p in model.parameters()):,}", device)

    train_step, eval_fn = make_lm_steps(model, clip=args.clip, group=group)
    model_base = os.path.join(args.basedir, "checkpoint")
    avg_loss = Average("average_train_loss")
    generator = torch.Generator().manual_seed(args.seed)
    perm = np.random.RandomState(args.seed + 1)
    b = max(args.batch_size // world, 1)  # this rank's blocks, as in JAX
    gstep = state.step
    for _ in range(gstep):  # the block draws of the steps already taken
        perm.randint(0, len(blocks), size=b)
    report_on = max(args.steps_per_checkpoint // 10, 10)
    start = time.time()
    while gstep < args.train_steps:
        t0 = time.time()
        rows = perm.randint(0, len(blocks), size=b)
        ids = torch.from_numpy(blocks[rows]).to(device)
        state, metrics = train_step(state, {"ids": ids,
                                            "row_offset": rank * b},
                                    generator)
        loss = float(metrics["loss"])
        gstep += 1
        state.log.append({"step": gstep, "loss": loss,
                          "grad_norm": float(metrics["grad_norm"]),
                          "tokens": float(metrics["tokens"]),
                          "seconds": time.time() - t0})
        if gstep % 8 == 0:
            avg_loss.update(loss, n=8)
        if gstep % report_on == 0 and avg_loss.avg:
            logger.info("%s (ppl %.2f), steps/min %.1f", avg_loss,
                        float(np.exp(min(avg_loss.avg, 20.0))),
                        60 * gstep / (time.time() - start))
        if gstep % args.steps_per_checkpoint == 0 \
                or gstep == args.train_steps:
            if valid_blocks is not None:
                vm = dict(validate(eval_fn, valid_blocks, b, device, rank),
                          step=gstep)
                state.valid.append(vm)
                logger.info(vm)
            save_on_rank0(group, save_checkpoint, state,
                          f"{model_base}-step-{gstep}.pt", "lm")
        if preempt.should_save(gstep):
            save_on_rank0(group, save_checkpoint, state,
                          f"{model_base}-step-{gstep}.pt", "lm")
            logger.warning("preempted: saved step %d, exiting", gstep)
            break
    return state


def restore(state: TrainState, restart_from: str) -> None:
    """Load an LM checkpoint (``restart_from``, or the latest under it)
    into ``state.model``: the port's ``.pt`` with its resume file's
    optimizer state and step when it has one, or the JAX package's Orbax
    directory, its full state when it is one of this ``--optim``
    (``cli/common.py:restore_full_state``), else its params at the step
    of its name."""
    path = (find_latest_checkpoint(restart_from)[0]
            if os.path.isdir(restart_from) and not is_orbax_dir(restart_from)
            else restart_from)
    if is_orbax_dir(path):
        tree = load_checkpoint(path)
        step = restore_full_state(tree, state)
        if step is None:
            load_model_weights(path, state.model, "lm")
            step = state.step = state.opt_state.count = \
                parse_checkpoint_step(path)
    else:
        load_model_weights(path, state.model, "lm")
        step = load_resume(state, path, "lm")
    logger.info("restarted from %s at step %s", path, step or 0)


def main():
    train()


if __name__ == "__main__":
    main()
