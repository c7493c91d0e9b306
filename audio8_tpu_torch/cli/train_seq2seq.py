"""Seq2seq ASR training entry point of the port (``a8t-train-seq2seq`` on
PyTorch).

Counterpart of ``audio8_tpu/cli/train_seq2seq.py``: a wav2vec2 encoder
and a small transformer decoder with learned-positional tied embeddings
(``models/seq2seq.py``), teacher forcing with the summed sequence loss,
gradient accumulation (``--grad_accum 2``), the summed gradient scaled by
the example count, global-norm clipping, warmup + decay LR, the encoder
frozen up to ``--unfreeze_enc_after_step``, and periodic validation:
the teacher-forced loss and WER/CER of the KV-cached greedy decode, or
of the beam search with ``--valid_beam``. It runs on ``--device`` (the
CUDA card by default; it raises without one), through the attention,
dropout and AdamW kernels and the conv forward (with ``--freeze_fx
false`` the conv backward too); the decoder's attention is the torch
composition (``nn/transformer.py``).

  python -m audio8_tpu_torch.cli.train_seq2seq --root_dir corpus \\
      --train_dataset train.tsv --valid_dataset valid.tsv --basedir run

Checkpoints are the port's seq2seq ``.pt`` files with a resume file
beside each (``train/checkpoint.py``). ``--restart_from`` warm-starts the
encoder from a fairseq ``.pt`` (pretrained or CTC, e.g. ``cli.pretrain``'s
checkpoints), loads a seq2seq ``.pt`` at step 0, or resumes a run from
its directory (``cli/common.py:resolve_restart``); on SIGTERM the
trainer saves at the next step boundary and exits 0. ``--speed_perturb``
and ``--noise_manifest`` augment the training utterances, ``--remat``
recomputes each encoder layer in the backward on its replayed dropout
seeds, ``--optim sgd`` steps plain SGD. The flags are the JAX trainer's
(``--attention_dropout`` is inert there and here); those of parts not
ported yet raise: parallelism and ``--distributed``. ``--lane_align``
(TPU tiling) is not a flag here.
"""
from __future__ import annotations

import logging
import os
import time
from argparse import ArgumentParser

import torch

from audio8_tpu_torch.cli.common import (add_augmentation_args,
                                        add_common_model_args, apply_preset,
                                        check_ported, encoder_kwargs,
                                        resolve_device, resolve_restart,
                                        train_augmentation)
from audio8_tpu_torch.cli.train import _to_device
from audio8_tpu_torch.config import DecoderConfig, EncoderConfig
from audio8_tpu_torch.data.datasets import (AudioTextLetterDataset,
                                            PrefetchLoader)
from audio8_tpu_torch.models.seq2seq import Seq2Seq
from audio8_tpu_torch.models.text import TextVectorizer, read_vocab_file
from audio8_tpu_torch.ops import metrics as M
from audio8_tpu_torch.train.checkpoint import save_checkpoint
from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                          create_optimizer)
from audio8_tpu_torch.train.preempt import PreemptionGuard
from audio8_tpu_torch.train.steps import accumulate_grads, make_seq2seq_steps
from audio8_tpu_torch.utils import Average, Offsets, revlut, str2bool

logger = logging.getLogger("audio8_tpu_torch.seq2seq")


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
                        choices=["sum", "token"])
    parser.add_argument("--decoder_dropout", type=float, default=0.1)
    parser.add_argument("--decoder_layers", type=int, default=2)
    parser.add_argument("--decoder_heads", type=int, default=4)
    parser.add_argument("--num_train_workers", type=int, default=4)
    parser.add_argument("--max_sample_len", type=int)
    parser.add_argument("--lr_scheduler", default="cosine")
    parser.add_argument("--lr_alpha", type=float, default=0.0)
    parser.add_argument("--optim", default="adamw")
    parser.add_argument("--lr", type=float, default=1.0e-4)
    parser.add_argument("--clip", type=float, default=25.0)
    parser.add_argument("--weight_decay", type=float, default=0.0)
    parser.add_argument("--restart_tt", choices=["step", "ignore"])
    parser.add_argument("--restart_from", type=str,
                        help="fairseq .pt to warm-start the encoder from, "
                             "a seq2seq .pt, or a run's directory to "
                             "resume")
    parser.add_argument("--warmup_steps", type=int, default=10000)
    parser.add_argument("--plateau_steps", type=int, default=0)
    parser.add_argument("--unfreeze_enc_after_step", type=int, default=10_000)
    parser.add_argument("--timestep_masking", type=float, default=0.5)
    parser.add_argument("--timestep_mask_len", type=int, default=10)
    parser.add_argument("--channel_masking", type=float, default=0.1)
    parser.add_argument("--channel_mask_len", type=int, default=64)
    parser.add_argument("--train_steps", type=int, default=320_000)
    parser.add_argument("--valid_steps", type=int, default=1000)
    parser.add_argument("--valid_beam", type=int, default=1,
                        help="beam width of the validation decode (1: "
                             "greedy)")
    parser.add_argument("--steps_per_checkpoint", type=int, default=2400)
    parser.add_argument("--verbose", type=str2bool, default=False)
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
    parser.add_argument("--seed", type=int, default=1234,
                        help="seed of the generator that dropout and "
                             "masking draw from")
    add_common_model_args(parser)
    return apply_preset(parser.parse_args(argv))


def build_model(args, vocab_size: int, dtype: torch.dtype) -> Seq2Seq:
    """The JAX trainer's configs (``--attention_dropout`` inert), the
    parameters drawn from a generator seeded 0."""
    enc = EncoderConfig(
        sample_rate=args.target_sample_rate // 1000, d_model=args.d_model,
        num_heads=args.num_heads, num_layers=args.num_layers, d_ff=args.d_ff,
        dropout=args.dropout, timestep_masking=args.timestep_masking,
        timestep_mask_len=args.timestep_mask_len,
        channel_masking=args.channel_masking,
        channel_mask_len=args.channel_mask_len, layer_drop=args.layer_drop,
        freeze_fx=args.freeze_fx, **encoder_kwargs(args))
    dec = DecoderConfig(vocab_size=vocab_size, d_model=args.d_model,
                        num_heads=args.decoder_heads,
                        num_layers=args.decoder_layers,
                        dropout=args.decoder_dropout)
    return Seq2Seq(enc, dec, dtype, generator=torch.Generator().manual_seed(0))


def datasets(args):
    """(vocab, train set, valid set) of parsed ``args`` (``dict_file``
    already formatted), with the specials remapped to fairseq's and GO
    and EOS emitted around every target."""
    Offsets.remap_fairseq_ctc()
    vocab = read_vocab_file(args.vocab_file or os.path.join(
        args.root_dir, args.dict_file))
    vec = TextVectorizer(vocab, ["<s>"], ["</s>"])
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
    return vocab, train_set, valid_set


def train(argv=None):
    """Run the trainer; returns the :class:`TrainState`, whose ``log``
    lists each optimizer step's wall seconds, audio seconds, loss and
    frozen flag, and ``valid`` each validation's metrics."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    device = resolve_device(args.device)
    check_ported(args, "train_seq2seq")
    preempt = PreemptionGuard()  # catch SIGTERM from here on
    try:
        return _train(args, device, preempt)
    finally:
        preempt.close()


def _train(args, device: torch.device, preempt: PreemptionGuard):
    args.dict_file = args.dict_file.format(args.target_type)
    if args.basedir is None:
        args.basedir = f"wav2vec2-s2s-{args.dataset_key}-{os.getpid()}"
    os.makedirs(args.basedir, exist_ok=True)
    if device.type == "cuda" and not args.bf16:
        # float32 means float32: no TF32 in cuBLAS or cuDNN
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    vocab, train_set, valid_set = datasets(args)
    index2vocab = revlut(vocab)
    postproc = (M.postproc_bpe if args.target_type == "bpe"
                else M.postproc_letters)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = build_model(args, len(vocab), dtype).to(device)
    lr_sched = create_lrs(args.lr, args.train_steps, args.lr_scheduler,
                          alpha=args.lr_alpha, warmup_steps=args.warmup_steps,
                          plateau_steps=args.plateau_steps)
    state = TrainState(model, create_optimizer(lr_sched, args.optim,
                                               args.weight_decay))
    resolve_restart(args.restart_from, state, ctc=True,
                    restart_tt=args.restart_tt, kind="seq2seq")
    state.log, state.valid = [], []
    n_params = sum(p.numel() for p in model.parameters())
    logger.info("Model has %s parameters on %s", f"{n_params:,}", device)

    grad_fn, update_fn, decode_fn, eval_loss_fn = make_seq2seq_steps(
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
    best_metric = 1e8
    generator = torch.Generator().manual_seed(args.seed)
    acc_grads, acc_examples, acc_audio = None, 0.0, 0.0
    iters, gstep = 0, state.step
    start = time.time()
    while gstep < args.train_steps:
        freeze = gstep <= args.unfreeze_enc_after_step
        iters += 1
        batch = next(train_itr)
        loss, grads, _, _ = grad_fn(_to_device(batch, device), generator,
                                    freeze=freeze)
        acc_grads = accumulate_grads(acc_grads, grads)
        acc_examples += batch["num_real"]
        acc_audio += float(batch["signal_lengths"].sum()) / sr
        if iters % args.grad_accum:
            continue
        update_fn(state, acc_grads, acc_examples)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        elapsed = time.time() - start
        avg_loss.update(float(loss))
        state.log.append({"step": gstep + 1, "seconds": elapsed,
                          "audio_s": acc_audio, "loss": float(loss),
                          "frozen": freeze})
        acc_grads, acc_examples, acc_audio = None, 0.0, 0.0
        gstep += 1
        step_time.update(elapsed)
        start = time.time()
        if gstep % report_on == 0 and step_time.avg:
            logger.info("%s, steps/min %.2f, LR %.6f", avg_loss,
                        60.0 / step_time.avg, state.current_lr)
        if gstep % validate_on == 0:
            vm = validate(decode_fn, eval_loss_fn, valid_set, index2vocab,
                          args.valid_steps, postproc, device,
                          beam=args.valid_beam, verbose=args.verbose)
            state.valid.append(vm)
            logger.info({"average_train_loss": avg_loss.avg})
            logger.info(vm)
            save_checkpoint(state, f"{model_base}-step-{gstep}.pt",
                            "seq2seq")
            esm = args.early_stopping_metric
            if esm and vm.get(esm, 1e9) < best_metric:
                best_metric = vm[esm]
                save_checkpoint(state, f"{model_base}-best.pt", "seq2seq")
            start = time.time()
        if preempt.should_save(gstep):
            save_checkpoint(state, f"{model_base}-step-{gstep}.pt", "seq2seq")
            logger.warning("preempted: saved step %d, exiting", gstep)
            break
    train_itr.close()  # stops the prefetch threads
    return state


def validate(decode_fn, eval_loss_fn, valid_set, index2vocab, valid_steps,
             postproc, device, beam: int = 1, verbose: bool = False) -> dict:
    """Teacher-forced loss and WER/CER of the decode (greedy, or a beam
    of ``beam``) over up to ``valid_steps`` + 1 batches; the decode
    horizon is the batch's text width rounded up to 32, as in JAX.
    ``decode_seconds`` and ``utterances`` time the decodes."""
    avg_valid_loss = Average("average_valid_loss")
    c_errors = c_total = w_errors = w_total = utts = 0
    decode_seconds = 0.0
    for j, batch in enumerate(iter(valid_set)):
        if j > valid_steps:
            break
        tbatch = _to_device(batch, device)
        avg_valid_loss.update(float(eval_loss_fn(tbatch)))
        max_len = (int(batch["token_ids"].shape[1]) + 31) // 32 * 32
        t0 = time.perf_counter()
        toks, _ = decode_fn(tbatch, max_output_len=max_len, beam=beam)
        toks = toks.cpu().numpy()
        decode_seconds += time.perf_counter() - t0
        n_real = batch["num_real"]
        utts += n_real
        decoded = [[t for t in row.tolist()
                    if t not in (Offsets.PAD, Offsets.EOS)]
                   for row in toks[:n_real]]
        sm = M.decode_metrics(decoded, batch["token_ids"][:n_real, 1:],
                              index2vocab, postproc_fn=postproc)
        if verbose:
            for sent, gold in zip(decoded, batch["token_ids"][:n_real]):
                print("Pred: ", postproc(index2vocab[t] for t in sent
                                         if t > Offsets.UNK))
                print("Gold: ", postproc(index2vocab[int(t)] for t in gold
                                         if int(t) > Offsets.UNK))
        c_errors += sm["c_errors"]
        w_errors += sm["w_errors"]
        c_total += sm["c_total"]
        w_total += sm["w_total"]
    return {"average_valid_loss": avg_valid_loss.avg,
            "cer": (c_errors / max(c_total, 1)) * 100,
            "wer": (w_errors / max(w_total, 1)) * 100,
            "beam": beam, "decode_seconds": decode_seconds,
            "utterances": utts}


def main():
    train()


if __name__ == "__main__":
    main()
