"""Offline evaluation entry point of the port (``a8t-test`` on PyTorch).

Counterpart of ``audio8_tpu/cli/test.py`` on its CTC path: load a
fairseq-layout CTC checkpoint or an HF ``save_pretrained`` directory
(``--checkpoint``, or the latest ``checkpoint-step-N.pt`` under
``--basedir``), stream the validation
manifest through the acoustic model on ``--device`` (the CUDA card by
default; it raises without one), and accumulate greedy CER and WER; with
``--beam`` above 1 or ``--lm`` also the prefix-beam-search WER, with LM
fusion at ``--alpha`` and ``--beta`` (key ``werr_lm_{beam}`` or
``werr_{beam}``), decoded on the host by the port's native library.

  python -m audio8_tpu_torch.cli.test --root_dir corpus \\
      --valid_dataset dev-other.tsv --basedir run --beam 8 --lm lm.arpa

The flags are the JAX entry point's with the same defaults, plus
``--device``; ``--lane_align`` (TPU tiling) is not a flag here.
``--quantize int8`` runs the Dense layers on int8 weights, quantized
after the load (``ops/quant.py``). ``--exported`` scores a ``cli.export``
artifact instead, the batches padded to its entry table (so its scores
equal the live model's at that ``--length_buckets`` grid). Those of
parts not ported yet raise: ``--transducer``, ``--device_beam`` and
``--lm_rescore`` (ROADMAP.md queue 1, item 7). The returned metrics
also carry the eval's audio seconds and wall seconds and the beam
decode's host seconds.
"""
from __future__ import annotations

import logging
import os
import time
from argparse import ArgumentParser

import torch

from audio8_tpu_torch.cli.common import (add_common_model_args,
                                        apply_preset, check_ported,
                                        encoder_kwargs, load_weights,
                                        resolve_device)
from audio8_tpu_torch.config import AcousticConfig
from audio8_tpu_torch.data.datasets import (AudioTextLetterDataset,
                                            PrefetchLoader)
from audio8_tpu_torch.models.text import TextVectorizer, read_vocab_list
from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
from audio8_tpu_torch.ops import metrics as M
from audio8_tpu_torch.ops.beam import PrefixBeamSearch
from audio8_tpu_torch.ops.ctc import greedy_collapse
from audio8_tpu_torch.ops.quant import quantize_model_params
from audio8_tpu_torch.train.checkpoint import find_latest_checkpoint
from audio8_tpu_torch.utils import Offsets, revlut, str2bool

logger = logging.getLogger("audio8_tpu_torch.test")


def parse_args(argv=None):
    parser = ArgumentParser(description=__doc__)
    add = parser.add_argument
    add("--basedir", type=str)
    add("--root_dir")
    add("--checkpoint")
    add("--exported", help="cli.export CTC artifact directory: score its "
        "traced forward instead of building the model (its length grid "
        "pinned to the entry table)")
    add("--valid_dataset", type=str, help="e.g. dev-other.tsv")
    add("--dict_file", type=str, default="dict.ltr.txt")
    add("--max_sample_len", type=int, default=325_000)
    add("--verbose", type=str2bool, default=False,
        help="print each beam transcript")
    add("--valid_steps", type=int, default=40_000)
    add("--steps_per_update", type=int, default=100)
    add("--vocab_file")
    add("--target_tokens_per_batch", type=int, default=700_000)
    add("--target_type", choices=["wrd", "ltr", "bpe"], default="ltr")
    add("--lm", help="ARPA (plain or gzipped) or KenLM binary LM")
    add("--beam", type=int, default=1)
    add("--transducer", type=str2bool, default=False,
        help="not ported yet")
    add("--pred_layers", type=int, default=2)
    add("--pred_dim", type=int, default=512)
    add("--pred_embed_dim", type=int, default=256)
    add("--d_joint", type=int, default=512)
    add("--max_decode_len", type=int, default=200)
    add("--max_symbols_per_frame", type=int, default=4)
    add("--device_beam", type=str2bool, default=False, help="not ported yet")
    add("--quantize", choices=["none", "int8"], default="none",
        help="int8: post-training weight quantization of the Dense "
             "layers (ops/quant.py)")
    add("--alpha", type=float, default=0.7)
    add("--beta", type=float, default=5.0)
    add("--lm_rescore", help="not ported yet")
    add("--rescore_alpha", type=float, default=0.5,
        help="inert without --lm_rescore")
    add("--rescore_word_bonus", type=float, default=0.0,
        help="inert without --lm_rescore")
    add("--pad_to_multiple", type=int, default=16_000)
    add("--length_buckets", type=int, nargs="*",
        help="audio-length grid (samples); pads each batch up to the next "
             "bucket")
    add_common_model_args(parser)
    return apply_preset(parser.parse_args(argv))


def run_step(index2vocab, log_probs, frame_lengths, batch, verbose=False,
             ctc_decoder=None, postproc_fn=M.postproc_letters):
    """Greedy metrics of one batch of host log-probs and, with a
    ``ctc_decoder``, its beam word errors (``wbeam_errors``) and
    transcripts (``beam_texts``)."""
    step_metrics = M.ctc_metrics(log_probs, batch["token_ids"],
                                 frame_lengths, index2vocab,
                                 postproc_fn=postproc_fn)
    step_metrics["wbeam_errors"] = 0
    step_metrics["beam_texts"] = []
    if ctc_decoder is not None:
        for b, transcription in enumerate(
                ctc_decoder.run(log_probs, frame_lengths, n_best=1)):
            text = "".join(transcription)
            if verbose:
                print(text)
            werr, _ = M.decode_text_wer(text, batch["token_ids"][b],
                                        index2vocab, postproc_fn=postproc_fn)
            step_metrics["wbeam_errors"] += werr
            step_metrics["beam_texts"].append(text)
    return step_metrics


def _live_forward(args, num_labels: int, device: torch.device):
    """The checkpoint's model (``--checkpoint``, else the latest under
    ``--basedir``) on ``device`` as ``forward(signal, lengths) ->
    (log_probs, frames)``; Dense layers int8 under ``--quantize int8``,
    quantized after the load."""
    cfg = AcousticConfig(
        num_labels=num_labels, sample_rate=args.target_sample_rate // 1000,
        d_model=args.d_model, num_heads=args.num_heads,
        num_layers=args.num_layers, d_ff=args.d_ff, dropout=args.dropout,
        timestep_masking=0.0, channel_masking=0.0, **encoder_kwargs(args))
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = Wav2Vec2AcousticModel(cfg, dtype).to(device)
    checkpoint = (args.checkpoint
                  or find_latest_checkpoint(args.basedir)[0])
    load_weights(checkpoint, model, ctc=True)
    if args.quantize == "int8":
        quantize_model_params(model)

    @torch.no_grad()
    def forward(signal: torch.Tensor, lengths: torch.Tensor):
        log_probs, pad_mask = model(signal, lengths)
        return log_probs, pad_mask.sum(dim=-1)

    return forward


def evaluate(argv=None, keep_outputs: bool = False) -> dict:
    """Run the evaluation; returns ``cer``, ``wer``, the beam key when
    decoding with a beam or LM, ``step`` (batches scored), and
    ``utterances``, ``audio_seconds``, ``eval_seconds`` (wall, data
    included), ``beam_seconds`` (host beam decode) and, with ``--lm``,
    ``lm_load_seconds``. With ``keep_outputs`` also ``outputs``: per
    utterance scored, in order, its file, its (frames, labels) float32
    log-probs, its greedy transcript and, with a beam or an LM, its beam
    transcript."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    device = resolve_device(args.device)
    check_ported(args, "test")
    Offsets.remap_fairseq_ctc()
    if device.type == "cuda" and not args.bf16:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    artifact = None
    if args.exported:
        from audio8_tpu_torch.export import load_artifact

        if args.quantize != "none":
            raise ValueError("--exported eval scores the artifact as "
                             "written: --quantize is baked at export time")
        artifact = load_artifact(args.exported, device)
        if artifact.kind != "ctc":
            raise ValueError(f"{args.exported} is a {artifact.kind!r} "
                             "artifact; cli.test --exported scores CTC "
                             "artifacts (embeddings run under cli.embed)")
        vocab_list = artifact.vocab  # the artifact's vocabulary is its head
        # the batches padded to the entry table: the valid-frame count of
        # the pad-mask downsampling depends on the PADDED length, so the
        # scores equal a live eval's at the same length grid
        args.length_buckets = artifact.entry_sizes
        args.max_sample_len = min(args.max_sample_len, artifact.max_samples)
    else:
        vocab_list = read_vocab_list(args.vocab_file or os.path.join(
            args.root_dir, args.dict_file))
    vocab = {v: i for i, v in enumerate(vocab_list)}
    index2vocab = revlut(vocab)

    ctc_decoder, beam_lm_key, lm_load_s = None, None, None
    if args.beam > 1 or args.lm:
        t0 = time.perf_counter()
        ctc_decoder = PrefixBeamSearch(vocab_list, alpha=args.alpha,
                                       beta=args.beta, beam=args.beam,
                                       lm_file=args.lm)
        lm_load_s = time.perf_counter() - t0 if args.lm else None
        beam_lm_key = (f"werr_lm_{args.beam}" if args.lm
                       else f"werr_{args.beam}")

    valid_set = AudioTextLetterDataset(
        os.path.join(args.root_dir, args.valid_dataset),
        TextVectorizer(vocab), args.target_tokens_per_batch,
        args.max_sample_len, input_sample_rate=args.input_sample_rate,
        target_sample_rate=args.target_sample_rate, shuffle=False,
        is_infinite=False, tgt_type=args.target_type,
        pad_to_multiple=args.pad_to_multiple,
        length_grid=args.length_buckets)

    if artifact is not None:
        forward = artifact.forward
    else:
        forward = _live_forward(args, len(vocab), device)

    postproc = (M.postproc_bpe if args.target_type == "bpe"
                else M.postproc_letters)
    sr = args.target_sample_rate
    metrics = {}
    c_errors = c_total = w_errors = w_total = wlm_errors = utterances = 0
    audio_s = beam_s = 0.0
    outputs = []
    start = time.perf_counter()
    batches = iter(PrefetchLoader(valid_set, prefetch=4))
    for j, batch in enumerate(batches):
        if j > args.valid_steps:
            break
        log_probs, frames = forward(
            torch.from_numpy(batch["signal"]).to(device),
            torch.from_numpy(batch["signal_lengths"]).to(device))
        # padding rows that batch-size snapping appends sit at the tail
        n_real = batch.get("num_real", len(batch["signal_lengths"]))
        log_probs = log_probs.float().cpu().numpy()[:n_real]
        frame_lengths = frames.cpu().numpy()[:n_real]
        audio_s += float(batch["signal_lengths"][:n_real].sum()) / sr
        utterances += n_real
        if keep_outputs:
            for b in range(n_real):
                lp = log_probs[b, :frame_lengths[b]]
                units = greedy_collapse(lp.argmax(-1), Offsets.GO)
                outputs.append({"file": batch["files"][b], "log_probs": lp,
                                "greedy": postproc([index2vocab[int(x)]
                                                    for x in units])})
        t0 = time.perf_counter()
        sm = run_step(index2vocab, log_probs, frame_lengths,
                      dict(batch, token_ids=batch["token_ids"][:n_real]),
                      args.verbose, ctc_decoder, postproc)
        if ctc_decoder is not None:
            beam_s += time.perf_counter() - t0
            if keep_outputs:
                for out, text in zip(outputs[-n_real:], sm["beam_texts"]):
                    out["beam"] = text
        c_errors += sm["c_errors"]
        w_errors += sm["w_errors"]
        wlm_errors += sm["wbeam_errors"]
        c_total += sm["c_total"]
        w_total += sm["w_total"]
        metrics["cer"] = (c_errors / max(c_total, 1)) * 100
        metrics["wer"] = (w_errors / max(w_total, 1)) * 100
        if beam_lm_key:
            metrics[beam_lm_key] = (wlm_errors / max(w_total, 1)) * 100
        metrics["step"] = j + 1
        if (j + 1) % args.steps_per_update == 0:
            logger.info(metrics)
    batches.close()  # stops the prefetch threads
    metrics.update(utterances=utterances, audio_seconds=audio_s,
                   eval_seconds=time.perf_counter() - start,
                   beam_seconds=beam_s)
    if lm_load_s is not None:
        metrics["lm_load_seconds"] = lm_load_s
    logger.info("Final results")
    logger.info(metrics)
    if keep_outputs:
        metrics["outputs"] = outputs
    return metrics


def main():
    evaluate()


if __name__ == "__main__":
    main()
