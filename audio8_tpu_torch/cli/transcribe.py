"""Transcription CLI of the port: CTC checkpoint + audio -> text.

Counterpart of ``a8t-transcribe`` (``audio8_tpu/cli/transcribe.py``) on
PyTorch, on ``--device`` (the CUDA card by default; it raises without
one, and ``--device cpu`` asks for the CPU). Greedy CTC decoding, or the
host prefix beam search with ``--beam`` and an n-gram ``--lm``
(``ops/beam.py``), or with ``--device_beam true`` and no LM the batched
beam search on ``--device`` (``ops/beam_device.py``); long audio runs
through the ``ChunkedTranscriber`` when ``--chunk_seconds > 0``. ``--vad
true`` transcribes only the speech spans (``ops/vad.py``);
``--timestamps true`` prints one JSON row per file with word times from
the greedy alignment (``ops/align.py``), and under ``--vad`` the
segments too. ``--quantize int8`` runs the Dense layers on int8 weights
(``ops/quant.py``).

  python -m audio8_tpu_torch.cli.transcribe --checkpoint ctc.pt \\
      --dict_file dict.ltr.txt --beam 8 --lm lm.arpa a.wav b.wav
  python -m audio8_tpu_torch.cli.transcribe --preset large-lv60 \\
      --checkpoint ./hf-wav2vec2-large-960h-lv60-self \\
      --dict_file ./hf-wav2vec2-large-960h-lv60-self/vocab.json a.wav

``--checkpoint`` is a fairseq CTC ``.pt`` or an HF ``save_pretrained``
directory (``Wav2Vec2ForCTC`` and its HuBERT, data2vec-audio, WavLM and
conformer kin); the model flags (``--preset``) must give its topology
and sizes, and ``vocab.json`` is its symbol table. ``--exported``
runs a ``cli.export`` artifact instead of a checkpoint (its vocabulary
and conv geometry come from the artifact; ``--chunk_seconds`` windows
on its smallest entry that covers the request). ``--transducer true``
decodes an RNN-T checkpoint (``cli.train_transducer``'s ``.pt``): greedy,
the 1-best of the beam search with ``--beam``, word times from the
greedy search's own alignment with ``--timestamps``, and through the
``TransducerStreamer`` with ``--chunk_seconds``; an exported transducer
artifact decodes through the streamer; ``--lm``, ``--device_beam`` and
``--quantize`` exit there, as in JAX. Every flag of the JAX entry point
but ``--lane_align`` parses. Dropout flags are inert at inference.
"""
from __future__ import annotations

import json
import logging
from argparse import ArgumentParser
from typing import Callable, Optional

import numpy as np
import torch

from audio8_tpu_torch.cli.common import (add_common_model_args,
                                        add_decoding_args, apply_preset,
                                        encoder_kwargs, load_weights,
                                        require_checkpoint, resolve_device)
from audio8_tpu_torch.config import AcousticConfig
from audio8_tpu_torch.data.audio import SoundfileAudioReader
from audio8_tpu_torch.models.convert import load_fairseq_ctc
from audio8_tpu_torch.models.convert_hf import is_hf_dir
from audio8_tpu_torch.models.text import read_vocab_list
from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
from audio8_tpu_torch.ops.align import timestamped_words, total_stride
from audio8_tpu_torch.ops.beam import PrefixBeamSearch
from audio8_tpu_torch.ops.metrics import postproc_bpe, postproc_letters
from audio8_tpu_torch.ops.quant import quantize_model_params
from audio8_tpu_torch.ops.vad import speech_segments
from audio8_tpu_torch.serve import ChunkedTranscriber, decode_stitched
from audio8_tpu_torch.utils import Offsets, revlut, str2bool
from audio8_tpu_torch.train.orbax import is_orbax_dir


def parse_args(argv=None):
    p = ArgumentParser(description=__doc__)
    p.add_argument("audio", nargs="+", help="WAV files")
    p.add_argument("--checkpoint",
                   help="fairseq fine-tuned wav2vec2 CTC .pt or HF dir")
    p.add_argument("--dict_file",
                   help="fairseq dict.ltr.txt or HF vocab.json")
    add_decoding_args(p, max_decode_len=None)
    p.add_argument("--vad", type=str2bool, default=False,
                   help="energy-based voice activity detection "
                        "(ops/vad.py): transcribe only speech spans; "
                        "timestamps stay global")
    p.add_argument("--target_type", choices=["ltr", "bpe"], default="ltr",
                   help="unit type the checkpoint was trained on")
    p.add_argument("--chunk_seconds", type=float, default=0.0,
                   help=">0: transcribe arbitrarily long audio through "
                        "fixed-size overlapped chunks")
    p.add_argument("--context_seconds", type=float, default=2.0)
    add_common_model_args(p)
    args = apply_preset(p.parse_args(argv))
    require_checkpoint(args, "transcribe")
    return args


def build_beam_decoder(args, vocab_list, device=None):
    """The optional ``PrefixBeamSearch`` of a decoding surface's flags
    (``--beam``, ``--lm``, ``--alpha``, ``--beta``, ``--device_beam``:
    the search on ``device``, default ``--device``), else ``None``."""
    if args.beam <= 1 and not args.lm:
        return None
    if args.device_beam and device is None:
        device = resolve_device(args.device)
    return PrefixBeamSearch(vocab_list, alpha=args.alpha, beta=args.beta,
                            beam=args.beam, lm_file=args.lm,
                            device=device if args.device_beam else False)


def check_timestamps(args) -> None:
    """Word times need letter units: ``--timestamps`` with ``--target_type
    bpe`` exits, as in JAX."""
    if args.timestamps and args.target_type != "ltr":
        raise SystemExit("--timestamps requires --target_type ltr: word "
                         "boundaries come from the '|' letter unit "
                         "(ops/align.py)")


def build_acoustic(args, device: torch.device):
    """Model with the checkpoint's weights, on ``device``, in eval mode;
    under ``--quantize int8`` its Dense layers quantized after the load,
    as in JAX.

    Returns ``(cfg, model, vocab_list, index2vocab)``."""
    Offsets.remap_fairseq_ctc()
    vocab_list = read_vocab_list(args.dict_file)
    index2vocab = revlut({v: i for i, v in enumerate(vocab_list)})
    cfg = AcousticConfig(
        num_labels=len(vocab_list), d_model=args.d_model,
        num_heads=args.num_heads, num_layers=args.num_layers, d_ff=args.d_ff,
        timestep_masking=0.0, channel_masking=0.0, **encoder_kwargs(args))
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = Wav2Vec2AcousticModel(cfg, dtype)
    if is_hf_dir(args.checkpoint) or is_orbax_dir(args.checkpoint):
        load_weights(args.checkpoint, model, ctc=True)
    else:
        model.load_state_dict(load_fairseq_ctc(args.checkpoint), strict=True)
    if getattr(args, "quantize", "none") == "int8":
        quantize_model_params(model)
    return cfg, model.to(device).eval(), vocab_list, index2vocab


def no_tf32(device: torch.device, bf16: bool) -> None:
    """float32 means float32: cuDNN would run the convolutions that stay
    in PyTorch in TF32 by default."""
    if device.type == "cuda" and not bf16:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def load_exported_acoustic(args, device: Optional[torch.device] = None):
    """:func:`load_acoustic`'s counterpart backed by a ``cli.export``
    artifact (``--exported``) on ``device`` (default: ``--device``): its
    traced forward runs in place of the live model, with no checkpoint
    read and no model built.

    Returns ``(cfg, forward, vocab_list, index2vocab, device, art)``;
    ``cfg.conv_features`` is the artifact's geometry."""
    from types import SimpleNamespace

    from audio8_tpu_torch.export import load_artifact

    if device is None:
        device = resolve_device(args.device)
    Offsets.remap_fairseq_ctc()
    art = load_artifact(args.exported, device)
    if art.kind != "ctc":
        raise SystemExit(
            f"{args.exported} is a {art.kind!r} artifact; this surface "
            "serves CTC and transducer artifacts (embed artifacts run "
            "under cli.embed)")
    no_tf32(device, art.meta.get("bf16", False))
    vocab_list = art.vocab
    index2vocab = revlut({v: i for i, v in enumerate(vocab_list)})
    cfg = SimpleNamespace(conv_features=art.conv_features)
    return cfg, art.forward, vocab_list, index2vocab, device, art


def load_acoustic(args, device: Optional[torch.device] = None):
    """The eval stack a decoding surface needs, on ``device`` (default:
    ``--device``, which raises for ``cuda`` without a card).

    Returns ``(cfg, forward, vocab_list, index2vocab, device)`` where
    ``forward(signal (B, T) f32, lengths (B,)) -> (log_probs (B, T', V)
    f32, frames (B,))`` runs the model under ``torch.inference_mode()`` on
    tensors on ``device``; ``forward.model`` is the model."""
    if device is None:
        device = resolve_device(args.device)
    cfg, model, vocab_list, index2vocab = build_acoustic(args, device)
    no_tf32(device, args.bf16)

    @torch.inference_mode()
    def forward(signal: torch.Tensor, lengths: torch.Tensor):
        lp, mask = model(signal, lengths)
        return lp, mask.sum(dim=-1)

    forward.model = model
    return cfg, forward, vocab_list, index2vocab, device


def build_transducer(args, device: torch.device, vocab_list=None):
    """The RNN-T checkpoint's model (``--checkpoint``: the port's
    transducer ``.pt``, or a fairseq or HF encoder, the predictor and
    joint then at zero), on
    ``device``, in eval mode, over ``vocab_list`` (default: read from
    ``--dict_file``). Returns ``(cfg, model, index2vocab)``."""
    from audio8_tpu_torch.config import TransducerConfig
    from audio8_tpu_torch.models.transducer import Transducer

    Offsets.remap_fairseq_ctc()
    if vocab_list is None:
        vocab_list = read_vocab_list(args.dict_file)
    index2vocab = revlut({v: i for i, v in enumerate(vocab_list)})
    cfg = TransducerConfig(
        vocab_size=len(vocab_list),
        sample_rate=args.target_sample_rate // 1000, d_model=args.d_model,
        num_heads=args.num_heads, num_layers=args.num_layers, d_ff=args.d_ff,
        timestep_masking=0.0, channel_masking=0.0,
        pred_layers=args.pred_layers, pred_dim=args.pred_dim,
        pred_embed_dim=args.pred_embed_dim, d_joint=args.d_joint,
        **encoder_kwargs(args))
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = Transducer(cfg, dtype)
    load_weights(args.checkpoint, model, ctc=True, kind="transducer")
    no_tf32(device, args.bf16)
    return cfg, model.to(device).eval(), index2vocab


def load_transducer(args, device: Optional[torch.device] = None):
    """The RNN-T decode stack on ``device`` (default: ``--device``).

    Returns ``(cfg, decode, index2vocab, model, device)`` where
    ``decode(signal (B, T), lengths (B,)) -> (tokens, lengths)`` runs the
    greedy search, or with ``--beam`` above 1 the beam search's 1-best,
    or with ``--timestamps`` the timed greedy search (tokens, lengths,
    frames, log-posteriors)."""
    if device is None:
        device = resolve_device(args.device)
    cfg, model, index2vocab = build_transducer(args, device)

    @torch.inference_mode()
    def decode(signal: torch.Tensor, lengths: torch.Tensor):
        if args.beam > 1:
            toks, n, _ = model.decode_beam(signal, lengths, args.beam,
                                           args.max_decode_len,
                                           args.max_symbols_per_frame)
            return toks[:, 0], n[:, 0]  # the 1-best of the sorted beams
        return model.decode(signal, lengths, args.max_decode_len,
                            args.max_symbols_per_frame,
                            timed=bool(getattr(args, "timestamps", False)))

    return cfg, decode, index2vocab, model, device


def transducer_stream_fns(model, max_symbols: int):
    """``(encode, decode_init, decode_frames)`` of a live transducer for a
    ``serve.TransducerStreamer``, each under ``torch.inference_mode()``;
    ``encode`` returns float32 features."""
    device = model.joint.out.weight.device

    @torch.inference_mode()
    def encode(signal, lengths):
        enc, frames = model.encode(signal, lengths)
        return enc.float(), frames

    @torch.inference_mode()
    def decode_init():
        return model.decode_init(1, device)

    @torch.inference_mode()
    def decode_frames(enc, n_frames, tokens, n, pred_out, carry):
        return model.decode_frames(enc.to(model.compute_dtype), n_frames,
                                   tokens, n, pred_out, carry, max_symbols)

    return encode, decode_init, decode_frames


def load_transducer_stream(args, device: Optional[torch.device] = None):
    """:func:`load_transducer`'s model as the three functions of a
    ``serve.TransducerStreamer``. Returns ``(cfg, encode, decode_init,
    decode_frames, index2vocab, device)``."""
    cfg, _, index2vocab, model, device = load_transducer(args, device)
    return (cfg, *transducer_stream_fns(model, args.max_symbols_per_frame),
            index2vocab, device)


def _transducer_main(args):
    """``--transducer``: greedy, beam 1-best or timed decode of whole
    utterances, or the streamer under ``--chunk_seconds``."""
    from audio8_tpu_torch.ops.align import word_timestamps
    from audio8_tpu_torch.serve import TransducerStreamer

    if args.lm or args.device_beam or args.quantize != "none":
        raise SystemExit("--transducer: --lm/--device_beam/--quantize are "
                         "CTC-path flags")
    if args.beam > 1 and args.chunk_seconds > 0:
        raise SystemExit("--transducer beam search decodes whole "
                         "utterances; the --chunk_seconds streaming path "
                         "is greedy (serve.TransducerStreamer)")
    if args.timestamps and (args.chunk_seconds > 0 or args.beam > 1
                            or args.target_type != "ltr"):
        raise SystemExit("--transducer --timestamps: whole-utterance greedy "
                         "decode with --target_type ltr only (word "
                         "boundaries come from the '|' letter unit)")
    stream_budget = args.max_decode_len or 8_000
    args.max_decode_len = args.max_decode_len or 200
    postproc = postproc_bpe if args.target_type == "bpe" else postproc_letters
    sr = args.target_sample_rate
    streamer = None
    if args.chunk_seconds > 0:
        cfg, encode, decode_init, decode_frames, index2vocab, device = \
            load_transducer_stream(args)
        streamer = TransducerStreamer(
            encode, decode_init, decode_frames, cfg.conv_features,
            chunk_samples=int(args.chunk_seconds * sr),
            context_samples=int(args.context_seconds * sr),
            max_output_len=stream_budget, device=device)
    else:
        cfg, decode, index2vocab, _, device = load_transducer(args)
    frame_sec = total_stride(cfg.conv_features) / sr
    reader = SoundfileAudioReader()
    results = []
    for path in args.audio:
        wav = np.asarray(reader.read(path), np.float32)
        segs = speech_segments(wav, sr) if args.vad else [(0, len(wav))]
        texts, words = [], []
        for a, b in segs:
            seg = wav[a:b]
            if streamer is not None:
                streamer.reset()
                streamer.feed(seg)
                text = streamer.finish_text(index2vocab, postproc=postproc)
            else:
                t_pad = (len(seg) + sr - 1) // sr * sr
                signal = np.zeros((1, t_pad), np.float32)
                signal[0, :len(seg)] = seg
                out = decode(torch.from_numpy(signal).to(device),
                             torch.tensor([len(seg)], device=device))
                k = int(out[1][0])
                ids = out[0][0, :k].cpu().numpy()
                text = postproc([index2vocab[int(i)] for i in ids])
                if args.timestamps:
                    align = list(zip(ids.tolist(),
                                     out[2][0, :k].cpu().tolist(),
                                     out[3][0, :k].cpu().tolist()))
                    off = a / sr
                    for w in word_timestamps(align, index2vocab, frame_sec):
                        w["start"] = round(w["start"] + off, 3)
                        w["end"] = round(w["end"] + off, 3)
                        words.append(w)
            if text:
                texts.append(text)
        _report(args, path, " ".join(texts), words, segs, sr, results)
    return results


def _exported_transducer_main(args, art, device: torch.device):
    """Transcribe through an exported transducer artifact: its encode,
    decode_init and decode_frames entries drive a
    ``serve.TransducerStreamer`` (the greedy resumable search)."""
    from audio8_tpu_torch.serve import TransducerStreamer

    if args.beam > 1 or args.timestamps or args.lm or args.device_beam:
        raise SystemExit(
            "exported transducer artifacts decode with the greedy "
            "streaming lattice search: --beam/--timestamps/--lm/"
            "--device_beam need the checkpoint path (--transducer)")
    index2vocab = revlut({v: i for i, v in enumerate(art.vocab)})
    postproc = postproc_bpe if args.target_type == "bpe" else postproc_letters
    sr = art.sample_rate
    streamer = TransducerStreamer(
        art.encode, art.decode_init, art.decode_frames, art.conv_features,
        chunk_samples=art.chunk_samples,
        context_samples=int(args.context_seconds * sr),
        window_frames=art.window_frames, max_output_len=art.max_output_len,
        device=device)
    reader = SoundfileAudioReader()
    results = []
    for path in args.audio:
        wav = np.asarray(reader.read(path), np.float32)
        segs = speech_segments(wav, sr) if args.vad else [(0, len(wav))]
        texts = []
        for a, b in segs:
            streamer.reset()
            streamer.feed(wav[a:b])
            text = streamer.finish_text(index2vocab, postproc=postproc)
            if text:
                texts.append(text)
        _report(args, path, " ".join(texts), [], segs, sr, results)
    return results


def _report(args, path: str, text: str, words: list, segs: list, sr: int,
            results: list) -> None:
    """Print and collect one file's result: ``path<TAB>text``, or under
    ``--timestamps`` one JSON row (with the VAD segments under
    ``--vad``)."""
    if args.timestamps:
        row = {"file": path, "text": text, "words": words}
        if args.vad:
            row["segments"] = [[round(a / sr, 3), round(b / sr, 3)]
                               for a, b in segs]
        results.append(row)
        print(json.dumps(row))
    else:
        results.append((path, text))
        print(f"{path}\t{text}")


def _transcribe_wav(wav: np.ndarray, forward: Callable,
                    ct: Optional[ChunkedTranscriber], index2vocab: dict,
                    sr: int, device: torch.device,
                    postproc: Callable = postproc_letters, decoder=None):
    """One waveform -> ``(text, (T', V) log-probs)`` through the chunked
    path (any length) or one forward padded to whole seconds."""
    if ct is None:
        t_pad = max((len(wav) + sr - 1) // sr * sr, sr)
        signal = np.zeros((1, t_pad), np.float32)
        signal[0, :len(wav)] = wav
        lp, frames = forward(torch.from_numpy(signal).to(device),
                             torch.tensor([len(wav)], device=device))
        lp = lp[0, :int(frames[0])].float().cpu().numpy()
    else:
        lp = ct.log_probs(wav)
    return decode_stitched(lp, index2vocab, decoder, postproc=postproc), lp


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.transducer:
        return _transducer_main(args)
    if args.exported:
        from audio8_tpu_torch.export import artifact_kind, load_artifact

        if artifact_kind(args.exported) == "transducer":
            device = resolve_device(args.device)
            return _exported_transducer_main(
                args, load_artifact(args.exported, device), device)
    check_timestamps(args)
    postproc = postproc_bpe if args.target_type == "bpe" else postproc_letters
    art = None
    if args.exported:
        cfg, forward, vocab_list, index2vocab, device, art = \
            load_exported_acoustic(args)
        sr = art.sample_rate
    else:
        cfg, forward, vocab_list, index2vocab, device = load_acoustic(args)
        sr = args.target_sample_rate
    decoder = build_beam_decoder(args, vocab_list, device)
    frame_sec = total_stride(cfg.conv_features) / sr
    ct = None
    if args.chunk_seconds > 0:
        chunk = int(args.chunk_seconds * sr)
        if art is not None:
            # the entry table is the shape menu: window on the smallest
            # exported size that covers the request
            chunk = art.entry_samples(chunk)
        ct = ChunkedTranscriber(forward, cfg.conv_features,
                                chunk_samples=chunk,
                                context_samples=int(args.context_seconds * sr),
                                device=device)
    reader = SoundfileAudioReader()
    results = []
    for path in args.audio:
        wav = np.asarray(reader.read(path), np.float32)
        segs = speech_segments(wav, sr) if args.vad else [(0, len(wav))]
        texts, words = [], []
        for a, b in segs:
            text, lp = _transcribe_wav(wav[a:b], forward, ct, index2vocab, sr,
                                       device, postproc, decoder)
            if text:
                texts.append(text)
            if args.timestamps:
                off = a / sr
                for w in timestamped_words(lp, index2vocab, Offsets.GO,
                                           frame_sec):
                    w["start"] = round(w["start"] + off, 3)
                    w["end"] = round(w["end"] + off, 3)
                    words.append(w)
        _report(args, path, " ".join(texts), words, segs, sr, results)
    return results


if __name__ == "__main__":
    main()
