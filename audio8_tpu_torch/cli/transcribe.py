"""Transcription CLI of the port: CTC checkpoint + audio -> text.

Counterpart of ``a8t-transcribe`` (``audio8_tpu/cli/transcribe.py``) on
PyTorch, on ``--device`` (the CUDA card by default; it raises without
one, and ``--device cpu`` asks for the CPU). Greedy CTC decoding, or the
host prefix beam search with ``--beam`` and an n-gram ``--lm``
(``ops/beam.py``); long audio runs through the ``ChunkedTranscriber``
when ``--chunk_seconds > 0``. ``--vad true`` transcribes only the speech
spans (``ops/vad.py``); ``--timestamps true`` prints one JSON row per
file with word times from the greedy alignment (``ops/align.py``), and
under ``--vad`` the segments too. ``--quantize int8`` runs the Dense
layers on int8 weights (``ops/quant.py``).

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
on its smallest entry that covers the request). Every flag of the JAX
entry point but ``--lane_align`` parses; ``--device_beam`` and
``--transducer`` (item 7) raise ``NotImplementedError``. Dropout flags
are inert at inference.
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


def build_beam_decoder(args, vocab_list):
    """The optional ``PrefixBeamSearch`` of a decoding surface's flags
    (``--beam``, ``--lm``, ``--alpha``, ``--beta``), else ``None``."""
    if args.beam <= 1 and not args.lm:
        return None
    return PrefixBeamSearch(vocab_list, alpha=args.alpha, beta=args.beta,
                            beam=args.beam, lm_file=args.lm)


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
    if is_hf_dir(args.checkpoint):
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
            "serves CTC artifacts (embed artifacts run under cli.embed)")
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
    decoder = build_beam_decoder(args, vocab_list)
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
        text = " ".join(texts)
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
    return results


if __name__ == "__main__":
    main()
