"""Transcription CLI of the port: fairseq CTC checkpoint + audio -> text.

Counterpart of ``a8t-transcribe`` (``audio8_tpu/cli/transcribe.py``) on
PyTorch, on ``--device`` (the CUDA card by default; it raises without
one, and ``--device cpu`` asks for the CPU). Greedy CTC decoding; long
audio runs through the ``ChunkedTranscriber`` when ``--chunk_seconds > 0``.

  python -m audio8_tpu_torch.cli.transcribe --checkpoint ctc.pt \\
      --dict_file dict.ltr.txt a.wav b.wav

Every flag of the JAX entry point but ``--lane_align`` parses; beam
search and LM, VAD, timestamps, int8, exported artifacts, transducers
and non-fairseq checkpoints raise ``NotImplementedError`` (ROADMAP.md
queue 1, items 6 and 7). Dropout flags are inert at inference.
"""
from __future__ import annotations

import logging
from argparse import ArgumentParser
from typing import Callable, Optional

import numpy as np
import torch

from audio8_tpu_torch.cli.common import (add_common_model_args,
                                        add_decoding_args, apply_preset,
                                        encoder_kwargs, require_checkpoint,
                                        resolve_device)
from audio8_tpu_torch.config import AcousticConfig
from audio8_tpu_torch.data.audio import SoundfileAudioReader
from audio8_tpu_torch.models.convert import load_fairseq_ctc
from audio8_tpu_torch.models.text import read_vocab_list
from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
from audio8_tpu_torch.ops.ctc import greedy_collapse
from audio8_tpu_torch.ops.metrics import postproc_bpe, postproc_letters
from audio8_tpu_torch.serve import ChunkedTranscriber, decode_stitched
from audio8_tpu_torch.utils import Offsets, revlut, str2bool


def parse_args(argv=None):
    p = ArgumentParser(description=__doc__)
    p.add_argument("audio", nargs="+", help="WAV files")
    p.add_argument("--checkpoint",
                   help="fairseq fine-tuned wav2vec2 CTC .pt")
    p.add_argument("--dict_file",
                   help="fairseq dict.ltr.txt or HF vocab.json")
    add_decoding_args(p, max_decode_len=None)
    p.add_argument("--vad", type=str2bool, default=False,
                   help="not ported yet")
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


def build_acoustic(args, device: torch.device):
    """Model with the checkpoint's weights, on ``device``, in eval mode.

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
    model.load_state_dict(load_fairseq_ctc(args.checkpoint), strict=True)
    return cfg, model.to(device).eval(), vocab_list, index2vocab


def load_acoustic(args, device: Optional[torch.device] = None):
    """The eval stack a decoding surface needs, on ``device`` (default:
    ``--device``, which raises for ``cuda`` without a card).

    Returns ``(cfg, forward, vocab_list, index2vocab, device)`` where
    ``forward(signal (B, T) f32, lengths (B,)) -> (log_probs (B, T', V)
    f32, frames (B,))`` runs the model under ``torch.inference_mode()`` on
    tensors on ``device``."""
    if device is None:
        device = resolve_device(args.device)
    cfg, model, vocab_list, index2vocab = build_acoustic(args, device)
    if device.type == "cuda" and not args.bf16:
        # float32 means float32: cuDNN would run the convolutions that
        # stay in PyTorch in TF32 by default
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    @torch.inference_mode()
    def forward(signal: torch.Tensor, lengths: torch.Tensor):
        lp, mask = model(signal, lengths)
        return lp, mask.sum(dim=-1)

    return cfg, forward, vocab_list, index2vocab, device


def _transcribe_wav(wav: np.ndarray, forward: Callable,
                    ct: Optional[ChunkedTranscriber], index2vocab: dict,
                    sr: int, device: torch.device,
                    postproc: Callable = postproc_letters):
    """One waveform -> ``(text, (T', V) log-probs)`` through the chunked
    path (any length) or one forward padded to whole seconds."""
    if ct is not None:
        lp = ct.log_probs(wav)
        return decode_stitched(lp, index2vocab, postproc=postproc), lp
    t_pad = max((len(wav) + sr - 1) // sr * sr, sr)
    signal = np.zeros((1, t_pad), np.float32)
    signal[0, :len(wav)] = wav
    lp, frames = forward(torch.from_numpy(signal).to(device),
                         torch.tensor([len(wav)], device=device))
    n = int(frames[0])
    lp = lp[0, :n].float().cpu().numpy()
    ids = greedy_collapse(np.argmax(lp, -1), Offsets.GO)
    return postproc([index2vocab[i] for i in ids]), lp


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    postproc = postproc_bpe if args.target_type == "bpe" else postproc_letters
    cfg, forward, _, index2vocab, device = load_acoustic(args)
    sr = args.target_sample_rate
    ct = None
    if args.chunk_seconds > 0:
        ct = ChunkedTranscriber(forward, cfg.conv_features,
                                chunk_samples=int(args.chunk_seconds * sr),
                                context_samples=int(args.context_seconds * sr),
                                device=device)
    reader = SoundfileAudioReader()
    results = []
    for path in args.audio:
        wav = np.asarray(reader.read(path), np.float32)
        text, _ = _transcribe_wav(wav, forward, ct, index2vocab, sr, device,
                                  postproc)
        results.append((path, text))
        print(f"{path}\t{text}")
    return results


if __name__ == "__main__":
    main()
