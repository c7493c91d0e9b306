"""Utterance-embedding CLI of the port (``a8t-embed`` on PyTorch): audio
-> one L2-normalised vector per manifest row.

Counterpart of ``audio8_tpu/cli/embed.py`` on ``--device`` (the CUDA card
by default; ``--device cpu`` asks for the CPU): the pooled utterance
encoder (``Wav2Vec2PooledEncoder``, reductions ``mean``, ``max``,
``sha*``, ``2ha*``) over batches of ``--batch`` files padded to whole
seconds, each row normalised in float32 by ``rsqrt(max(sum(e^2),
1e-12))``. Writes ``<output>.npy`` (N, D) and ``<output>.tsv``
(``file\\tindex``); with ``--trials`` (``enroll\\ttest\\tlabel`` rows)
it scores cosine similarity per pair and prints the EER instead.

  python -m audio8_tpu_torch.cli.embed --checkpoint pretrain.pt \\
      --root_dir corpus --dataset test.tsv --reduction_type mean

``--checkpoint`` is a fairseq ``.pt`` or an HF ``save_pretrained``
directory (pretrained or CTC: its encoder) or the port's paired ``.pt``
(its audio tower, reduction heads included). Use ``mean`` or ``max``
for a checkpoint without heads. ``--exported`` runs a ``cli.export
--pooled`` artifact instead (its reduction baked in at export).
"""
from __future__ import annotations

import logging
import os
from argparse import ArgumentParser
from typing import Callable, List

import numpy as np
import torch

from audio8_tpu_torch.cli.common import (add_common_model_args,
                                        apply_preset, check_ported,
                                        encoder_kwargs, load_weights,
                                        resolve_device)
from audio8_tpu_torch.config import PooledConfig
from audio8_tpu_torch.data.audio import SoundfileAudioReader
from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2PooledEncoder
from audio8_tpu_torch.train.checkpoint import load_port_checkpoint

logger = logging.getLogger("audio8_tpu_torch.embed")

AUDIO_PREFIX = "model.audio_encoder."  # the paired model's audio tower


def parse_args(argv=None):
    p = ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint",
                   help="fairseq .pt or the port's paired .pt")
    p.add_argument("--exported",
                   help="cli.export --pooled artifact directory: run its "
                        "traced encoder instead of building the model")
    p.add_argument("--root_dir", required=True)
    p.add_argument("--dataset", default="test.tsv",
                   help="TSV manifest (dir header + file\\tsamples rows)")
    p.add_argument("--output", default="embeddings",
                   help="writes <output>.npy + <output>.tsv")
    p.add_argument("--trials",
                   help="optional trial list: enroll\\ttest\\tlabel rows "
                        "(paths relative to the manifest audio dir); "
                        "reports cosine-score EER instead of writing "
                        "embeddings")
    p.add_argument("--reduction_type", default="mean",
                   choices=["mean", "max", "sha", "sha_max", "sha_mean",
                            "2ha", "2ha_max", "2ha_mean"],
                   help="utterance pooling; 'mean'/'max' need no pooled "
                        "head params (use these for raw pretrained/CTC "
                        "checkpoints)")
    p.add_argument("--max_sample_len", type=int, default=325_000)
    p.add_argument("--batch", type=int, default=8)
    add_common_model_args(p)
    args = apply_preset(p.parse_args(argv))
    check_ported(args, "embed")
    if not args.exported and not args.checkpoint:
        raise SystemExit("--checkpoint is required "
                         "(or pass an --exported artifact)")
    return args


def load_pooled_weights(path: str, model: Wav2Vec2PooledEncoder) -> None:
    """The audio tower of the port's paired ``.pt`` (every key of
    ``model``), else a fairseq ``.pt``'s or an HF directory's encoder
    into ``model.encoder`` (the reduction keeps its initial weights, as
    in JAX)."""
    paired = (None if os.path.isdir(path)
              else load_port_checkpoint(path, "paired"))
    if paired is None:
        load_weights(path, model.encoder, ctc=False)
        return
    tower = {k[len(AUDIO_PREFIX):]: v for k, v in paired.items()
             if k.startswith(AUDIO_PREFIX)}
    model.load_state_dict({k: tower[k] for k in model.state_dict()},
                          strict=True)


def pad_to_seconds(n: int, sr: int = 16_000) -> int:
    """A batch's padded length: whole seconds, at least one."""
    return max(sr, (n + sr - 1) // sr * sr)


def build_pooled(args, device: torch.device):
    """``(cfg, model)``: the pooled encoder of the flags with the
    checkpoint's weights, in eval mode on ``device``."""
    cfg = PooledConfig(
        d_model=args.d_model, num_heads=args.num_heads,
        num_layers=args.num_layers, d_ff=args.d_ff, dropout=0.0,
        timestep_masking=0.0, channel_masking=0.0, freeze_fx=False,
        reduction_type=args.reduction_type, **encoder_kwargs(args))
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = Wav2Vec2PooledEncoder(cfg, dtype)
    load_pooled_weights(args.checkpoint, model)
    return cfg, model.to(device).eval()


def normalized(emb: torch.Tensor) -> torch.Tensor:
    """Each row in float32 times ``rsqrt(max(sum(e^2), 1e-12))``."""
    emb = emb.float()
    return emb * torch.rsqrt(torch.clamp_min((emb * emb).sum(-1, keepdim=True),
                                             1e-12))


def make_embed(run: Callable, pad_target: Callable, batch: int,
               max_sample_len: int) -> Callable:
    """``embed(paths) -> (N, D)``: the files read, padded to
    ``pad_target(longest)`` samples in batches of ``batch`` and run
    through ``run(signal, lengths) -> (B, D)`` unit vectors."""
    reader = SoundfileAudioReader()

    def embed(paths: List[str]) -> np.ndarray:
        out = []
        for lo in range(0, len(paths), batch):
            chunk = paths[lo:lo + batch]
            audios = [reader.read(p, max_sample_len).squeeze()
                      for p in chunk]
            sig = np.zeros((len(chunk), pad_target(
                max(len(a) for a in audios))), np.float32)
            lens = np.zeros(len(chunk), np.int64)
            for i, a in enumerate(audios):
                sig[i, :len(a)] = a
                lens[i] = len(a)
            out.append(run(sig, lens))
        return (np.concatenate(out) if out
                else np.zeros((0, 1), np.float32))

    return embed


def build_embedder(args, device: torch.device = None) -> Callable:
    """-> ``embed(paths) -> (N, D)`` float32 unit vectors, the encoder (or
    the ``--exported`` artifact) on ``device`` (default: ``--device``)."""
    if device is None:
        device = resolve_device(args.device)
    if device.type == "cuda" and not args.bf16:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if args.exported:
        from audio8_tpu_torch.export import load_artifact

        art = load_artifact(args.exported, device)
        if art.kind != "embed":
            raise SystemExit(f"{args.exported} is a {art.kind!r} artifact, "
                             "not an embed one (cli.export --pooled)")
        # utterances must fit an exported window; the artifact pads the
        # rest of the way to its entry table itself
        return make_embed(
            lambda sig, lens: art.forward(sig, lens).cpu().numpy(),
            lambda n: n, args.batch, min(args.max_sample_len,
                                         art.max_samples))
    _, model = build_pooled(args, device)

    @torch.inference_mode()
    def run(sig: np.ndarray, lens: np.ndarray) -> np.ndarray:
        emb = model(torch.from_numpy(sig).to(device),
                    torch.from_numpy(lens).to(device), freeze=False)
        return normalized(emb).cpu().numpy()

    return make_embed(run, pad_to_seconds, args.batch, args.max_sample_len)


def compute_eer(scores: np.ndarray, labels: np.ndarray) -> float:
    """Equal error rate of cosine scores vs binary labels."""
    order = np.argsort(-scores)
    labels = labels[order].astype(bool)
    pos = max(int(labels.sum()), 1)
    neg = max(int((~labels).sum()), 1)
    tp = np.cumsum(labels)
    fp = np.cumsum(~labels)
    fnr = 1.0 - tp / pos
    fpr = fp / neg
    i = int(np.argmin(np.abs(fnr - fpr)))
    return float((fnr[i] + fpr[i]) / 2.0)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    manifest = os.path.join(args.root_dir, args.dataset)
    with open(manifest) as f:
        audio_dir = f.readline().strip()
        rows = [line.split("\t")[0] for line in f if line.strip()]
    embed = build_embedder(args)

    if args.trials:
        pairs = []
        with open(args.trials) as f:
            for line in f:
                enroll, test, label = line.split()
                pairs.append((enroll, test, int(label)))
        uniq = sorted({p for e, t, _ in pairs for p in (e, t)})
        vecs = embed([os.path.join(audio_dir, p) for p in uniq])
        idx = {p: i for i, p in enumerate(uniq)}
        scores = np.array([float(vecs[idx[e]] @ vecs[idx[t]])
                           for e, t, _ in pairs])
        labels = np.array([lab for _, _, lab in pairs])
        eer = compute_eer(scores, labels)
        logger.info("trials %d, EER %.2f%%", len(pairs), eer * 100)
        print(f"eer {eer:.4f}")
        return 0

    vecs = embed([os.path.join(audio_dir, r) for r in rows])
    np.save(args.output + ".npy", vecs)
    with open(args.output + ".tsv", "w") as f:
        for i, r in enumerate(rows):
            f.write(f"{r}\t{i}\n")
    logger.info("%d embeddings (dim %d) -> %s.npy", len(vecs),
                vecs.shape[-1] if len(vecs) else 0, args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
