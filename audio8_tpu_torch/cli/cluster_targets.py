"""HuBERT pretraining targets of the port (``a8t-cluster-targets`` on
PyTorch): k-means cluster ids, one per encoder frame.

Counterpart of ``audio8_tpu/cli/cluster_targets.py``. Reads TSV manifests
(a directory line, then ``file\\tnum_samples`` rows), computes
conv-grid-aligned MFCCs on the host (``data/mfcc.py``, float64 numpy),
fits k-means on a frame subsample of the FIRST manifest, and writes one
``.km`` file per manifest (a line per utterance: space-separated cluster
ids, one per encoder frame, fairseq's HuBERT label format) and the
centroids as ``.centroids.npy`` beside the first manifest.

Iteration 2 (HuBERT re-clusters a trained model's features, arXiv
2106.07447 §3.2): ``--checkpoint`` (a ``cli.pretrain_hubert`` or
``cli.pretrain`` run's directory or ``.pt``, a fairseq ``.pt`` or an HF
directory) and ``--feature_layer N`` cluster transformer layer N's output
(1-based), computed on ``--device`` (the CUDA card by default; it raises
without one) through the conv and attention kernels. Each clip is padded
to a 16 000-sample grid with its true length passed, so the extractor's
GroupNorm keeps its masked statistics and attention its key mask, and
the frames are sliced back to ``conv_output_length``: the ids stay on the
MFCC grid.

  python -m audio8_tpu_torch.cli.cluster_targets --root_dir corpus \\
      --manifests train.tsv valid.tsv --num_clusters 100
  python -m audio8_tpu_torch.cli.cluster_targets --root_dir corpus \\
      --manifests train.tsv valid.tsv --num_clusters 500 \\
      --checkpoint run --feature_layer 6

The flags are the JAX tool's, with the same names and defaults, plus
``--device``; the encoder runs in float32, as the JAX tool's does.
"""
from __future__ import annotations

import logging
import os
from argparse import ArgumentParser

import numpy as np
import torch

from audio8_tpu_torch.cli.common import (add_common_model_args,
                                        apply_preset, check_ported,
                                        encoder_kwargs, load_weights,
                                        resolve_device)
from audio8_tpu_torch.data.audio import SoundfileAudioReader
from audio8_tpu_torch.data.mfcc import assign_clusters, kmeans, mfcc

logger = logging.getLogger("audio8_tpu_torch.cluster")

PAD_GRID = 16_000  # samples: the featurizer's clips pad to a multiple


def read_manifest(tsv: str):
    with open(tsv) as f:
        directory = f.readline().strip()
        rows = [line.split("\t")[0] for line in f if line.strip()]
    return directory, rows


def checkpoint_file(path: str) -> str:
    """A run's directory -> its latest checkpoint (the port's
    ``checkpoint-step-N.pt`` or JAX's Orbax ``checkpoint-step-N``); a
    file, an Orbax or an HF directory as it is."""
    from audio8_tpu_torch.models.convert_hf import is_hf_dir
    from audio8_tpu_torch.train.checkpoint import find_latest_checkpoint
    from audio8_tpu_torch.train.orbax import is_orbax_dir

    if os.path.isdir(path) and not is_hf_dir(path) \
            and not is_orbax_dir(path):
        return find_latest_checkpoint(path)[0]
    return path


def make_model_featurizer(args, device: torch.device):
    """audio (T,) -> (frames, d_model) float32: transformer layer N's
    output of the restored encoder. The encoder is head-free, so a HuBERT
    or wav2vec2 checkpoint fills it whatever its clusters or projection
    width (the heads are dropped)."""
    from audio8_tpu_torch.config import (CONV_FEATURES, EncoderConfig,
                                         conv_output_length)
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2Encoder

    cfg = EncoderConfig(
        d_model=args.d_model, num_heads=args.num_heads,
        num_layers=args.num_layers, d_ff=args.d_ff, dropout=0.0,
        timestep_masking=0.0, channel_masking=0.0, freeze_fx=False,
        **encoder_kwargs(args))
    model = Wav2Vec2Encoder(cfg)
    load_weights(checkpoint_file(args.checkpoint), model, ctc=False)
    model = model.to(device).eval()
    tapped = []
    model.encoder.layers[args.feature_layer - 1].register_forward_hook(
        lambda _mod, _inp, out: tapped.append(out))
    conv = CONV_FEATURES[args.target_sample_rate // 1000]

    @torch.no_grad()
    def featurize(x: np.ndarray) -> np.ndarray:
        n = len(x)
        sig = torch.zeros((1, (n + PAD_GRID - 1) // PAD_GRID * PAD_GRID))
        sig[0, :n] = torch.from_numpy(np.asarray(x, np.float32))
        tapped.clear()
        model(sig.to(device), torch.tensor([n], device=device))
        feats = tapped[0][0, :conv_output_length(n, conv)]
        return feats.float().cpu().numpy()

    return featurize


def parse_args(argv=None):
    p = ArgumentParser(description=__doc__)
    p.add_argument("--root_dir", required=True)
    p.add_argument("--manifests", nargs="+", required=True,
                   help="TSV manifests; k-means is fit on the first")
    p.add_argument("--num_clusters", type=int, default=100,
                   help="HuBERT iteration-1 default (arXiv 2106.07447)")
    p.add_argument("--fit_frames", type=int, default=200_000,
                   help="frame subsample for the k-means fit")
    p.add_argument("--kmeans_iters", type=int, default=20)
    p.add_argument("--centroids", help="reuse fitted centroids (.npy) "
                                       "instead of fitting")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint",
                   help="cluster a trained model's features instead of "
                        "MFCCs (HuBERT iteration 2+): a run's directory or "
                        ".pt, a fairseq .pt, or an HF directory")
    p.add_argument("--feature_layer", type=int, default=6,
                   help="1-based transformer layer whose output is "
                        "clustered (HuBERT it-2 uses 6 of a base model)")
    add_common_model_args(p)
    return apply_preset(p.parse_args(argv))


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    device = resolve_device(args.device)
    check_ported(args, "cluster_targets")

    reader = SoundfileAudioReader()
    rng = np.random.default_rng(args.seed)
    featurize = (make_model_featurizer(args, device) if args.checkpoint
                 else mfcc)
    manifests = [os.path.join(args.root_dir, m) for m in args.manifests]

    if args.centroids:
        centroids = np.load(args.centroids)
        logger.info("loaded %s centroids from %s", len(centroids),
                    args.centroids)
    else:
        directory, rows = read_manifest(manifests[0])
        sample: list = []
        per_file = max(1, args.fit_frames // max(len(rows), 1))
        for name in rows:
            feats = featurize(
                reader.read(os.path.join(directory, name)).squeeze())
            if not len(feats):
                continue
            take = min(per_file, len(feats))
            sample.append(feats[rng.choice(len(feats), take, replace=False)])
        frames = np.concatenate(sample)
        logger.info("fitting k-means: %d clusters on %d frames",
                    args.num_clusters, len(frames))
        centroids = kmeans(frames, args.num_clusters,
                           n_iter=args.kmeans_iters, seed=args.seed)
        cpath = manifests[0].replace(".tsv", ".centroids.npy")
        np.save(cpath, centroids)
        logger.info("centroids -> %s", cpath)

    for tsv in manifests:
        directory, rows = read_manifest(tsv)
        km_path = tsv.replace(".tsv", ".km")
        with open(km_path, "w") as out:
            for name in rows:
                feats = featurize(
                    reader.read(os.path.join(directory, name)).squeeze())
                ids = assign_clusters(feats, centroids) if len(feats) else []
                out.write(" ".join(str(int(i)) for i in ids) + "\n")
        logger.info("%s: %d utterances -> %s", tsv, len(rows), km_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
