"""Average the weights of several of the port's checkpoints into one (the
JAX package's ``a8t-average-checkpoints``, on the port's own files).

The last k ``checkpoint-step-N.pt`` files of a run (fairseq-layout CTC or
pretrained, or the port's seq2seq or paired ``.pt``;
``train/checkpoint.py``) are averaged elementwise: every floating tensor
of their ``model`` dicts is summed in float64 and stored in its own
dtype (float32), other tensors come from the first file. The output
holds the weights only, no resume file (the optimizer state means
nothing at an averaged point), as ``{output}-avg-{step}.pt`` with the
largest step of the inputs; ``cli.test``, ``cli.transcribe`` and
``cli.serve`` load it as any checkpoint of its layout.

The JAX package's Orbax directories (``{base}-step-N``, a TrainState or
bare params; ``train/orbax.py``) average as the JAX tool averages them:
the params of each, floating leaves summed in float64 and stored in their
own dtype, other leaves (bfloat16 ones too) from the first; the step is
the largest saved ``step`` leaf; the output is the Orbax directory
``{output}-avg-{step}`` holding ``params`` and ``step``, in the port's
plain layout.

    python -m audio8_tpu_torch.cli.average_checkpoints --basedir run \\
        --last 5 --output run/checkpoint
    python -m audio8_tpu_torch.cli.average_checkpoints --checkpoints \\
        run/checkpoint-step-100.pt run/checkpoint-step-200.pt --output avg
"""
from __future__ import annotations

import argparse
import logging
import os
import re
from typing import List, Tuple

import numpy as np
import torch

from audio8_tpu_torch.train import orbax
from audio8_tpu_torch.train.checkpoint import parse_checkpoint_step

logger = logging.getLogger("audio8_tpu_torch")


def list_step_checkpoints(basedir: str, base: str = "checkpoint"
                          ) -> Tuple[List[str], List[int]]:
    """All ``{base}-step-N.pt`` files and Orbax ``{base}-step-N``
    directories under ``basedir``, by step."""
    pat = re.compile(re.escape(base) + r"-step-(\d+)(\.pt)?$")
    found = sorted((int(m.group(1)), os.path.join(basedir, name))
                   for name in os.listdir(basedir)
                   for m in [pat.match(name)] if m and (
                       m.group(2) or orbax.is_orbax_dir(
                           os.path.join(basedir, name))))
    return [p for _, p in found], [s for s, _ in found]


def _load(path: str) -> dict:
    with torch.serialization.safe_globals([argparse.Namespace]):
        blob = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(blob, dict) or not isinstance(blob.get("model"), dict):
        raise ValueError(f"{path}: not a checkpoint with a 'model' dict")
    return blob


def average_checkpoints(paths: List[str]) -> Tuple[dict, int]:
    """The first file's blob with its ``model`` dict replaced by the
    elementwise mean over ``paths``; and the largest step of their
    names."""
    if not paths:
        raise ValueError("no checkpoints to average")
    first = _load(paths[0])
    sums = {k: v.double() if v.is_floating_point() else v
            for k, v in first["model"].items()}
    for p in paths[1:]:
        model = _load(p)["model"]
        if model.keys() != sums.keys():
            raise ValueError(f"{p}: other parameters than {paths[0]}")
        for k, v in model.items():
            if v.is_floating_point():
                sums[k] = sums[k] + v.double()
    n = float(len(paths))
    blob = dict(first)
    blob["model"] = {k: (s / n).to(first["model"][k].dtype)
                     if s.is_floating_point() else s
                     for k, s in sums.items()}
    return blob, max(parse_checkpoint_step(p) for p in paths)


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, list):
        return [_tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def _floating(x) -> bool:
    return isinstance(x, np.ndarray) and np.issubdtype(x.dtype, np.floating)


def average_orbax(paths: List[str]):
    """The JAX ``average_checkpoints`` on Orbax directories: (the mean
    params tree, the largest saved ``step`` or ``None``)."""

    def params_of(tree):
        if isinstance(tree, dict) and "params" in tree:
            return tree["params"], tree.get("step")
        return tree, None

    acc, step = params_of(orbax.load_checkpoint(paths[0]))
    sums = _tree_map(lambda x: x.astype(np.float64) if _floating(x) else x,
                     acc)
    for p in paths[1:]:
        nxt, nxt_step = params_of(orbax.load_checkpoint(p))
        step = max(step or 0, nxt_step or 0)
        sums = _tree_map(lambda s, x: s + np.asarray(x, np.float64)
                         if _floating(s) else s, sums, nxt)
    n = float(len(paths))
    return _tree_map(lambda s, x: (s / n).astype(x.dtype)
                     if _floating(s) else s, sums, acc), step


def main(argv=None) -> str:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--basedir", help="training output dir; averages the "
                                      "newest --last step checkpoints")
    ap.add_argument("--last", type=int, default=5)
    ap.add_argument("--checkpoints", nargs="+",
                    help="explicit checkpoint files (overrides --basedir)")
    ap.add_argument("--output", required=True,
                    help="output path prefix; writes {output}-avg-{step}.pt")
    args = ap.parse_args(argv)

    if args.checkpoints:
        paths = args.checkpoints
    elif args.basedir:
        paths, _ = list_step_checkpoints(args.basedir)
        if len(paths) < 2:
            raise SystemExit(f"need >=2 step checkpoints in {args.basedir}, "
                             f"found {len(paths)}")
        paths = paths[-args.last:]
    else:
        raise SystemExit("pass --basedir or --checkpoints")
    logger.info("averaging %d checkpoints: %s", len(paths),
                [os.path.basename(p) for p in paths])
    kinds = {orbax.is_orbax_dir(p) for p in paths}
    if len(kinds) > 1:
        raise SystemExit("cannot average Orbax directories with .pt files")
    if kinds == {True}:
        params, step = average_orbax(paths)
        out = orbax.save_checkpoint(
            {"params": params, "step": np.asarray(step or 0)}, args.output,
            step or 0, tick_type="avg")
        logger.info("wrote %s", out)
        return out
    blob, step = average_checkpoints(paths)
    out = f"{args.output}-avg-{step}.pt"
    torch.save(blob, out)
    logger.info("wrote %s", out)
    return out


if __name__ == "__main__":
    main()
