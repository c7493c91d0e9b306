"""Summarize a checkpoint the port loads (the JAX package's
``a8t-inspect``): the format, the step, the parameter counts in total,
per top-level name and per dtype, and whether optimizer state is
present, without building a model.

It reads a fairseq ``.pt`` (``{"model": ..., "args": ...}``; the port's
CTC and pretraining checkpoints have this layout) and the port's own
seq2seq or paired ``.pt`` (``{"kind": ..., "model": ...}``), with the
step of a ``...-step-N.pt`` name and the optimizer state of a resume
file beside it (``train/checkpoint.py``), and a HuggingFace
``save_pretrained`` directory (``model.safetensors`` or
``pytorch_model.bin``, read without the ``safetensors`` package).

  python -m audio8_tpu_torch.cli.inspect_checkpoint run/checkpoint-step-40.pt
  python -m audio8_tpu_torch.cli.inspect_checkpoint wav2vec_small.pt --tree
  python -m audio8_tpu_torch.cli.inspect_checkpoint ./hf-wav2vec2-base-960h
"""
from __future__ import annotations

import json
import os
from argparse import ArgumentParser
from collections import defaultdict
from types import SimpleNamespace

import numpy as np
import torch

from audio8_tpu_torch.models.convert_hf import is_hf_dir, read_hf_weights
from audio8_tpu_torch.train.checkpoint import (parse_checkpoint_step,
                                               resume_path)


def _arrays(tensors):
    """Tensors as numpy arrays; bf16 ones, which numpy lacks, as their
    shape and the dtype name."""
    return {k: SimpleNamespace(shape=tuple(v.shape), dtype="bfloat16")
            if v.dtype == torch.bfloat16 else v.numpy()
            for k, v in tensors.items()}


def _load(path: str):
    """-> (format, step, {name: array}, has_opt_state)."""
    if os.path.isdir(path):
        if not is_hf_dir(path):
            raise SystemExit(f"{path}: not a recognizable checkpoint dir")
        return "huggingface save_pretrained", None, _arrays(
            read_hf_weights(path)), False
    if not path.endswith((".pt", ".pth")):
        raise SystemExit(f"{path}: unknown checkpoint format")
    blob = torch.load(path, map_location="cpu", weights_only=False)
    model = blob.get("model", blob) if isinstance(blob, dict) else blob
    if hasattr(model, "state_dict"):
        model = model.state_dict()
    tree = _arrays({k: torch.as_tensor(v) for k, v in model.items()
                    if hasattr(v, "shape")})
    # fairseq keeps optimizer state under 'last_optimizer_state' (and
    # 'optimizer_history'), plain torch loops under 'optimizer'; the
    # port's trainers in the resume file beside the checkpoint
    has_opt = (isinstance(blob, dict) and any(
        k in blob for k in ("optimizer", "last_optimizer_state",
                            "optimizer_history"))) or os.path.exists(
        resume_path(path))
    if isinstance(blob, dict) and "kind" in blob:
        fmt = f"audio8_tpu_torch {blob['kind']} .pt"
    else:
        fmt = "fairseq/torch .pt"
    step = parse_checkpoint_step(path) if "-step-" in path else None
    return fmt, step, tree, has_opt


def main(argv=None):
    p = ArgumentParser(description=__doc__)
    p.add_argument("checkpoint")
    p.add_argument("--tree", action="store_true",
                   help="print every leaf path with shape/dtype")
    p.add_argument("--json", action="store_true",
                   help="machine-readable summary on stdout")
    args = p.parse_args(argv)

    fmt, step, tree, has_opt = _load(args.checkpoint)
    leaves = list(tree.items())  # file order, as JAX's ties keep it
    total = sum(int(np.prod(a.shape)) for _, a in leaves)
    by_module = defaultdict(int)
    by_dtype = defaultdict(int)
    for name, a in leaves:
        by_module[name] += int(np.prod(a.shape))
        by_dtype[str(a.dtype)] += int(np.prod(a.shape))

    summary = {
        "checkpoint": args.checkpoint,
        "format": fmt,
        "step": step,
        "leaves": len(leaves),
        "total_params": total,
        "optimizer_state": has_opt,
        "by_dtype": dict(sorted(by_dtype.items())),
        "by_module": dict(sorted(by_module.items(),
                                 key=lambda kv: -kv[1])),
    }
    if args.json:
        print(json.dumps(summary, indent=1))
    else:
        print(f"format:          {fmt}")
        print(f"step:            {step if step is not None else 'n/a'}")
        print(f"leaves:          {len(leaves)}")
        print(f"total params:    {total:,} ({total / 1e6:.1f}M)")
        print(f"optimizer state: {'yes' if has_opt else 'no'}")
        print("dtypes:          "
              + ", ".join(f"{k}={v:,}" for k, v in sorted(by_dtype.items())))
        print("by module:")
        for mod, n in sorted(by_module.items(), key=lambda kv: -kv[1]):
            print(f"  {mod:40s} {n:>14,} ({100 * n / max(total, 1):5.1f}%)")
        if args.tree:
            print("leaves:")
            for name, a in sorted(leaves):
                print(f"  {name:60s} {str(a.shape):20s} {a.dtype}")
    return summary


if __name__ == "__main__":
    main()
