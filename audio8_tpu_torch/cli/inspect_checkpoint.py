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
``pytorch_model.bin``, read without the ``safetensors`` package), and the
JAX package's Orbax directories (``train/orbax.py``; a run's directory
gives its latest checkpoint), whose leaves are named by their key paths
and counted by their first key, as the JAX tool does.

  python -m audio8_tpu_torch.cli.inspect_checkpoint run/checkpoint-step-40.pt
  python -m audio8_tpu_torch.cli.inspect_checkpoint wav2vec_small.pt --tree
  python -m audio8_tpu_torch.cli.inspect_checkpoint ./hf-wav2vec2-base-960h
  python -m audio8_tpu_torch.cli.inspect_checkpoint runs/ctc/checkpoint-step-320
"""
from __future__ import annotations

import json
import os
from argparse import ArgumentParser
from collections import defaultdict
from types import SimpleNamespace

import numpy as np
import torch

from audio8_tpu_torch.models.convert import tree_paths
from audio8_tpu_torch.models.convert_hf import is_hf_dir, read_hf_weights
from audio8_tpu_torch.train import orbax
from audio8_tpu_torch.train.checkpoint import (find_latest_checkpoint,
                                               parse_checkpoint_step,
                                               resume_path)


def _arrays(tensors):
    """Tensors as numpy arrays; bf16 ones, which numpy lacks, as their
    shape and the dtype name."""
    return {k: SimpleNamespace(shape=tuple(v.shape), dtype="bfloat16")
            if v.dtype == torch.bfloat16 else v.numpy()
            for k, v in tensors.items()}


def _orbax(path: str):
    """An Orbax directory -> (format, step, {"a/b": array}, has_opt_state)
    as the JAX tool reads it: the params (the tree's ``params`` or the
    tree), the step of the name."""
    raw = orbax.load_checkpoint(path)
    params = raw.get("params", raw) if isinstance(raw, dict) else raw
    has_opt = isinstance(raw, dict) and any(
        k in raw for k in ("opt_state", "mu", "nu"))
    tree = {}
    for p in tree_paths(params):
        node = params
        for k in p:
            node = node[k]
        if isinstance(node, torch.Tensor):  # bfloat16
            tree["/".join(p)] = _arrays({"": node})[""]
        elif hasattr(node, "shape"):
            tree["/".join(p)] = node
    return "a8t (Orbax)", parse_checkpoint_step(path), tree, has_opt


def _load(path: str):
    """-> (format, step, {name: array}, has_opt_state)."""
    if os.path.isdir(path):
        if is_hf_dir(path):
            return "huggingface save_pretrained", None, _arrays(
                read_hf_weights(path)), False
        if orbax.is_orbax_dir(path):
            return _orbax(path)
        if not any(n.startswith("checkpoint") for n in os.listdir(path)):
            raise SystemExit(f"{path}: not a recognizable checkpoint dir")
        path, step = find_latest_checkpoint(path)
        if orbax.is_orbax_dir(path):
            fmt, _, tree, has_opt = _orbax(path)
            return fmt, step, tree, has_opt
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
        # an Orbax leaf's first key (a .pt's names hold no "/")
        by_module[name.split("/")[0]] += int(np.prod(a.shape))
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
