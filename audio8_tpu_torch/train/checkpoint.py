"""Checkpoints of the port's trainers.

A CTC or pretraining checkpoint is a fairseq-layout ``.pt``
(``{base}-step-N.pt``, ``models/convert.py``), which the JAX package
reads with ``load_fairseq_bin``; a seq2seq or paired one is the port's
own ``.pt``, ``{"kind": kind, "model": state_dict}`` (no fairseq layout
holds a decoder or a text tower). Beside each is a resume file
(``{base}-step-N.resume``, torch state dicts) that holds what a
restart needs to continue the same run: the optimizer (``adamw`` with
its moments, or ``sgd``) and its step count (the LR schedule's
position), the trainer's step (in pretraining also the Gumbel
temperature's), the parameter names and the model kind.
Orbax checkpoints of the JAX package do not cross; the two packages meet
through the fairseq ``.pt``.
"""
from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import torch

from audio8_tpu_torch.models.convert import (save_fairseq_ctc,
                                             save_fairseq_pretrained)

RESUME_SUFFIX = ".resume"
KINDS = ("ctc", "pretrain", "seq2seq", "paired")
FAIRSEQ_KINDS = ("ctc", "pretrain")


def parse_checkpoint_step(path: str) -> int:
    """The step in a ``...-step-N`` or ``...-step-N.pt`` name, else 0."""
    m = re.search(r"-step-(\d+)(\.pt)?/?$", path.rstrip("/"))
    return int(m.group(1)) if m else 0


def find_latest_checkpoint(ckpt_dir: str) -> Tuple[str, int]:
    """The latest ``checkpoint-step-N.pt`` under ``ckpt_dir`` -> (path,
    N)."""
    best, best_step = None, -1
    pat = re.compile(r"checkpoint-step-(\d+)\.pt$")
    for name in os.listdir(ckpt_dir):
        m = pat.match(name)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(ckpt_dir, name), int(m.group(1))
    if best is None:
        raise FileNotFoundError(f"No checkpoints under {ckpt_dir}")
    return best, best_step


def resume_path(checkpoint: str) -> str:
    """The resume file beside a ``.pt`` checkpoint."""
    return os.path.splitext(checkpoint)[0] + RESUME_SUFFIX


def save_checkpoint(state, path: str, kind: str) -> str:
    """Write ``state.model`` at ``path`` (a fairseq ``.pt``, CTC or
    pretrained, or the port's own seq2seq or paired ``.pt``, by ``kind``)
    and the resume file beside it."""
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r}: want one of {KINDS}")
    if kind in FAIRSEQ_KINDS:
        save = (save_fairseq_ctc if kind == "ctc"
                else save_fairseq_pretrained)
        save(state.model, path)
    else:
        torch.save({"kind": kind, "model": {
            k: v.detach().cpu() for k, v in state.model.state_dict().items()}},
            path)
    opt = state.opt_state
    blob = {"kind": kind, "step": int(state.step), "count": int(opt.count),
            "names": list(state.names), "optim": _optim_name(opt)}
    if blob["optim"] == "adamw":
        for key in ("mu", "nu"):
            blob[key] = {n: m.detach().cpu()
                         for n, m in zip(state.names, getattr(opt, key))}
    torch.save(blob, resume_path(path))
    return path


def _optim_name(opt_state) -> str:
    return "adamw" if hasattr(opt_state, "mu") else "sgd"


def load_resume(state, checkpoint: str, kind: str) -> Optional[int]:
    """Restore the optimizer state (the AdamW moments, or SGD's count
    alone) and step count of ``state`` from the resume file beside
    ``checkpoint`` when there is one of this ``kind``, of the same
    optimizer, over the same parameters (names and shapes); returns its
    step, else ``None`` and ``state`` is untouched."""
    path = resume_path(checkpoint)
    if not os.path.exists(path):
        return None
    blob = torch.load(path, map_location="cpu", weights_only=True)
    optim = blob.get("optim", "adamw")
    if blob["kind"] != kind or blob["names"] != list(state.names) \
            or optim != _optim_name(state.opt_state) \
            or (optim == "adamw" and any(
                blob["mu"][n].shape != p.shape
                for n, p in zip(state.names, state.params))):
        return None
    state.load_opt_state(blob["count"], blob.get("mu"), blob.get("nu"))
    state.step = int(blob["step"])
    return state.step


def load_port_checkpoint(path: str, kind: str) -> Optional[dict]:
    """The state dict of a seq2seq or paired ``.pt`` the port wrote, if
    ``path`` is one of this ``kind``, else ``None``."""
    try:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:  # a fairseq file holds more than tensors
        return None
    if isinstance(blob, dict) and blob.get("kind") == kind:
        return blob["model"]
    return None
