"""Checkpoints of the port's trainers.

A CTC, pretraining, HuBERT or data2vec checkpoint is a fairseq-layout
``.pt`` (``{base}-step-N.pt``, ``models/convert.py``; HuBERT's and
data2vec's carry fairseq's head names, ``final_proj`` and
``label_embs_concat``), which the JAX package reads with
``load_fairseq_bin``; data2vec also writes its EMA teacher beside the
student as ``teacher-step-N.pt`` (the same layout, no resume file;
:func:`load_teacher`); a seq2seq, paired or transducer one is
the port's own ``.pt``, ``{"kind": kind, "model": state_dict}`` (no
fairseq layout holds a decoder, a text tower or a predictor), and so is
a text LM's (kind ``lm``, ``cli/train_lm.py``). Beside each is a
resume file (``{base}-step-N.resume``, torch state dicts) that holds what a
restart needs to continue the same run: the optimizer (``adamw`` with
its moments, or ``sgd``) and its step count (the LR schedule's
position), the trainer's step (in pretraining also the Gumbel
temperature's), the parameter names, the model kind, and the JAX
optimizer (``create_optimizer``'s name) with its hyperparameters.

An Orbax directory (``{base}-step-N`` with a ``_METADATA`` file) is a
checkpoint of the JAX package, read by ``train/orbax.py`` with the
port's own zstd, OCDBT and zarr readers: a run's directory may hold
both kinds, and :func:`find_latest_checkpoint` takes the newer.
``cli.convert_checkpoint --output_format orbax`` writes one back for
the JAX package.
"""
from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import torch

from audio8_tpu_torch.models.convert import (load_fairseq_pretrained,
                                             load_jax_params,
                                             save_fairseq_ctc,
                                             save_fairseq_pretrained)
from audio8_tpu_torch.train import orbax

RESUME_SUFFIX = ".resume"
KINDS = ("ctc", "pretrain", "hubert", "data2vec", "seq2seq", "paired",
         "transducer", "lm")
FAIRSEQ_KINDS = ("ctc", "pretrain", "hubert", "data2vec")
TEACHER_BASE = "teacher"


def parse_checkpoint_step(path: str) -> int:
    """The step in a ``...-step-N`` or ``...-step-N.pt`` name, else 0."""
    m = re.search(r"-step-(\d+)(\.pt)?/?$", path.rstrip("/"))
    return int(m.group(1)) if m else 0


def find_latest_checkpoint(ckpt_dir: str, base: str = "checkpoint"
                           ) -> Tuple[str, int]:
    """The latest checkpoint under ``ckpt_dir`` -> (path, N): the port's
    ``{base}-step-N.pt`` or the JAX package's Orbax directory
    ``{base}-step-N``, whichever has the higher step. Both kinds at that
    step raise ``ValueError`` naming both."""
    found = {}
    pat = re.compile(re.escape(base) + r"-step-(\d+)(\.pt)?$")
    for name in os.listdir(ckpt_dir):
        m = pat.match(name)
        path = os.path.join(ckpt_dir, name)
        if m and (m.group(2) or orbax.is_orbax_dir(path)):
            found.setdefault(int(m.group(1)), []).append(path)
    if not found:
        raise FileNotFoundError(f"No checkpoints under {ckpt_dir}")
    step = max(found)
    if len(found[step]) > 1:
        raise ValueError(f"two checkpoints at step {step}: "
                         f"{sorted(found[step])}; remove one")
    return found[step][0], step


def resume_path(checkpoint: str) -> str:
    """The resume file beside a ``.pt`` checkpoint."""
    return os.path.splitext(checkpoint)[0] + RESUME_SUFFIX


def save_checkpoint(state, path: str, kind: str) -> str:
    """Write ``state.model`` at ``path`` (a fairseq ``.pt``, CTC or
    pretrained, or the port's own seq2seq, paired, transducer or LM
    ``.pt``, by ``kind``)
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
            "names": list(state.names), "optim": _optim_name(opt),
            "jax_optim": state.tx.optim, "hyper": optim_hyper(state)}
    if blob["optim"] == "adamw":
        for key in ("mu", "nu"):
            blob[key] = {n: m.detach().cpu()
                         for n, m in zip(state.names, getattr(opt, key))}
    torch.save(blob, resume_path(path))
    return path


def load_teacher(teacher: torch.nn.Module,
                 restart_from: str) -> Optional[str]:
    """Load the latest teacher checkpoint beside ``restart_from`` (a run's
    directory or a checkpoint in it) into ``teacher``, as the JAX
    entry point's ``find_latest_checkpoint(..., base="teacher")`` restores it:
    the port's ``teacher-step-N.pt`` or the JAX package's Orbax
    ``teacher-step-N`` (a params tree); returns its path, or ``None`` when
    there is none (the teacher then stays the student's copy)."""
    directory = (restart_from if os.path.isdir(restart_from)
                 and not orbax.is_orbax_dir(restart_from)
                 else os.path.dirname(restart_from.rstrip("/")))
    try:
        path, _ = find_latest_checkpoint(directory or ".", TEACHER_BASE)
    except (FileNotFoundError, OSError):
        return None
    if orbax.is_orbax_dir(path):
        load_model_weights(path, teacher, "data2vec")
        return path
    state = load_fairseq_pretrained(path)
    teacher.load_state_dict({k: state[k].to(v.dtype) for k, v in
                             teacher.state_dict().items()}, strict=True)
    return path


def optim_hyper(state) -> dict:
    """The optimizer's hyperparameters a JAX optimizer state keeps
    (``models/convert.py:jax_opt_state``): the betas, eps, weight decay
    and the schedule's rate at the last update."""
    tx = state.tx
    count = int(state.opt_state.count)
    return {"b1": getattr(tx, "b1", 0.9), "b2": getattr(tx, "b2", 0.999),
            "eps": getattr(tx, "eps", 1e-8),
            "weight_decay": getattr(tx, "weight_decay", 0.0),
            "learning_rate": float(tx.lr_schedule(max(count - 1, 0)))}


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


def load_model_weights(path: str, model: torch.nn.Module, kind: str) -> None:
    """Load the port's own ``.pt`` of ``kind``, or a JAX Orbax
    checkpoint's params tree (exactly the model's leaves, as the JAX
    entry points apply it), into ``model``."""
    if orbax.is_orbax_dir(path):
        tree = orbax.load_checkpoint(path)
        load_jax_params(tree.get("params", tree), model, strict=True)
        return
    weights = load_port_checkpoint(path, kind)
    if weights is None:
        raise ValueError(f"{path} is not a {kind} checkpoint of the port")
    model.load_state_dict(weights, strict=True)


def load_port_checkpoint(path: str, kind: str) -> Optional[dict]:
    """The state dict of a seq2seq, paired, transducer or LM ``.pt`` the
    port wrote, if
    ``path`` is one of this ``kind``, else ``None``."""
    try:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:  # a fairseq file holds more than tensors
        return None
    if isinstance(blob, dict) and blob.get("kind") == kind:
        return blob["model"]
    return None
