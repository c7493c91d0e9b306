"""Offline checkpoint converter of the port (``a8t-convert`` on PyTorch).

Counterpart of ``audio8_tpu/cli/convert_checkpoint.py``: it builds the
matching port model (``--ctc`` for a fine-tuned CTC checkpoint, else the
pretraining model), maps the source state dict onto it, raises if any
source key has no place in the model or any model key is missing from
the source, and writes the port's own ``.pt`` (``{output}-step-0.pt``,
which ``--restart_from``, ``cli.test`` and ``cli.transcribe`` read).
The source is a fairseq ``.pt`` or, with ``--format hf`` (the default
for a directory with ``config.json``), a HuggingFace ``save_pretrained``
directory, whose config gives the sizes and the topology
(``models/convert_hf.py``). The conversion runs on the host;
``--device`` is inert.

The JAX package's Orbax checkpoints cross both ways (``train/orbax.py``):

- ``--format orbax`` (the default for a directory with ``_METADATA``)
  reads one, a CTC or pretraining params tree or TrainState, and writes
  the port's ``{output}-step-N.pt`` at its step; a TrainState's
  optimizer state (``adamw``, ``adam``, ``fused_adamw`` or ``sgd``) goes
  into the ``.resume`` file beside it, so ``--restart_from`` resumes it;
- ``--output_format orbax`` writes an Orbax directory in place of the
  ``.pt`` (the default stays ``pt``): from a fairseq ``.pt`` or an HF
  directory, what the JAX converter writes (``{"params": tree}`` at step
  0); from the port's own checkpoint with its resume file, the whole
  TrainState (params, the JAX layout of ``create_optimizer``'s state
  with the moments and count, step) at its step, which the JAX trainer's
  ``--restart_from`` restores whole.

  python -m audio8_tpu_torch.cli.convert_checkpoint --input wav2vec_small.pt \\
      --output converted/checkpoint
  python -m audio8_tpu_torch.cli.convert_checkpoint --ctc true \\
      --input ./hf-wav2vec2-large-960h-lv60-self --output converted/ctc
  python -m audio8_tpu_torch.cli.convert_checkpoint --ctc true \\
      --input run/checkpoint-step-40.pt --output jax/checkpoint \\
      --output_format orbax
"""
from __future__ import annotations

import dataclasses
import logging
import os
from argparse import ArgumentParser

import numpy as np
import torch

from audio8_tpu_torch.cli.common import (add_common_model_args,
                                        apply_preset, check_ported,
                                        encoder_kwargs)
from audio8_tpu_torch.config import AcousticConfig, PretrainConfig
from audio8_tpu_torch.models.convert import (FAIRSEQ_ENCODER,
                                             _field, from_fairseq_ctc_state,
                                             from_fairseq_pretrained_state,
                                             jax_from_params, jax_opt_state,
                                             jax_optim, params_from_jax,
                                             read_fairseq_state,
                                             save_fairseq_ctc,
                                             save_fairseq_pretrained)
from audio8_tpu_torch.models.convert_hf import (acoustic_config_from_hf,
                                                is_hf_dir, load_hf_dir)
from audio8_tpu_torch.models.wav2vec2 import (Wav2Vec2AcousticModel,
                                              Wav2Vec2Model)
from audio8_tpu_torch.train import orbax
from audio8_tpu_torch.train.checkpoint import (parse_checkpoint_step,
                                               resume_path, save_checkpoint)
from audio8_tpu_torch.train.optim import TrainState, create_optimizer
from audio8_tpu_torch.utils import str2bool

logger = logging.getLogger("audio8_tpu_torch.convert")

# modules a fine-tuned fairseq checkpoint may carry from pretraining, which
# the CTC model has no place for (as the JAX converter allows)
_CTC_LEFTOVERS = (FAIRSEQ_ENCODER + "quantizer", FAIRSEQ_ENCODER + "project_q")


def parse_args(argv=None):
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--input", required=True,
                        help="fairseq .pt file or HF save_pretrained dir")
    parser.add_argument("--output", required=True,
                        help="output checkpoint base")
    parser.add_argument("--format", choices=["auto", "fairseq", "hf",
                                             "orbax"], default="auto")
    parser.add_argument("--output_format", choices=["pt", "orbax"],
                        default="pt",
                        help="the port's .pt, or an Orbax directory the "
                             "JAX package restores")
    parser.add_argument("--ctc", type=str2bool, default=False,
                        help="fine-tuned CTC checkpoint (vs pretrained)")
    parser.add_argument("--num_labels", type=int, default=32)
    add_common_model_args(parser)
    return apply_preset(parser.parse_args(argv))


def main(argv=None) -> str:
    """Convert; returns the written path."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    check_ported(args, "convert_checkpoint")
    fmt = args.format
    if fmt == "auto":
        fmt = ("orbax" if orbax.is_orbax_dir(args.input) else
               "hf" if is_hf_dir(args.input) else "fairseq")
    sr = args.target_sample_rate // 1000
    size = dict(sample_rate=sr, d_model=args.d_model,
                num_heads=args.num_heads, num_layers=args.num_layers,
                d_ff=args.d_ff, **encoder_kwargs(args))
    if fmt == "hf":
        state, report = load_hf_dir(args.input, ctc=args.ctc)
        if report["missing"] or report["unexpected"]:
            raise ValueError(f"Unmapped checkpoint keys: missing "
                             f"{report['missing'][:8]}, unexpected "
                             f"{report['unexpected'][:8]}")
        # sizes and topology come from the HF config, not the flags
        hf = acoustic_config_from_hf(report["hf_config"], report["topology"])
        size = {k: v for k, v in dataclasses.asdict(hf).items()
                if k != "num_labels"}
        if args.ctc:
            args.num_labels = hf.num_labels
        unexpected = []
    if fmt == "orbax":
        tree = orbax.load_checkpoint(args.input)
        state = params_from_jax(tree.get("params", tree))
        args.ctc, unexpected = "proj.weight" in state, []
        if args.ctc:
            args.num_labels = state["proj.weight"].shape[0]
    if args.ctc:
        model = Wav2Vec2AcousticModel(AcousticConfig(
            num_labels=args.num_labels, **size))
        if fmt not in ("hf", "orbax"):
            state, ignored = from_fairseq_ctc_state(
                read_fairseq_state(args.input))
            unexpected = [k for k in ignored
                          if not k.startswith(_CTC_LEFTOVERS)]
        save = save_fairseq_ctc
    else:
        if fmt not in ("hf", "orbax"):
            state = from_fairseq_pretrained_state(
                read_fairseq_state(args.input))
        # the projection and codebook sizes come from the checkpoint
        # (two codebook groups, as every wav2vec 2.0 recipe has)
        model = Wav2Vec2Model(PretrainConfig(
            final_dim=state["final_proj.weight"].shape[0],
            num_vq_vars=state["quantizer.vars"].shape[0] // 2,
            num_vq_groups=2, **size))
        unexpected = []
        save = save_fairseq_pretrained
    target = model.state_dict()
    unexpected += [k for k in state if k not in target]
    missing = [k for k in target if k not in state]
    if missing or unexpected:
        raise ValueError(f"Unmapped checkpoint keys: missing {missing[:8]}, "
                         f"unexpected {unexpected[:8]}")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()},
                          strict=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    if args.output_format == "orbax":
        path = to_orbax(model, args.input if fmt == "fairseq" else None,
                        args.output)
    elif fmt == "orbax":
        path = from_orbax(model, tree, args.input, args.output,
                          "ctc" if args.ctc else "pretrain")
    else:
        path = os.path.abspath(f"{args.output}-step-0.pt")
        save(model, path)
    logger.info("Wrote %s", path)
    return path


def from_orbax(model, tree, source: str, output: str, kind: str) -> str:
    """The port's ``{output}-step-N.pt`` of ``model`` (the Orbax tree's
    weights), with a resume file of the tree's optimizer state when it is
    a TrainState; N is its saved step, else the step of its name."""
    opt = tree.get("opt_state") if isinstance(tree, dict) else None
    optim = jax_optim(opt) if opt is not None else None
    if optim is None:
        step = parse_checkpoint_step(source)
        path = os.path.abspath(f"{output}-step-{step}.pt")
        (save_fairseq_ctc if kind == "ctc" else save_fairseq_pretrained)(
            model, path)
        return path
    _, (count, mu, nu) = params_from_jax(tree["params"], opt)
    hyper = _field(opt, "hyperparams") or {}
    rate = float(np.asarray(hyper.get("learning_rate", 0.0)))
    tx = create_optimizer(lambda _: rate, optim, **{
        name: float(np.asarray(hyper[key])) for key, name in (
            ("weight_decay", "weight_decay"), ("b1", "beta1"),
            ("b2", "beta2"), ("eps", "eps")) if key in hyper})
    state = TrainState(model, tx)
    state.load_opt_state(count, mu, nu)
    state.step = int(np.asarray(tree["step"]))
    return save_checkpoint(state, os.path.abspath(
        f"{output}-step-{state.step}.pt"), kind)


def to_orbax(model, source, output: str) -> str:
    """``model`` as an Orbax directory: with the port's resume file beside
    ``source`` (over this model's parameters), the whole TrainState at
    its step; else ``{"params": tree}`` at step 0, as the JAX converter
    writes."""
    resume = resume_path(source) if source else None
    if resume is None or not os.path.exists(resume):
        return orbax.save_checkpoint({"params": jax_from_params(model)},
                                     output, 0)
    blob = torch.load(resume, map_location="cpu", weights_only=True)
    if blob["names"] != [n for n, _ in model.named_parameters()]:
        raise ValueError(f"{resume}: the resume file is not this model's")
    mu = nu = None
    if blob["optim"] == "adamw":
        mu = jax_from_params(model, blob["mu"])
        nu = jax_from_params(model, blob["nu"])
    opt = jax_opt_state(blob.get("jax_optim", blob["optim"]), blob["count"],
                        mu, nu, **blob.get("hyper", {}))
    return orbax.save_checkpoint(
        {"params": jax_from_params(model), "opt_state": opt,
         "step": np.asarray(blob["step"], np.int32)}, output, blob["step"])


if __name__ == "__main__":
    main()
