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

  python -m audio8_tpu_torch.cli.convert_checkpoint --input wav2vec_small.pt \\
      --output converted/checkpoint
  python -m audio8_tpu_torch.cli.convert_checkpoint --ctc true \\
      --input ./hf-wav2vec2-large-960h-lv60-self --output converted/ctc
"""
from __future__ import annotations

import dataclasses
import logging
import os
from argparse import ArgumentParser

import torch

from audio8_tpu_torch.cli.common import (add_common_model_args,
                                        apply_preset, check_ported,
                                        encoder_kwargs)
from audio8_tpu_torch.config import AcousticConfig, PretrainConfig
from audio8_tpu_torch.models.convert import (FAIRSEQ_ENCODER,
                                             from_fairseq_ctc_state,
                                             from_fairseq_pretrained_state,
                                             read_fairseq_state,
                                             save_fairseq_ctc,
                                             save_fairseq_pretrained)
from audio8_tpu_torch.models.convert_hf import (acoustic_config_from_hf,
                                                is_hf_dir, load_hf_dir)
from audio8_tpu_torch.models.wav2vec2 import (Wav2Vec2AcousticModel,
                                              Wav2Vec2Model)
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
    parser.add_argument("--format", choices=["auto", "fairseq", "hf"],
                        default="auto")
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
        fmt = "hf" if is_hf_dir(args.input) else "fairseq"
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
    if args.ctc:
        model = Wav2Vec2AcousticModel(AcousticConfig(
            num_labels=args.num_labels, **size))
        if fmt != "hf":
            state, ignored = from_fairseq_ctc_state(
                read_fairseq_state(args.input))
            unexpected = [k for k in ignored
                          if not k.startswith(_CTC_LEFTOVERS)]
        save = save_fairseq_ctc
    else:
        if fmt != "hf":
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
    path = os.path.abspath(f"{args.output}-step-0.pt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save(model, path)
    logger.info("Wrote %s", path)
    return path


if __name__ == "__main__":
    main()
