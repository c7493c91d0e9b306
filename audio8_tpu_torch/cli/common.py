"""Shared CLI flags of the port (the slice of ``audio8_tpu/cli/common.py``
that serving, CTC training and pretraining share, with the same names and defaults),
plus ``--device``: the entry points run on the CUDA card unless the caller
asks for the CPU."""
from __future__ import annotations

from argparse import ArgumentParser, Namespace

import torch

# Size presets over the post-norm, group-norm topology the port runs
# (``audio8_tpu.cli.common.MODEL_PRESETS``); the other presets select
# topologies that are not ported yet.
MODEL_PRESETS = {
    "base": {},
    "large": {"d_model": 1024, "d_ff": 4096, "num_heads": 16,
              "num_layers": 24, "final_dim": 768},
}
_PRESET_BASE_DEFAULTS = {"d_model": 768, "d_ff": 3072, "num_heads": 12,
                         "num_layers": 12, "final_dim": 256}


def apply_preset(args: Namespace) -> Namespace:
    """Resolve ``--preset``: an explicit size flag always wins; unset ones
    take the preset's value, else the base default. ``final_dim`` (the
    pretraining projection width) only where the parser has the flag."""
    preset = MODEL_PRESETS[args.preset]
    for key, base_value in _PRESET_BASE_DEFAULTS.items():
        if hasattr(args, key) and getattr(args, key) is None:
            setattr(args, key, preset.get(key, base_value))
    return args


def resolve_device(name: str) -> torch.device:
    """``--device`` -> a torch device. ``cuda`` needs a usable card and
    raises without one: nothing falls back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"--device {name}: no usable CUDA device (torch "
                f"{torch.__version__}, CUDA build {torch.version.cuda}); "
                "pass --device cpu to run on the CPU")
        if device.index is not None and device.index >= \
                torch.cuda.device_count():
            raise RuntimeError(f"--device {name}: only "
                               f"{torch.cuda.device_count()} CUDA devices")
    elif device.type != "cpu":
        raise ValueError(f"--device {name}: want cuda[:N] or cpu")
    return device


def add_common_model_args(parser: ArgumentParser) -> None:
    parser.add_argument("--preset", choices=sorted(MODEL_PRESETS),
                        default="base",
                        help="model-size preset; individual size flags "
                             "override it")
    parser.add_argument("--d_model", type=int, default=None)
    parser.add_argument("--d_ff", type=int, default=None)
    parser.add_argument("--num_heads", type=int, default=None)
    parser.add_argument("--num_layers", type=int, default=None)
    parser.add_argument("--target_sample_rate", type=int, default=16_000)
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute (fp32 params)")
    parser.add_argument("--device", default="cuda",
                        help="cuda[:N] (default; raises without a card) "
                             "or cpu")
