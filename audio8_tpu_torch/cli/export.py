"""Export CLI of the port (``a8t-export`` on PyTorch): checkpoint ->
``torch.export`` inference artifact.

Counterpart of ``audio8_tpu/cli/export.py``: traces the CTC acoustic
forward (or, with ``--pooled``, the utterance-embedding encoder) through
``torch.export`` into a versioned artifact directory
(``audio8_tpu_torch/export.py`` has the layout) that ``cli.transcribe
--exported``, ``cli.serve --exported``, ``cli.test --exported`` and
``cli.embed --exported`` run without the model code, the checkpoint
readers or the build flags.

Each entry is batch-polymorphic at a fixed sample count, one per
``--seconds`` value (``int(seconds * rate)`` samples: ``--lane_align``,
the TPU's 128-lane snap, parses and is ignored) and per ``--platforms``
value (``cpu`` and ``cuda``, both by default; a ``cuda`` entry is traced
on the card and needs one). The model is built on ``--device`` (the
card by default; it raises without one).

  python -m audio8_tpu_torch.cli.export --checkpoint ctc.pt \\
      --dict_file dict.ltr.txt --output model.a8x --seconds 5 30
  python -m audio8_tpu_torch.cli.serve --exported model.a8x --port 8000
  python -m audio8_tpu_torch.cli.export --device cpu --platforms cpu ...

``--transducer true`` exports a ``cli.train_transducer`` checkpoint as
the three streaming-decode entries (``audio8_tpu_torch/export.py``): the
encoder over one ``--seconds`` chunk, the decode init, and the greedy
search over one frame, which the loader runs over ``--window_frames``
frame windows with a ``--max_decode_len`` label budget.
"""
from __future__ import annotations

import logging
from argparse import ArgumentParser

import torch

from audio8_tpu_torch.cli.common import (add_common_model_args,
                                        apply_preset, check_ported,
                                        resolve_device)
from audio8_tpu_torch.export import (PLATFORMS, export_forward,
                                     export_program, save_artifact,
                                     state_fn)
from audio8_tpu_torch.utils import str2bool

logger = logging.getLogger("audio8_tpu_torch.export")


def parse_args(argv=None):
    p = ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", required=True,
                   help="fairseq .pt, HF dir, or the port's paired .pt "
                        "(--pooled)")
    p.add_argument("--dict_file",
                   help="fairseq dict.ltr.txt or HF vocab.json (required "
                        "except for --pooled embedding exports)")
    p.add_argument("--output", required=True, help="artifact directory")
    p.add_argument("--seconds", type=float, nargs="+", default=[30.0],
                   help="exported window length(s); one entry per value")
    p.add_argument("--lane_align", type=str2bool, default=True,
                   help="the TPU's 128-lane snap: parses, ignored")
    p.add_argument("--platforms", nargs="+", default=list(PLATFORMS),
                   help="devices to trace an entry for: cpu, cuda")
    p.add_argument("--quantize", choices=["none", "int8"], default="none",
                   help="int8: post-training weight quantization before "
                        "export (ops/quant.py)")
    p.add_argument("--pooled", type=str2bool, default=False,
                   help="export the pooled utterance-embedding encoder "
                        "(cli.embed's surface): entries return (B, D) "
                        "L2-normalized embeddings")
    p.add_argument("--reduction_type", default="mean",
                   choices=["mean", "max", "sha", "sha_max", "sha_mean",
                            "2ha", "2ha_max", "2ha_mean"],
                   help="utterance pooling baked into a --pooled export")
    p.add_argument("--transducer", type=str2bool, default=False,
                   help="export a cli.train_transducer checkpoint: the "
                        "encoder chunk, the decode init and the one-frame "
                        "greedy search that serve.TransducerStreamer "
                        "drives")
    p.add_argument("--pred_layers", type=int, default=2)
    p.add_argument("--pred_dim", type=int, default=512)
    p.add_argument("--pred_embed_dim", type=int, default=256)
    p.add_argument("--d_joint", type=int, default=512)
    p.add_argument("--window_frames", type=int, default=256)
    p.add_argument("--max_decode_len", type=int, default=8_000)
    p.add_argument("--max_symbols_per_frame", type=int, default=4)
    add_common_model_args(p)
    args = apply_preset(p.parse_args(argv))
    if args.transducer and args.pooled:
        raise SystemExit("--transducer and --pooled are exclusive")
    if (args.transducer or args.pooled) and args.quantize != "none":
        raise SystemExit("--quantize int8 is a CTC-path export option")
    check_ported(args, "export")
    if not args.pooled and not args.dict_file:
        raise SystemExit("--dict_file is required (except with --pooled)")
    unknown = sorted(set(args.platforms) - set(PLATFORMS))
    if unknown:
        raise SystemExit(f"--platforms {' '.join(unknown)}: the port traces "
                         f"for {' and '.join(PLATFORMS)} (a TPU runs the "
                         "JAX package's export)")
    return args


def _platform_device(platform: str, device: torch.device) -> torch.device:
    """Where a platform's entry is traced: the CPU, or the card
    (``--device`` when it is one)."""
    if platform == "cpu":
        return torch.device("cpu")
    return device if device.type == "cuda" else resolve_device("cuda")


def _build(args, device: torch.device):
    """``(model, head, meta)``: the model with the checkpoint's weights in
    eval mode on ``device``, the map from its outputs to the entry's
    outputs, and the kind's metadata."""
    if args.pooled:
        from audio8_tpu_torch.cli.embed import build_pooled, normalized

        cfg, model = build_pooled(args, device)
        return model, normalized, {
            "kind": "embed",
            "conv_features": [list(f) for f in cfg.conv_features],
            "sample_rate": args.target_sample_rate, "d_model": cfg.d_model,
            "num_layers": cfg.num_layers,
            "reduction_type": args.reduction_type}
    from audio8_tpu_torch.cli.transcribe import build_acoustic

    cfg, model, vocab_list, _ = build_acoustic(args, device)
    return model, lambda out: (out[0], out[1].sum(dim=-1)), {
        "kind": "ctc", "vocab": vocab_list,
        "conv_features": [list(f) for f in cfg.conv_features],
        "sample_rate": args.target_sample_rate, "d_model": cfg.d_model,
        "num_layers": cfg.num_layers, "quantize": args.quantize}


def _export_transducer(args, device: torch.device, traced_on: dict):
    """The RNN-T artifact: per platform an ``encode`` entry (symbolic
    batch, one chunk of ``--seconds``), ``decode_init`` and the one-frame
    ``decode_frames`` (batch 1, ``--max_decode_len`` labels)."""
    from audio8_tpu_torch.cli.transcribe import build_transducer
    from audio8_tpu_torch.models.text import read_vocab_list

    if len(args.seconds) != 1:
        raise SystemExit("--transducer exports ONE encoder-chunk window; "
                         f"pass a single --seconds value (got "
                         f"{args.seconds})")
    cfg, model, _ = build_transducer(args, device)  # fairseq specials
    vocab_list = read_vocab_list(args.dict_file)
    sr = args.target_sample_rate
    t = int(args.seconds[0] * sr)
    budget, dt = args.max_decode_len, model.compute_dtype
    encode = state_fn(model, lambda out: (out[0].float(), out[1]),
                      "encode")
    init_fn = state_fn(model, method="decode_init")
    body = state_fn(model, method="decode_frames")

    def init(state):
        return init_fn(state, 1)

    def frame(state, enc, n_frames, tokens, n, pred_out, carry):
        return body(state, enc.to(dt), n_frames, tokens, n, pred_out, carry,
                    args.max_symbols_per_frame)

    entries, flat = [], None
    for platform in args.platforms:
        on = traced_on[platform]
        model.to(on)
        state = model.state_dict()
        names, flat = list(state), list(state.values())
        logger.info("exporting transducer entries on %s: chunk t=%d, "
                    "window=%d, label budget=%d", on, t, args.window_frames,
                    budget)
        entries.append({"role": "encode", "t": t, "platform": platform,
                        "program": export_forward(encode, names, flat, t,
                                                  on)})
        entries.append({"role": "decode_init", "platform": platform,
                        "program": export_program(init, names, flat, ())})
        with torch.no_grad():
            pred_out, carry = model.decode_init(1, on)
        example = (torch.zeros((1, 1, cfg.d_model), device=on),
                   torch.ones((1,), dtype=torch.int32, device=on),
                   torch.zeros((1, budget), dtype=torch.int32, device=on),
                   torch.zeros((1,), dtype=torch.int32, device=on),
                   pred_out, carry)
        entries.append({"role": "decode_frames", "platform": platform,
                        "program": export_program(frame, names, flat,
                                                  example)})
    meta = {"kind": "transducer", "vocab": vocab_list,
            "conv_features": [list(f) for f in cfg.conv_features],
            "sample_rate": sr, "d_model": cfg.d_model,
            "num_layers": cfg.num_layers,
            "window_frames": args.window_frames, "max_output_len": budget,
            "max_symbols_per_frame": args.max_symbols_per_frame,
            "bf16": bool(args.bf16), "platforms": list(args.platforms),
            "checkpoint": args.checkpoint}
    save_artifact(args.output, flat, meta, entries)
    logger.info("wrote %s: transducer artifact, %d params", args.output,
                len(flat))
    return args.output


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    traced_on = {p: _platform_device(p, device) for p in args.platforms}
    if args.transducer:
        return _export_transducer(args, device, traced_on)
    model, head, meta = _build(args, device)
    kwargs = {"freeze": False} if args.pooled else {}
    fn = state_fn(model, head, **kwargs)
    sr = args.target_sample_rate
    sizes = sorted({int(s * sr) for s in args.seconds})
    entries, flat = [], None
    for platform in args.platforms:
        model.to(traced_on[platform])
        state = model.state_dict()
        flat = list(state.values())
        for t in sizes:
            logger.info("exporting %s entry t=%d samples (%.2fs) on %s",
                        meta["kind"], t, t / sr, traced_on[platform])
            entries.append({"t": t, "platform": platform,
                            "program": export_forward(
                                fn, list(state), flat, t,
                                traced_on[platform])})
    meta.update(bf16=bool(args.bf16), platforms=list(args.platforms),
                checkpoint=args.checkpoint)
    save_artifact(args.output, flat, meta, entries)
    logger.info("wrote %s: %s artifact, %d entr%s, %d params", args.output,
                meta["kind"], len(entries),
                "y" if len(entries) == 1 else "ies", len(flat))
    return args.output


if __name__ == "__main__":
    main()
