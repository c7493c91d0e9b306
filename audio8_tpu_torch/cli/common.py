"""Shared CLI flags of the port: every flag of ``audio8_tpu/cli/common.py``'s
``add_common_model_args`` with the same names and defaults, the decoding
flags the JAX transcribe and serve parsers share, plus ``--device``: the
entry points run on the CUDA card unless the caller asks for the CPU.

A flag the port cannot honour at the value given raises
``NotImplementedError`` naming the ``ROADMAP.md`` item that ports it
(:func:`check_ported`, and ``models/wav2vec2.py:check_supported`` for
the topology flags): it never ends in an argparse exit where the JAX
entry point runs. Flags that only matter beside another one (``--alpha``
without ``--lm``, ``--moe_top_k`` without ``--moe_experts``, the
transducer sizes without ``--transducer``) are inert, as in JAX.
Which flags are ported can depend on the entry point (``PORTED``): the
decoding flags (``--beam``, ``--lm``, ``--timestamps``, ``--vad``,
``--quantize``, ``--device_beam``, ``--lm_rescore``) are ported where the
entry point has them, as is ``--exported`` (a ``cli.export`` artifact)
everywhere.

:func:`resolve_restart` is ``--restart_from`` (fairseq ``.pt`` and
HuggingFace ``save_pretrained`` warm starts, the JAX package's Orbax
checkpoints, directories of either package's checkpoints, full-state
resume); :func:`load_weights` reads the same sources for the evaluation
entry points.
"""
from __future__ import annotations

import logging
import os
from argparse import ArgumentParser, Namespace
from typing import Dict, Optional

import numpy as np
import torch

from audio8_tpu_torch.utils import str2bool

logger = logging.getLogger("audio8_tpu_torch")

# The JAX package's size and topology presets
# (``audio8_tpu.cli.common.MODEL_PRESETS``); the port runs every one.
MODEL_PRESETS = {
    "base": {},
    "large": {"d_model": 1024, "d_ff": 4096, "num_heads": 16,
              "num_layers": 24, "final_dim": 768},
    "large-lv60": {"d_model": 1024, "d_ff": 4096, "num_heads": 16,
                   "num_layers": 24, "final_dim": 768, "pre_norm": True,
                   "extractor_mode": "layer", "conv_bias": True},
    "hubert-large": {"d_model": 1024, "d_ff": 4096, "num_heads": 16,
                     "num_layers": 24, "final_dim": 768, "pre_norm": True,
                     "extractor_mode": "layer", "conv_bias": False},
    "data2vec-base": {"extractor_mode": "layer", "pos_conv_depth": 5,
                      "conv_pos_kernel": 19},
    "data2vec-large": {"d_model": 1024, "d_ff": 4096, "num_heads": 16,
                       "num_layers": 24, "final_dim": 768,
                       "extractor_mode": "layer", "pos_conv_depth": 5,
                       "conv_pos_kernel": 19},
    "wavlm-base": {"gated_rel_pos": True},
    "wavlm-large": {"d_model": 1024, "d_ff": 4096, "num_heads": 16,
                    "num_layers": 24, "final_dim": 768, "pre_norm": True,
                    "extractor_mode": "layer", "gated_rel_pos": True},
    "conformer-large-rope": {"d_model": 1024, "d_ff": 4096, "num_heads": 16,
                             "num_layers": 24, "final_dim": 768,
                             "extractor_mode": "layer", "conv_bias": True,
                             "encoder_type": "conformer",
                             "position_embeddings_type": "rotary"},
    "conformer-large-rel": {"d_model": 1024, "d_ff": 4096, "num_heads": 16,
                            "num_layers": 24, "final_dim": 768,
                            "extractor_mode": "layer", "conv_bias": True,
                            "encoder_type": "conformer",
                            "position_embeddings_type": "relative"},
}
_PRESET_BASE_DEFAULTS = {"d_model": 768, "d_ff": 3072, "num_heads": 12,
                         "num_layers": 12, "final_dim": 256,
                         "pre_norm": False, "extractor_mode": "group",
                         "conv_bias": False, "pos_conv_depth": 1,
                         "conv_pos_kernel": 128, "gated_rel_pos": False,
                         "rel_pos_buckets": 320,
                         "rel_pos_max_distance": 800,
                         "encoder_type": "transformer",
                         "position_embeddings_type": "relative",
                         "conv_depthwise_kernel_size": 31,
                         "rotary_base": 10000.0,
                         "conformer_activation": "swish"}

# ROADMAP.md queue 1 items, named in the refusals
DECODE = "ROADMAP.md queue 1, item 6 (serving and inference)"
PARALLEL = "ROADMAP.md queue 1, item 8 (parallelism beyond DP)"

# flag -> (its value when unused, the item that ports it). Any other
# value raises; a flag an entry point does not have is skipped. The
# seven trainers run --tensor_parallel and --sequence_parallel
# (``parallel/tensor.py``; :data:`PARALLEL_TRAINERS`).
NOT_PORTED = {
    "tensor_parallel": (1, PARALLEL),
    "sequence_parallel": (False, PARALLEL),
    "pipeline_parallel": (1, PARALLEL),
    "lm": (None, DECODE),
    "beam": (1, DECODE),
    "timestamps": (False, DECODE),
    "vad": (False, DECODE),
    "quantize": ("none", DECODE),
}
# entry point -> the flags of NOT_PORTED it has ported: the beam search
# and LM fusion of the trainer's verbose validation and of the decoders,
# word timestamps, VAD and int8 weights (``--device_beam`` and
# ``--lm_rescore`` run wherever an entry point has them)
PARALLEL_TRAINERS = ("train", "pretrain", "train_transducer",
                     "train_seq2seq", "pretrain_paired", "pretrain_hubert",
                     "pretrain_data2vec")
_TP = ("tensor_parallel", "sequence_parallel")
PORTED = {**{e: _TP for e in PARALLEL_TRAINERS},
          "train": ("beam", "lm") + _TP,
          "test": ("beam", "lm", "quantize"),
          "transcribe": ("beam", "lm", "timestamps", "vad", "quantize"),
          "serve": ("beam", "lm", "timestamps", "quantize"),
          "export": ("quantize",)}


def apply_preset(args: Namespace) -> Namespace:
    """Resolve ``--preset``: preset-managed flags parse with a ``None``
    sentinel, so an explicit flag always wins; unset ones take the
    preset's value, else the base default. ``final_dim`` (the
    pretraining projection width) only where the parser has the flag."""
    preset = MODEL_PRESETS[args.preset]
    for key, base_value in _PRESET_BASE_DEFAULTS.items():
        if hasattr(args, key) and getattr(args, key) is None:
            setattr(args, key, preset.get(key, base_value))
    return args


def encoder_kwargs(args: Namespace) -> dict:
    """The encoder-topology, remat, sequence-parallel and MoE flags as
    config kwargs (``audio8_tpu.cli.common.topology_kwargs`` and
    ``moe_kwargs``); ``check_supported`` refuses what the port does not
    run."""
    names = ("pre_norm", "extractor_mode", "conv_bias", "pos_conv_depth",
             "conv_pos_kernel", "gated_rel_pos", "rel_pos_buckets",
             "rel_pos_max_distance", "encoder_type",
             "position_embeddings_type", "conv_depthwise_kernel_size",
             "rotary_base", "conformer_activation", "causal_chunk_frames",
             "causal_left_chunks", "remat", "sequence_parallel",
             "moe_experts", "moe_top_k", "moe_capacity_factor",
             "moe_every", "moe_aux_weight")
    return {n: getattr(args, n) for n in names}


def moe_aux(metrics: dict) -> dict:
    """``{"moe_aux": value}`` for a step log row when the step reported
    the MoE load-balance loss, else nothing."""
    return ({"moe_aux": float(metrics["moe_aux"])} if "moe_aux" in metrics
            else {})


def check_ported(args: Namespace, entry: str) -> None:
    """Raise ``NotImplementedError`` for a flag whose value asks for a part
    of the JAX entry point ``entry`` (``train``, ``pretrain``,
    ``train_seq2seq``, ``pretrain_paired``, ``pretrain_hubert``,
    ``pretrain_data2vec``, ``cluster_targets``, ``test``, ``transcribe``,
    ``serve``, ``embed``) that is not ported yet, naming the
    ROADMAP.md item; the topology flags through ``check_supported``."""
    from audio8_tpu_torch.config import EncoderConfig
    from audio8_tpu_torch.models.wav2vec2 import check_supported

    table = dict(NOT_PORTED)
    for flag in PORTED.get(entry, ()):
        del table[flag]
    for flag, (unused, item) in table.items():
        if hasattr(args, flag) and getattr(args, flag) != unused:
            raise NotImplementedError(
                f"--{flag} {getattr(args, flag)} is not ported yet: {item}")
    if getattr(args, "tensor_parallel", 1) > 1:
        for flag, unused, what in (("moe_experts", 0, "expert parallelism"),
                                   ("zero1", False, "ZeRO-1"),
                                   ("fsdp", False, "FSDP")):
            if getattr(args, flag, unused) != unused:
                raise NotImplementedError(
                    f"--{flag} beside --tensor_parallel "
                    f"{args.tensor_parallel} ({what} over the model group) "
                    f"is not ported yet: {PARALLEL}")
    check_supported(EncoderConfig(**encoder_kwargs(args)))


def start_distributed(args):
    """``--distributed``: the rank's device (``cuda`` is
    ``cuda:$LOCAL_RANK``), then the process group
    (``parallel/sharding.py:setup``) laid out as ``--tensor_parallel``
    model ranks per data rank; returns ``(device, rank, world, group)``:
    the data rank, the data extent and the data group (the world at
    ``--tensor_parallel`` 1), ``group`` None when no process group runs.
    Without ``--distributed``: ``--device``, rank 0 of 1, no group."""
    from audio8_tpu_torch.parallel.sharding import (data_group, dp_device,
                                                    setup)

    device = resolve_device(dp_device(args.device, args.distributed))
    rank, world = setup(args.distributed, device,
                        tensor_parallel=getattr(args, "tensor_parallel", 1))
    return device, rank, world, data_group()


def shard_kwargs(rank: int, world: int) -> dict:
    """The datasets' row-block sharding for rank ``rank`` of ``world``
    (the JAX trainers': every rank walks the same batches and reads its
    block of rows)."""
    return {"shard_index": rank, "num_shards": world,
            "row_shard": world > 1}


def save_on_rank0(group, save, *args, whole=()) -> None:
    """``save(*args)`` on the first rank of the run only (always without
    a group); every rank then waits at a barrier, so no rank reads or
    resumes from a file still being written. A ZeRO-1, FSDP or
    tensor-parallel state among ``args``, and the states and modules in
    ``whole``, are gathered whole first, on every rank
    (``parallel/__init__.py:full_state``, a collective: a gather inside rank
    0's save alone would hang)."""
    import torch.distributed as dist

    from audio8_tpu_torch.parallel import full_state
    from audio8_tpu_torch.parallel.sharding import barrier

    states = [a for a in args if getattr(a, "shards", None) is not None
              or getattr(a, "tensor_shards", None) is not None]
    with full_state(*states, *whole):
        if group is None or dist.get_rank() == 0:
            save(*args)
    barrier(None if group is None else dist.group.WORLD)


def add_augmentation_args(parser: ArgumentParser) -> None:
    """The JAX trainers' augmentation flags (:func:`train_augmentation`
    builds them)."""
    add = parser.add_argument
    add("--noise_manifest",
        help="additive-noise source: an audio manifest TSV or a directory "
             "of noise clips (data/audio.NoiseMixer)")
    add("--noise_snr", type=float, nargs=2, default=[5.0, 20.0],
        help="uniform SNR-dB range for --noise_manifest")
    add("--noise_prob", type=float, default=1.0,
        help="per-utterance probability of mixing noise")
    add("--speed_perturb", type=float, nargs="*",
        help="speed factors of the training utterances (e.g. 0.9 1.0 1.1); "
             "polyphase resample per read, transcripts unchanged "
             "(data/audio.speed_perturb_wav)")


def train_augmentation(args: Namespace) -> dict:
    """The training set's augmentation as ``AudioTextLetterDataset``
    kwargs, as the JAX trainers build it: ``--speed_perturb`` factors,
    and a ``data.audio.NoiseMixer`` over ``--noise_manifest`` (a
    manifest or a directory of clips) at ``--noise_snr`` with
    ``--noise_prob``."""
    from audio8_tpu_torch.data.audio import NoiseMixer

    mixer = (NoiseMixer(args.noise_manifest, snr_db=args.noise_snr,
                        prob=args.noise_prob)
             if args.noise_manifest else None)
    return {"speed_perturb": args.speed_perturb or (), "noise_mixer": mixer}


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
    """The JAX ``add_common_model_args`` flags, then ``--device``."""
    add = parser.add_argument
    add("--preset", choices=sorted(MODEL_PRESETS), default="base",
        help="model-size preset; individual size flags override it")
    add("--tensor_parallel", type=int, default=1,
        help="ranks of a model group: the transformer's heads and FFN "
             "columns split over them (parallel/tensor.py; a trainer's "
             "flag under --distributed)")
    add("--zero1", type=str2bool, default=False,
        help="shard the AdamW moments over the --distributed ranks "
             "(parallel/zero.py; a trainer's flag, inert elsewhere)")
    add("--fsdp", type=str2bool, default=False,
        help="shard parameters, gradients and moments over the "
             "--distributed ranks, gathering each layer as it runs "
             "(implies --zero1; a trainer's flag, inert elsewhere)")
    add("--sequence_parallel", type=str2bool, default=False,
        help="split the wav2vec2 stack's residual stream on T over the "
             "--tensor_parallel model group between layers")
    add("--moe_experts", type=int, default=0,
        help="Mixture-of-Experts FFN with this many experts in every "
             "--moe_every-th transformer layer (nn/moe.py; 0: dense)")
    add("--moe_top_k", type=int, default=1)
    add("--moe_capacity_factor", type=float, default=1.25)
    add("--moe_every", type=int, default=2)
    add("--moe_aux_weight", type=float, default=0.01)
    add("--d_model", type=int, default=None)
    add("--d_ff", type=int, default=None)
    add("--num_heads", type=int, default=None)
    add("--num_layers", type=int, default=None)
    add("--dropout", type=float, default=0.1)
    add("--attention_dropout", type=float, default=None,
        help="attention-prob dropout (default: --dropout)")
    add("--layer_drop", type=float, default=0.0,
        help="LayerDrop rate in training (inert at inference)")
    add("--pre_norm", type=str2bool, default=None)
    add("--extractor_mode", choices=["group", "layer"], default=None)
    add("--conv_bias", type=str2bool, default=None)
    add("--pos_conv_depth", type=int, default=None)
    add("--conv_pos_kernel", type=int, default=None)
    add("--gated_rel_pos", type=str2bool, default=None)
    add("--rel_pos_buckets", type=int, default=None)
    add("--rel_pos_max_distance", type=int, default=None)
    add("--encoder_type", choices=["transformer", "conformer"], default=None)
    add("--position_embeddings_type", choices=["relative", "rotary", "none"],
        default=None)
    add("--conv_depthwise_kernel_size", type=int, default=None)
    add("--rotary_base", type=float, default=None)
    add("--conformer_activation", default=None)
    add("--causal_chunk_frames", type=int, default=0)
    add("--causal_left_chunks", type=int, default=-1)
    add("--remat", type=str2bool, default=False,
        help="recompute each encoder layer in the backward (its dropout "
             "seeds replayed) instead of keeping its activations")
    add("--input_sample_rate", type=int, default=16_000)
    add("--target_sample_rate", type=int, default=16_000)
    add("--bf16", action="store_true", help="bfloat16 compute (fp32 params)")
    add("--device", default="cuda",
        help="cuda[:N] (default; raises without a card) or cpu")


def add_decoding_args(parser: ArgumentParser, max_decode_len) -> None:
    """The decoding flags of the JAX transcribe and serve parsers (their
    ``--max_decode_len`` defaults differ: None and 8000)."""
    add = parser.add_argument
    add("--exported", help="cli.export artifact directory: run its traced "
        "forward instead of building the model from a checkpoint")
    add_beam_args(parser)
    add("--device_beam", type=str2bool, default=False,
        help="no-LM batch beam decode on --device (ops/beam_device.py)")
    add("--transducer", type=str2bool, default=False,
        help="the checkpoint is a cli.train_transducer model: RNN-T "
             "decoding (models/transducer.py)")
    add("--pred_layers", type=int, default=2)
    add("--pred_dim", type=int, default=512)
    add("--pred_embed_dim", type=int, default=256)
    add("--d_joint", type=int, default=512)
    add("--max_decode_len", type=int, default=max_decode_len)
    add("--max_symbols_per_frame", type=int, default=4)
    add("--timestamps", type=str2bool, default=False,
        help="word-level {start, end, confidence} from the greedy CTC "
             "alignment (ops/align.py)")
    add("--quantize", choices=["none", "int8"], default="none",
        help="int8: post-training weight quantization of the Dense "
             "layers (ops/quant.py)")


def add_beam_args(parser: ArgumentParser) -> None:
    """``--beam``, ``--lm``, ``--alpha``, ``--beta``: the trainer's
    beam-decoded validation samples and the decoders' flags; the LM
    weights are inert without ``--lm``."""
    add = parser.add_argument
    add("--beam", type=int, default=1, help="1: greedy")
    add("--lm", help="ARPA (plain or gzipped) or KenLM binary LM")
    add("--alpha", type=float, default=0.7)
    add("--beta", type=float, default=5.0)


def require_checkpoint(args: Namespace, entry: str) -> None:
    """As the JAX transcribe and serve parsers: ``--checkpoint`` and
    ``--dict_file`` are needed unless ``--exported`` is given, which
    takes neither ``--transducer`` nor ``--quantize`` (the artifact
    records its kind, and int8 is baked at export)."""
    if args.exported:
        if args.transducer:
            raise SystemExit("--transducer is not needed with --exported: "
                             "the artifact records its own kind "
                             "(meta.json)")
        if args.quantize != "none":
            raise SystemExit("--quantize is baked at export time "
                             "(cli.export --quantize int8)")
    check_ported(args, entry)
    if not args.exported and not (args.checkpoint and args.dict_file):
        raise SystemExit("--checkpoint and --dict_file are required "
                         "(or pass an --exported artifact)")


def _fairseq_weights(path: str, model: torch.nn.Module,
                     ctc: bool) -> Dict[str, torch.Tensor]:
    """A fairseq ``.pt``'s weights under ``model``'s names: tried as a
    pretrained checkpoint first (every encoder weight of ``model`` must be
    in it), then as a CTC one. For the CTC model (``ctc``) a pretrained
    encoder lands under ``encoder.``; for the pretraining model a CTC
    checkpoint gives its encoder."""
    from audio8_tpu_torch.models.convert import (load_fairseq_ctc,
                                                 load_fairseq_pretrained)

    target = model.state_dict()
    try:
        loaded = load_fairseq_pretrained(path)
        if ctc:
            loaded = {"encoder." + k: v for k, v in loaded.items()}
        missing = [k for k in target if k not in loaded
                   and (k.startswith("encoder.") or not ctc)]
        if missing:
            raise KeyError(f"missing keys: {missing[:3]}")
    except Exception:
        loaded = load_fairseq_ctc(path)
        if not ctc:
            loaded = {k[len("encoder."):]: v for k, v in loaded.items()
                      if k.startswith("encoder.")}
    return loaded


TOPOLOGY_FIELDS = ("pre_norm", "extractor_mode", "conv_bias",
                   "pos_conv_depth", "gated_rel_pos", "encoder_type",
                   "position_embeddings_type")


def canonical_topology(d) -> Dict:
    """The parameter-placement topology fields of a dict (missing ones at
    ``EncoderConfig``'s defaults), as the JAX ``canonical_topology``
    compares them."""
    import dataclasses

    from audio8_tpu_torch.config import EncoderConfig

    default = {f.name: f.default for f in dataclasses.fields(EncoderConfig)}
    return {k: d.get(k, default[k]) for k in TOPOLOGY_FIELDS}


def _hf_weights(path: str, model: torch.nn.Module,
                ctc: bool) -> Dict[str, torch.Tensor]:
    """An HF ``save_pretrained`` directory's weights under ``model``'s
    names (the HF branch of the JAX ``resolve_restart``): its topology
    must be the model's (``ValueError`` otherwise: a mismatch would leave
    norms at their initial values), only the pretraining heads may be
    missing, a base model's encoder fills a CTC model's ``encoder`` and a
    ForCTC model's encoder a pretraining model (its head dropped)."""
    import dataclasses

    from audio8_tpu_torch.config import EncoderConfig
    from audio8_tpu_torch.models.convert_hf import hard_missing, load_hf_dir

    loaded, report = load_hf_dir(path, ctc="auto")
    cfg = next(m.config for m in model.modules()
               if isinstance(getattr(m, "config", None), EncoderConfig))
    topo = dataclasses.asdict(cfg)
    if canonical_topology(report["topology"]) != canonical_topology(topo):
        raise ValueError(
            f"HF checkpoint topology {report['topology']} does not match "
            f"the model flags {canonical_topology(topo)}; pass --pre_norm/"
            "--extractor_mode/--conv_bias (or --preset) to match")
    missing = hard_missing(report)
    if missing:
        raise ValueError(f"HF checkpoint missing keys: {missing[:5]}")
    if ctc and report["kind"] == "pretrained":
        loaded = {"encoder." + k: v for k, v in loaded.items()}
    elif not ctc and report["kind"] == "ctc":
        logger.info("CTC-source HF checkpoint: its encoder warm-starts the "
                    "model (head dropped)")
        loaded = {k[len("encoder."):]: v for k, v in loaded.items()
                  if k.startswith("encoder.")}
    logger.info("HF load report (%s): missing=%s unexpected=%s",
                report["kind"], report["missing"][:5],
                report["unexpected"][:5])
    return loaded


def load_orbax_params(tree, model: torch.nn.Module, ctc: bool,
                      path: str) -> None:
    """The params of a JAX Orbax tree (its ``params``, or the tree
    itself) over ``model``'s weights with the JAX ``resolve_restart``'s
    params-only semantics (``audio8_tpu/cli/common.py``): a pretraining
    tree warm-starting a model with an ``encoder`` (``ctc``) nests under
    ``encoder``, the model's entries the tree lacks keep their values,
    the tree's leaves the model lacks are dropped and logged."""
    from audio8_tpu_torch.models.convert import (load_jax_params,
                                                 model_assignments)

    params = tree.get("params", tree) if isinstance(tree, dict) else tree
    top = {p[0] for p, _, _ in model_assignments(model)}
    if (ctc and "encoder" in top and "feature_extractor" in params
            and "feature_extractor" not in top):
        params = {"encoder": params}
    dropped = load_jax_params(params, model)
    if dropped:
        logger.info("checkpoint keys not in model (dropped): %s",
                    ["/".join(p) for p in dropped[:8]])
    logger.info("weights from the Orbax checkpoint %s", path)


def load_weights(path: str, model: torch.nn.Module, ctc: bool,
                 kind: Optional[str] = None) -> None:
    """Load a checkpoint's weights over ``model``'s. The JAX package's
    Orbax directory goes through :func:`load_orbax_params`; the port's own
    seq2seq or paired ``.pt`` of ``kind`` loads whole; an HF
    ``save_pretrained`` directory goes through :func:`_hf_weights`;
    otherwise the file is a fairseq one (:func:`_fairseq_weights`;
    ``ctc``: into the model's ``encoder``): its keys that the source
    lacks (the CTC head or the decoder under a pretrained encoder) keep
    their values, the source's keys the model lacks (the quantizer and
    projections, HuBERT's ``final_proj`` and ``label_embs_concat``,
    data2vec's ``final_proj``) are dropped, as the JAX merge drops them.
    A paired model takes neither a fairseq file nor an HF directory (the
    JAX trainer would merge none of their keys)."""
    from audio8_tpu_torch.models.convert_hf import is_hf_dir
    from audio8_tpu_torch.train.checkpoint import load_port_checkpoint
    from audio8_tpu_torch.train.orbax import is_orbax_dir, load_checkpoint

    if is_orbax_dir(path):
        load_orbax_params(load_checkpoint(path), model, ctc, path)
        return
    hf = is_hf_dir(path)
    own = load_port_checkpoint(path, kind) if kind and not hf else None
    if own is not None:
        model.load_state_dict(own, strict=True)
        logger.info("weights from %s: the %s model", path, kind)
        return
    if kind == "paired":
        raise ValueError(f"{path}: not a paired checkpoint of the port; a "
                         "fairseq .pt or an HF directory holds no paired "
                         "model")
    loaded = (_hf_weights(path, model, ctc) if hf
              else _fairseq_weights(path, model, ctc))
    merged = model.state_dict()
    dropped = [k for k in loaded if k not in merged]
    merged.update({k: v.to(merged[k].dtype) for k, v in loaded.items()
                   if k in merged})
    model.load_state_dict(merged, strict=True)
    logger.info("weights from %s: %d tensors loaded, %d kept, %d dropped "
                "(%s)", path, len(loaded) - len(dropped),
                len(merged) - len(loaded) + len(dropped), len(dropped),
                dropped[:5])


def _tree_state(tree, triples, names=None) -> Optional[Dict]:
    """A JAX tree as a state dict through ``triples`` (restricted to
    ``names``), or ``None`` if it lacks one of their paths."""
    from audio8_tpu_torch.models.convert import _as_numpy, _get_path

    out = {}
    for path, key, tf in triples:
        if names is not None and key not in names:
            continue
        leaf = _get_path(tree, path)
        if leaf is None:
            return None
        out[key] = torch.from_numpy(np.array(tf(_as_numpy(leaf))))
    return out


def restore_full_state(tree, state) -> Optional[int]:
    """The JAX full-state restore of an Orbax TrainState tree (``params``,
    ``opt_state``, ``step``) into ``state``: only when the saved optimizer
    state is the kind ``state``'s ``--optim`` builds (``jax_optim``) and
    the saved params and moments are the model's, every leaf and shape
    (JAX's restore against its template fails otherwise). Sets the
    weights, the optimizer count (the LR schedule's position) and moments,
    and the step from the saved ``step``; returns it, else ``None`` and
    ``state`` is untouched."""
    from audio8_tpu_torch.models.convert import (_adam_state, _field,
                                                 _opt_count, jax_optim,
                                                 model_assignments,
                                                 tree_paths)

    if not (isinstance(tree, dict)
            and {"params", "opt_state", "step"} <= set(tree)):
        return None
    saved = jax_optim(tree["opt_state"])
    if saved != state.tx.optim:
        logger.info("saved optimizer %s is not --optim %s: params only",
                    saved, state.tx.optim)
        return None
    triples = model_assignments(state.model)
    if sorted(tree_paths(tree["params"])) != sorted(p for p, _, _ in
                                                      triples):
        logger.info("saved params are not the model's: params only")
        return None
    own = state.model.state_dict()
    weights = _tree_state(tree["params"], triples)
    if any(weights[k].shape != v.shape for k, v in own.items()):
        logger.info("saved shapes are not the model's: params only")
        return None
    adam = _adam_state(tree["opt_state"])
    mu = nu = None
    if adam is not None:
        names = set(state.names)
        mu = _tree_state(_field(adam, "mu"), triples, names)
        nu = _tree_state(_field(adam, "nu"), triples, names)
        if mu is None or nu is None or any(
                mu[n].shape != p.shape for n, p in zip(state.names,
                                                        state.params)):
            logger.info("saved moments are not the model's: params only")
            return None
    state.model.load_state_dict(
        {k: weights[k].to(v.dtype) for k, v in own.items()}, strict=True)
    state.load_opt_state(int(np.asarray(_opt_count(tree["opt_state"]))),
                         mu, nu)
    state.step = int(np.asarray(tree["step"]))
    return state.step


def resolve_restart(restart_from: Optional[str], state, ctc: bool,
                    restart_tt: Optional[str] = None,
                    kind: Optional[str] = None) -> int:
    """``--restart_from`` with the JAX package's semantics
    (``audio8_tpu/cli/common.py:resolve_restart``), on either package's
    checkpoints; loads into ``state.model`` (and ``state``) in place and
    returns the global step to start from. ``kind`` is the model's
    checkpoint kind (``train/checkpoint.py``), by default ``ctc`` or
    ``pretrain`` by ``ctc``; ``seq2seq`` passes ``ctc`` too, so a
    pretrained fairseq file fills its ``encoder``.

    - a ``.pt`` named directly is a warm start at step 0, even when it
      is one of the port's own checkpoints: its weights load over the
      initialised model (:func:`load_weights`);
    - a JAX Orbax directory restores the full state when it holds one of
      this model and ``--optim`` (:func:`restore_full_state`), else its
      params (:func:`load_orbax_params`) at the step of its name, or 0
      under ``restart_tt == "ignore"``;
    - another directory picks its latest checkpoint, the port's
      ``checkpoint-step-N.pt`` or JAX's Orbax ``checkpoint-step-N``
      (``train/checkpoint.py:find_latest_checkpoint``). An Orbax one
      restores as above. A ``.pt`` loads its weights so; a resume file
      beside it of this model's kind over the same parameters restores the
      AdamW moments and the step count too, and its own step is the step;
      otherwise the step comes from the name unless ``restart_tt ==
      "ignore"`` (JAX's full-state and params-only restores);
    - a HuggingFace ``save_pretrained`` directory is a warm start at step
      0 (:func:`_hf_weights`).
    """
    from audio8_tpu_torch.train.checkpoint import (find_latest_checkpoint,
                                                   load_resume,
                                                   parse_checkpoint_step)
    from audio8_tpu_torch.train.orbax import is_orbax_dir, load_checkpoint

    if not restart_from:
        return 0
    kind = kind or ("ctc" if ctc else "pretrain")
    path = restart_from
    if os.path.isdir(path) and not is_orbax_dir(path) and \
            not os.path.exists(os.path.join(path, "config.json")):
        path, _ = find_latest_checkpoint(path)
    elif not is_orbax_dir(path):
        # a .pt or an HF directory: a warm start
        load_weights(path, state.model, ctc, kind)
        state.step = state.opt_state.count = 0
        return 0
    if is_orbax_dir(path):
        tree = load_checkpoint(path)
        step = restore_full_state(tree, state)
        if step is not None:
            logger.info("restored the full JAX state of %s at step %d",
                        path, step)
            return step
        load_orbax_params(tree, state.model, ctc, path)
    else:
        load_weights(path, state.model, ctc, kind)
        resumed = load_resume(state, path, kind)
        if resumed is not None:
            logger.info("resumed the full state at step %d", resumed)
            return resumed
    step = 0 if restart_tt == "ignore" else parse_checkpoint_step(path)
    state.step = state.opt_state.count = step
    return step
