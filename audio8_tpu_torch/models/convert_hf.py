"""HuggingFace ``save_pretrained`` directories -> the port's state dicts
(``audio8_tpu/models/convert_hf.py``).

HF's wav2vec2-family module trees are renamings of the fairseq graph,
and the port's parameters carry fairseq's names, so a checkpoint loads
as an HF -> fairseq key translation (:func:`hf_to_fairseq_state`, the
JAX package's table) followed by the fairseq loaders of
``models/convert.py``. Sources: ``Wav2Vec2Model`` /
``Wav2Vec2ForPreTraining`` / ``Wav2Vec2ForCTC``, HuBERT, data2vec-audio,
WavLM and wav2vec2-conformer (base models and ForCTC), in every layout
their configs describe (:func:`hf_topology`).

``model.safetensors`` is read by :func:`read_safetensors` (the format is
an 8-byte little-endian header length, a JSON header of dtype, shape and
byte offsets per tensor, and the raw little-endian bytes; no
``safetensors`` package), ``pytorch_model.bin`` by ``torch.load(...,
weights_only=True)``.

HF CTC vocabularies (``<pad>`` = 0, ...) differ from fairseq's dict
order: decode with the checkpoint's own ``vocab.json``.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, List, Tuple

import torch

from audio8_tpu_torch.config import CONV_FEATURES, AcousticConfig
from audio8_tpu_torch.models.convert import (FAIRSEQ_ENCODER, FAIRSEQ_HEAD,
                                             encoder_table,
                                             from_fairseq_ctc_state,
                                             from_fairseq_pretrained_state)

# safetensors dtype names -> torch dtypes
SAFETENSORS_DTYPES = {"F64": torch.float64, "F32": torch.float32,
                      "F16": torch.float16, "BF16": torch.bfloat16,
                      "I64": torch.int64, "I32": torch.int32,
                      "I16": torch.int16, "I8": torch.int8,
                      "U8": torch.uint8, "BOOL": torch.bool}

# HF base-model key fragment -> fairseq key fragment (encoder body)
_STATIC_MAP = {
    "feature_projection.layer_norm": "layer_norm",
    "feature_projection.projection": "post_extract_proj",
    "masked_spec_embed": "mask_emb",
    "encoder.pos_conv_embed.conv.parametrizations.weight.original0":
        "encoder.pos_conv.0.weight_g",
    "encoder.pos_conv_embed.conv.parametrizations.weight.original1":
        "encoder.pos_conv.0.weight_v",
    "encoder.pos_conv_embed.conv.weight_g": "encoder.pos_conv.0.weight_g",
    "encoder.pos_conv_embed.conv.weight_v": "encoder.pos_conv.0.weight_v",
    "encoder.pos_conv_embed.conv.bias": "encoder.pos_conv.0.bias",
    # Wav2Vec2ForPreTraining: project_hid is fairseq's final_proj
    "quantizer.codevectors": "quantizer.vars",
    "quantizer.weight_proj": "quantizer.weight_proj",
    "project_q": "project_q",
    "project_hid": "final_proj",
}
_BASE_PREFIXES = ("wav2vec2_conformer.", "wav2vec2.", "wav2vec2_model.",
                  "hubert.", "data2vec_audio.", "wavlm.")
# the heads a bare HF base model may lack
_OPTIONAL_HEADS = ("quantizer", "project_q", "final_proj")


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file's tensors (CPU, in the file's dtypes); the
    header's ``__metadata__`` entry is skipped. The file is read into one
    buffer and the tensors are views of it, so the host holds the
    checkpoint once; a tensor whose offset is not a multiple of its item
    size gets its own aligned copy."""
    buf = bytearray(os.path.getsize(path))
    with open(path, "rb") as f:
        f.readinto(buf)
    (n,) = struct.unpack("<Q", buf[:8])
    header = json.loads(buf[8:8 + n].decode("utf-8"))
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        dtype = SAFETENSORS_DTYPES[info["dtype"]]
        offset, size = 8 + n + start, end - start
        item = torch.empty((), dtype=dtype).element_size()
        if size == 0:
            t = torch.empty(0, dtype=dtype)
        elif offset % item:
            t = torch.frombuffer(bytearray(buf[offset:offset + size]),
                                 dtype=dtype)
        else:
            t = torch.frombuffer(buf, dtype=dtype, offset=offset,
                                 count=size // item)
        out[name] = t.reshape(info["shape"])
    return out


def translate_key(key: str, extractor_mode: str = "group"):
    """One HF base-model key -> its fairseq name, or None
    (``audio8_tpu/models/convert_hf.py:_translate_key``)."""
    if key.startswith("feature_extractor.conv_layers."):
        i, sub = key[len("feature_extractor.conv_layers."):].split(".", 1)
        if sub in ("conv.weight", "conv.bias"):
            return f"feature_extractor.conv_layers.{i}.0.{sub[5:]}"
        if sub in ("layer_norm.weight", "layer_norm.bias"):
            leaf = sub.split(".")[1]
            if extractor_mode == "layer":
                # fairseq's per-block LayerNorm sits at sequential 2.1
                return f"feature_extractor.conv_layers.{i}.2.1.{leaf}"
            return f"feature_extractor.conv_layers.{i}.2.{leaf}"
        return None
    if key == "encoder.embed_positions.inv_freq":
        return key  # the rotary buffer, rebuilt from the config
    if key.startswith("encoder.pos_conv_embed.layers."):
        i, sub = key[len("encoder.pos_conv_embed.layers."):].split(".", 1)
        if sub in ("conv.weight", "conv.bias"):
            return f"encoder.pos_conv.{i}.0.{sub.split('.')[1]}"
        return None
    if key.startswith("encoder.layers."):
        i, sub = key[len("encoder.layers."):].split(".", 1)
        if sub.startswith(("attention.", "layer_norm.")):
            sub = (sub.replace("attention.", "self_attn.")
                   .replace("layer_norm.", "self_attn_layer_norm.", 1))
        sub = (sub.replace("feed_forward.intermediate_dense", "fc1")
               .replace("feed_forward.output_dense", "fc2"))
        return f"encoder.layers.{i}.{sub}"
    if key.startswith("encoder.layer_norm."):
        return key
    for hf, fs in _STATIC_MAP.items():
        if key == hf or key.startswith(hf + "."):
            return fs + key[len(hf):]
    return None


def hf_to_fairseq_state(state: Dict[str, Any], ctc: bool = False,
                        extractor_mode: str = "group"
                        ) -> Tuple[Dict[str, Any], List[str]]:
    """An HF state dict under fairseq's names -> (renamed state,
    untranslated keys). ``ctc``: ForCTC keys (``lm_head`` -> the
    ``w2v_encoder.proj`` head, the body under ``w2v_encoder.w2v_model.``)."""
    out, skipped = {}, []
    for key, value in state.items():
        if ctc and key in ("lm_head.weight", "lm_head.bias"):
            out[FAIRSEQ_HEAD + key.split(".")[1]] = value
            continue
        base = key
        for prefix in _BASE_PREFIXES:
            if base.startswith(prefix):
                base = base[len(prefix):]
                break
        fs = translate_key(base, extractor_mode)
        if fs is None:
            skipped.append(key)
            continue
        if fs == "encoder.pos_conv.0.weight_g" and value.dim() == 3 \
                and tuple(value.shape[:2]) != (1, 1):
            value = value.reshape(1, 1, -1)
        out[(FAIRSEQ_ENCODER if ctc else "") + fs] = value
    return out, skipped


def hf_topology(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The encoder-topology fields of an HF config, by ``model_type``
    (``audio8_tpu/models/convert_hf.py:_hf_topology``)."""
    mode = cfg.get("feat_extract_norm", "group")
    if cfg.get("model_type") == "wav2vec2-conformer":
        return dict(pre_norm=False, extractor_mode=mode,
                    conv_bias=cfg.get("conv_bias", False),
                    pos_conv_depth=1, gated_rel_pos=False,
                    encoder_type="conformer",
                    position_embeddings_type=cfg.get(
                        "position_embeddings_type", "relative"))
    if cfg.get("model_type") == "wavlm":
        return dict(pre_norm=cfg.get("do_stable_layer_norm", False),
                    extractor_mode=mode,
                    conv_bias=cfg.get("conv_bias", False),
                    pos_conv_depth=1, gated_rel_pos=True)
    if cfg.get("model_type") == "data2vec-audio":
        return dict(pre_norm=False, extractor_mode="layer",
                    conv_bias=cfg.get("conv_bias", False),
                    pos_conv_depth=cfg.get("num_conv_pos_embeddings", 5),
                    gated_rel_pos=False)
    if mode not in ("group", "layer"):
        raise ValueError(f"unknown feat_extract_norm {mode!r}")
    return dict(pre_norm=cfg.get("do_stable_layer_norm", False),
                extractor_mode=mode, conv_bias=cfg.get("conv_bias", False),
                pos_conv_depth=1, gated_rel_pos=False)


def acoustic_config_from_hf(cfg: Dict[str, Any], topology=None,
                            **overrides) -> AcousticConfig:
    """An evaluation ``AcousticConfig`` (dropout and masking off) from an
    HF config: sizes, topology, positional-conv geometry, WavLM's bucket
    table, the conformer's extras and the conv stack
    (``custom_conv_features`` unless it is a ``CONV_FEATURES`` one)."""
    topo = dict(topology if topology is not None else hf_topology(cfg))
    kw = dict(num_labels=cfg["vocab_size"], d_model=cfg["hidden_size"],
              num_heads=cfg["num_attention_heads"],
              num_layers=cfg["num_hidden_layers"],
              d_ff=cfg["intermediate_size"], dropout=0.0,
              attention_dropout=0.0, timestep_masking=0.0,
              channel_masking=0.0)
    if topo.get("pos_conv_depth", 1) > 1:
        kw["conv_pos_kernel"] = cfg.get("conv_pos_kernel_size", 19)
    else:
        kw["conv_pos_kernel"] = cfg.get("num_conv_pos_embeddings", 128)
    kw["conv_pos_groups"] = cfg.get("num_conv_pos_embedding_groups", 16)
    if topo.get("gated_rel_pos"):
        kw["rel_pos_buckets"] = cfg.get("num_buckets", 320)
        kw["rel_pos_max_distance"] = cfg.get("max_bucket_distance", 800)
    if topo.get("encoder_type") == "conformer":
        kw["conv_depthwise_kernel_size"] = cfg.get(
            "conv_depthwise_kernel_size", 31)
        kw["rotary_base"] = float(cfg.get("rotary_embedding_base", 10000))
        kw["conformer_activation"] = cfg.get("hidden_act", "swish")
    conv = tuple(zip(cfg.get("conv_dim", (512,) * 7),
                     cfg.get("conv_kernel", (10, 3, 3, 3, 3, 2, 2)),
                     cfg.get("conv_stride", (5, 2, 2, 2, 2, 2, 2))))
    for sr, stack in CONV_FEATURES.items():
        if conv == tuple(tuple(b) for b in stack):
            kw["sample_rate"] = sr
            break
    else:
        kw["custom_conv_features"] = conv
    kw.update(topo)
    kw.update(overrides)
    return AcousticConfig(**kw)


def is_hf_dir(path: str) -> bool:
    """True for a ``save_pretrained`` directory (one with config.json)."""
    return os.path.isdir(path) and os.path.exists(
        os.path.join(path, "config.json"))


def read_hf_weights(model_dir: str) -> Dict[str, torch.Tensor]:
    """The tensors of ``model.safetensors``, else ``pytorch_model.bin``."""
    st = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(st):
        return read_safetensors(st)
    bin_ = os.path.join(model_dir, "pytorch_model.bin")
    if not os.path.exists(bin_):
        raise FileNotFoundError(f"{model_dir}: HF dir without model weights")
    blob = torch.load(bin_, map_location="cpu", weights_only=True)
    return {k: v for k, v in blob.items() if hasattr(v, "shape")}


def load_hf_dir(model_dir: str, ctc=False
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """A ``save_pretrained`` directory -> (port state dict in f32, report).

    ``ctc=True`` reads a ForCTC source into the acoustic model's names
    (``encoder.*``, ``proj.*``), else a base model into the pretraining
    model's; ``"auto"`` decides by the ``lm_head``. The report, as the
    JAX ``load_hf_dir``'s: ``missing`` (fairseq keys the topology needs
    and the source lacks), ``unexpected``, ``kind``, ``topology`` and
    ``hf_config``."""
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = json.load(f)
    topology = hf_topology(cfg)
    state = read_hf_weights(model_dir)
    if ctc == "auto":
        ctc = any(k.startswith("lm_head") for k in state)
    renamed, skipped = hf_to_fairseq_state(
        state, ctc=ctc, extractor_mode=topology["extractor_mode"])
    num_fx = len(cfg.get("conv_kernel", [10, 3, 3, 3, 3, 2, 2]))
    body = [k for k, _, _ in encoder_table(topology, num_fx,
                                           cfg["num_hidden_layers"])]
    leftovers = []
    if ctc:
        port, ignored = from_fairseq_ctc_state(renamed)
        # a fine-tuned model may still carry its quantizer (JAX too
        # lets these pass)
        leftovers = [k for k in ignored if not k.startswith(
            (FAIRSEQ_ENCODER + "quantizer", FAIRSEQ_ENCODER + "project_q"))]
        want = {"encoder." + k: FAIRSEQ_ENCODER + k for k in body}
        want.update({"proj." + n: FAIRSEQ_HEAD + n for n in ("weight",
                                                             "bias")})
    else:
        port = from_fairseq_pretrained_state(renamed)
        want = {k: k for k in body}
        want.update({f"{m}.{n}": f"{m}.{n}" for m in
                     ("quantizer.weight_proj", "project_q", "final_proj")
                     for n in ("weight", "bias")})
        want["quantizer.vars"] = "quantizer.vars"
    missing = [fs for k, fs in want.items() if k not in port]
    unexpected = sorted([k for k in port if k not in want] + leftovers
                        + skipped)
    port = {k: v.float() for k, v in port.items() if k in want}
    return port, {"missing": missing, "unexpected": unexpected,
                  "kind": "ctc" if ctc else "pretrained",
                  "topology": dict(topology), "hf_config": cfg}


def hard_missing(report: Dict[str, Any]) -> List[str]:
    """The report's missing keys but the pretraining heads a bare base
    model legitimately lacks."""
    return [k for k in report["missing"]
            if k.split(".")[0] not in _OPTIONAL_HEADS]
