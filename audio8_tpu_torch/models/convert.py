"""Weights into and out of the port's ``Wav2Vec2AcousticModel`` and
``Wav2Vec2Model``.

The port's parameter names are fairseq's, so:

* a fairseq fine-tuned CTC state dict loads by prefix alone:
  ``w2v_encoder.w2v_model.X`` is the port's ``encoder.X`` and
  ``w2v_encoder.proj.*`` its ``proj.*`` (:func:`from_fairseq_ctc_state`,
  :func:`load_fairseq_ctc`); :func:`to_fairseq_ctc_state` is the inverse;
* a fairseq pretrained wav2vec2 state dict is the ``Wav2Vec2Model``'s own,
  except that fairseq's ``quantizer.vars`` carries a leading axis of size
  1 (:func:`to_fairseq_pretrained_state`,
  :func:`from_fairseq_pretrained_state`, :func:`save_fairseq_pretrained`);
* a JAX ``Wav2Vec2AcousticModel``, ``Wav2Vec2Model`` or ``Seq2Seq``
  parameter tree, or the paired ``{'model': DualEncoderModel, 'loss':
  SymmetricCLIPLoss}`` tree, maps key by key (:func:`params_from_jax`):
  Dense ``kernel (in, out)`` becomes ``weight (out, in)``, conv ``kernel
  (K, C_in/g, C_out)`` becomes ``(C_out, C_in/g, K)``, ``scale`` becomes
  ``weight``. The wav2vec2 encoders take fairseq's names (the inverse of
  ``audio8_tpu/models/convert.py:_encoder_assignments``); the decoder,
  the text towers, the reductions, the projections and ``logit_scale``
  keep the JAX names (:func:`_by_name_assignments`). Given the JAX
  optimizer state too (optax ``adamw``/``adam`` or ``FusedAdamW``), it
  carries the moments and the step count across, so both packages can
  train on from the same point.
"""
from __future__ import annotations

import argparse
from typing import Any, Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch

FAIRSEQ_ENCODER = "w2v_encoder.w2v_model."
FAIRSEQ_HEAD = "w2v_encoder.proj."
# pretraining-only modules a fine-tuned checkpoint may still carry
_FAIRSEQ_IGNORED = ("quantizer.", "project_q.", "final_proj.")


def from_fairseq_ctc_state(state: Mapping[str, Any]
                           ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """fairseq CTC ``model`` dict -> (port state dict, ignored keys)."""
    out, ignored = {}, []
    for key, value in state.items():
        if key.startswith(FAIRSEQ_ENCODER):
            rest = key[len(FAIRSEQ_ENCODER):]
            if rest.startswith(_FAIRSEQ_IGNORED):
                ignored.append(key)
                continue
            out["encoder." + rest] = torch.as_tensor(value)
        elif key.startswith(FAIRSEQ_HEAD):
            out["proj." + key[len(FAIRSEQ_HEAD):]] = torch.as_tensor(value)
        else:
            ignored.append(key)
    return out, ignored


def to_fairseq_ctc_state(state: Mapping[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """Port state dict -> fairseq CTC ``model`` dict."""
    out = {}
    for key, value in state.items():
        if key.startswith("encoder."):
            out[FAIRSEQ_ENCODER + key[len("encoder."):]] = value
        elif key.startswith("proj."):
            out[FAIRSEQ_HEAD + key[len("proj."):]] = value
        else:
            raise KeyError(f"no fairseq name for {key!r}")
    return out


def read_fairseq_state(path: str) -> Dict[str, Any]:
    """The ``model`` dict of a fairseq ``.pt`` (``{"model": ..., "args":
    Namespace, ...}``), read with ``weights_only=True``."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        blob = torch.load(path, map_location="cpu", weights_only=True)
    return blob.get("model", blob)


def load_fairseq_ctc(path: str) -> Dict[str, torch.Tensor]:
    """Read a fairseq CTC ``.pt`` and return the port's state dict."""
    state, _ = from_fairseq_ctc_state(read_fairseq_state(path))
    return state


def save_fairseq_ctc(model: torch.nn.Module, path: str) -> None:
    """Write the model as a fairseq-layout CTC checkpoint."""
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"model": to_fairseq_ctc_state(state)}, path)


def to_fairseq_pretrained_state(state: Mapping[str, torch.Tensor]
                                ) -> Dict[str, torch.Tensor]:
    """Port ``Wav2Vec2Model`` state dict -> fairseq pretrained ``model``
    dict (the keys of ``audio8_tpu/models/convert.py:
    convert_pretrained_state``)."""
    out = dict(state)
    out["quantizer.vars"] = state["quantizer.vars"][None]
    return out


def from_fairseq_pretrained_state(state: Mapping[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """fairseq pretrained ``model`` dict -> port ``Wav2Vec2Model`` state
    dict."""
    out = {k: torch.as_tensor(v) for k, v in state.items()}
    out["quantizer.vars"] = out["quantizer.vars"][0]
    return out


def save_fairseq_pretrained(model: torch.nn.Module, path: str) -> None:
    """Write a ``Wav2Vec2Model`` as a fairseq-layout pretrained
    checkpoint."""
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"model": to_fairseq_pretrained_state(state)}, path)


def load_fairseq_pretrained(path: str) -> Dict[str, torch.Tensor]:
    """Read a fairseq pretrained ``.pt`` and return the port's
    ``Wav2Vec2Model`` state dict."""
    return from_fairseq_pretrained_state(read_fairseq_state(path))


# ---------------------------------------------------------------- JAX trees

def _t(x: np.ndarray) -> np.ndarray:  # Dense (in, out) -> (out, in)
    return np.ascontiguousarray(x.T)


def _conv(x: np.ndarray) -> np.ndarray:  # (K, C_in/g, C_out) -> (C_out, C_in/g, K)
    return np.ascontiguousarray(np.transpose(x, (2, 1, 0)))


def _same(x: np.ndarray) -> np.ndarray:
    return x


def _encoder_assignments(jax_root: Tuple[str, ...], port_root: str,
                         num_fx_layers: int, num_layers: int
                         ) -> List[Tuple[Tuple[str, ...], str, Callable]]:
    """(JAX path, port key, transform) for the body a group-mode,
    post-norm ``Wav2Vec2Encoder`` holds: extractor, LayerNorm, input
    projection, mask embedding and transformer. The JAX tree has it under
    ``jax_root`` with the transformer at ``encoder``, the port under
    ``port_root``."""
    out = []
    fx = jax_root + ("feature_extractor",)
    for i in range(num_fx_layers):
        out.append((fx + (f"conv_{i}", "kernel"),
                    f"{port_root}feature_extractor.conv_layers.{i}.0.weight",
                    _conv))
    for jax_name, name in (("scale", "weight"), ("bias", "bias")):
        out.append((fx + ("norm_0", jax_name),
                    f"{port_root}feature_extractor.conv_layers.0.2.{name}",
                    _same))
        out.append((jax_root + ("layer_norm", jax_name),
                    f"{port_root}layer_norm.{name}", _same))
        out.append((jax_root + ("encoder", "ln", jax_name),
                    f"{port_root}encoder.layer_norm.{name}", _same))
    out.append((jax_root + ("proj_to_input", "kernel"),
                f"{port_root}post_extract_proj.weight", _t))
    out.append((jax_root + ("proj_to_input", "bias"),
                f"{port_root}post_extract_proj.bias", _same))
    out.append((jax_root + ("mask_emb",), f"{port_root}mask_emb", _same))
    pos = jax_root + ("encoder", "pos_conv")
    port_pos = f"{port_root}encoder.pos_conv.0."
    out.append((pos + ("weight_v",), port_pos + "weight_v", _conv))
    out.append((pos + ("weight_g",), port_pos + "weight_g", _conv))
    out.append((pos + ("bias",), port_pos + "bias", _same))
    for i in range(num_layers):
        ours = jax_root + ("encoder", "transformer", f"layer_{i}")
        port = f"{port_root}encoder.layers.{i}."
        for jax_name, name in (("w_Q", "q_proj"), ("w_K", "k_proj"),
                               ("w_V", "v_proj"), ("w_O", "out_proj")):
            out.append((ours + ("self_attn", jax_name, "kernel"),
                        port + f"self_attn.{name}.weight", _t))
            out.append((ours + ("self_attn", jax_name, "bias"),
                        port + f"self_attn.{name}.bias", _same))
        for jax_name, name in (("expand", "fc1"), ("contract", "fc2")):
            out.append((ours + ("ffn", jax_name, "kernel"),
                        port + f"{name}.weight", _t))
            out.append((ours + ("ffn", jax_name, "bias"),
                        port + f"{name}.bias", _same))
        for jax_name, name in (("ln_attn", "self_attn_layer_norm"),
                               ("ln_ffn", "final_layer_norm")):
            out.append((ours + (jax_name, "scale"), port + f"{name}.weight",
                        _same))
            out.append((ours + (jax_name, "bias"), port + f"{name}.bias",
                        _same))
    return out


def _body_assignments(tree: Mapping[str, Any], jax_root: Tuple[str, ...],
                      port_root: str):
    """:func:`_encoder_assignments` for the encoder body at ``jax_root``,
    its depths read from the tree."""
    body = tree
    for p in jax_root:
        body = body[p]
    num_fx = sum(1 for k in body["feature_extractor"]
                 if k.startswith("conv_"))
    num_layers = sum(1 for k in body["encoder"]["transformer"]
                     if k.startswith("layer_"))
    return _encoder_assignments(jax_root, port_root, num_fx, num_layers)


# flax's automatic names of the reductions' heads -> the port's
_RENAMES = {"TwoHeadConcat_0": "head", "SingleHeadReduction_0": "head"}


def _by_name_assignments(node: Mapping[str, Any], jax_path: Tuple[str, ...],
                         port_prefix: str
                         ) -> List[Tuple[Tuple[str, ...], str, Callable]]:
    """(JAX path, port key, transform) for a subtree whose port modules
    carry the JAX names: Dense ``kernel`` -> ``weight`` transposed,
    LayerNorm ``scale`` -> ``weight``, every other leaf (``bias``,
    ``embedding``, ``pos_embedding``, ``logit_scale``) as it is."""
    out = []
    for k, v in node.items():
        path = jax_path + (k,)
        if isinstance(v, Mapping):
            out += _by_name_assignments(
                v, path, f"{port_prefix}{_RENAMES.get(k, k)}.")
        elif k == "kernel":
            out.append((path, port_prefix + "weight", _t))
        else:
            out.append((path, port_prefix + ("weight" if k == "scale"
                                             else k), _same))
    return out


def _jax_assignments(tree: Mapping[str, Any]
                     ) -> List[Tuple[Tuple[str, ...], str, Callable]]:
    """(JAX path, port key, transform) for a JAX ``Wav2Vec2AcousticModel``
    tree (the encoder body under ``encoder``, the CTC head ``proj``), a
    ``Wav2Vec2Model`` tree (the body at the top level, with the quantizer
    and the two projections), a ``Seq2Seq`` tree (the body under
    ``encoder``, the ``decoder``) or the paired tree (``model``: the
    audio tower's body under ``audio_encoder/encoder``, its reduction,
    the text tower and the projections; ``loss``)."""
    if "model" in tree and "loss" in tree:
        model, audio = tree["model"], tree["model"]["audio_encoder"]
        out = _body_assignments(tree, ("model", "audio_encoder", "encoder"),
                                "model.audio_encoder.encoder.")
        for k in audio:
            if k != "encoder":
                out += _by_name_assignments(
                    audio[k], ("model", "audio_encoder", k),
                    f"model.audio_encoder.{k}.")
        for k in model:
            if k != "audio_encoder":
                out += _by_name_assignments(model[k], ("model", k),
                                            f"model.{k}.")
        return out + _by_name_assignments(tree["loss"], ("loss",), "loss.")
    if "decoder" in tree:
        return _body_assignments(tree, ("encoder",), "encoder.") \
            + _by_name_assignments(tree["decoder"], ("decoder",), "decoder.")
    pretrain = "quantizer" in tree
    if not pretrain:
        out = _body_assignments(tree, ("encoder",), "encoder.")
        out.append((("proj", "kernel"), "proj.weight", _t))
        out.append((("proj", "bias"), "proj.bias", _same))
        return out
    out = _body_assignments(tree, (), "")
    out.append((("quantizer", "vars"), "quantizer.vars", _same))
    for path in (("quantizer", "weight_proj"), ("project_q",),
                 ("final_proj",)):
        key = ".".join(path)
        out.append((path + ("kernel",), f"{key}.weight", _t))
        out.append((path + ("bias",), f"{key}.bias", _same))
    return out


def _adam_state(opt_state: Any):
    """The node of a JAX optimizer state that holds ``mu`` and ``nu``
    (optax's ScaleByAdamState, possibly inside inject_hyperparams and a
    chain, or FusedAdamWState)."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for child in opt_state:
            found = _adam_state(child)
            if found is not None:
                return found
    return None


def params_from_jax(tree: Mapping[str, Any], opt_state: Any = None):
    """JAX ``Wav2Vec2AcousticModel``, ``Wav2Vec2Model`` or ``Seq2Seq``
    params, or the paired ``{'model': ..., 'loss': ...}`` params (a
    nested mapping of arrays, e.g. ``jax.tree.map(np.asarray, params)``)
    -> the port's state dict (for the paired tree, a
    ``models.dual_encoder.PairedModule``'s).
    Raises ``KeyError`` naming any JAX parameter left unmapped. An
    int8-quantized tree (JAX ``quantize_model_params``) gives the int8
    ``weight`` and ``weight_scale`` buffers of a model quantized with
    ``ops.quant.quantize_model_params``.

    With ``opt_state`` (the JAX AdamW state, arrays as numpy) it returns
    ``(state_dict, (count, mu, nu))`` where ``mu`` and ``nu`` are state
    dicts laid out like the parameters: feed them to
    ``train.optim.TrainState.load_adam_state``."""
    state = _params_from_jax(tree)
    if opt_state is None:
        return state
    adam = _adam_state(opt_state)
    if adam is None:
        raise KeyError("no mu/nu (AdamW moments) in the JAX optimizer state")
    return state, (int(np.asarray(adam.count)), _params_from_jax(adam.mu),
                   _params_from_jax(adam.nu))


def _params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    state, used = {}, set()
    for path, key, tf in _jax_assignments(tree):
        node = tree
        for p in path[:-1]:
            node = node[p]
        leaf = np.asarray(node[path[-1]])
        if leaf.dtype == np.int8:
            # an int8-quantized Dense (JAX ops/quant.py): int8 (in, out)
            # codes -> the (out, in) ``weight`` buffer, ``kernel_scale``
            # -> ``weight_scale``
            state[key] = torch.from_numpy(np.array(tf(leaf)))
            state[key[:-len("weight")] + "weight_scale"] = torch.from_numpy(
                np.array(node["kernel_scale"], np.float32))
            used.add(path[:-1] + ("kernel_scale",))
        else:
            state[key] = torch.from_numpy(
                np.array(tf(leaf.astype(np.float32))))
        used.add(path)

    def leaves(node, prefix=()):
        if isinstance(node, Mapping):
            for k, v in node.items():
                yield from leaves(v, prefix + (k,))
        else:
            yield prefix

    left = [p for p in leaves(tree) if p not in used]
    if left:
        raise KeyError(f"JAX parameters with no port counterpart: {left[:5]}")
    return state
