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
* on the way in, WavLM's unilm key spellings are renamed and a
  conformer's BatchNorms folded into its ``bn_folded`` affine
  (:func:`canonical_fairseq_state`); a conformer's k=1 pointwise convs
  are ``(C_out, C_in, 1)`` in the files and ``Dense`` weights in the
  port;
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


# unilm/fairseq WavLM spellings -> the HF-style names the port carries
# (``audio8_tpu/models/convert.py:_WAVLM_FAIRSEQ_ALIASES``)
_WAVLM_FAIRSEQ_ALIASES = (
    (".self_attn.grep_linear.", ".self_attn.gru_rel_pos_linear."),
    (".self_attn.grep_a", ".self_attn.gru_rel_pos_const"),
    (".self_attn.relative_attention_bias.", ".self_attn.rel_attn_embed."),
)
_POINTWISE = (".conv_module.pointwise_conv1.weight",
              ".conv_module.pointwise_conv2.weight")


def fold_conformer_batchnorm(state: Dict[str, Any], eps: float = 1e-5
                             ) -> None:
    """Fold each conformer conv module's BatchNorm (weight, bias, running
    statistics) into ``...conv_module.bn_folded.{scale,bias}`` in place,
    in float64 as ``audio8_tpu/models/convert.py:_fold_conformer_batchnorm``
    does, and drop the positional weights HF builds but never applies."""
    layers = set()
    for k in list(state):
        if ".conv_module.batch_norm." in k:
            layers.add(k.split(".conv_module.")[0])
        if ".pos_conv." in k or "embed_positions." in k:
            state.pop(k)
    for base in layers:
        bn = f"{base}.conv_module.batch_norm."
        state.pop(bn + "num_batches_tracked", None)
        try:
            w, b, mean, var = (np.asarray(state.pop(bn + n), np.float64)
                               for n in ("weight", "bias", "running_mean",
                                         "running_var"))
        except KeyError:
            continue  # an incomplete BN surfaces as missing bn_folded keys
        scale = w / np.sqrt(var + eps)
        state[f"{base}.conv_module.bn_folded.scale"] = torch.from_numpy(
            scale.astype(np.float32))
        state[f"{base}.conv_module.bn_folded.bias"] = torch.from_numpy(
            (b - mean * scale).astype(np.float32))


def canonical_fairseq_state(state: Mapping[str, Any]) -> Dict[str, Any]:
    """A fairseq-layout dict under the port's names: WavLM's unilm
    spellings renamed, a conformer's BatchNorms folded (its dead
    positional weights dropped) and its k=1 pointwise convs ``(C_out,
    C_in, 1)`` as the port's ``Dense`` weights ``(C_out, C_in)``."""
    out = {}
    for k, v in state.items():
        for old, new in _WAVLM_FAIRSEQ_ALIASES:
            if old in k:
                k = k.replace(old, new)
                break
        if k.endswith(_POINTWISE) and np.ndim(v) == 3:
            v = torch.as_tensor(np.asarray(v))[..., 0]
        out[k] = v
    if any(".conv_module." in k for k in out):
        fold_conformer_batchnorm(out)
    return out


def _fairseq_pointwise(state: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """The port's conformer pointwise weights back to fairseq's k=1 conv
    layout ``(C_out, C_in, 1)``."""
    return {k: v[..., None] if k.endswith(_POINTWISE) and v.dim() == 2
            else v for k, v in state.items()}


def from_fairseq_ctc_state(state: Mapping[str, Any]
                           ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """fairseq CTC ``model`` dict -> (port state dict, ignored keys)."""
    out, ignored = {}, []
    for key, value in canonical_fairseq_state(state).items():
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
    return _fairseq_pointwise(out)


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
    out = _fairseq_pointwise(dict(state))
    if "quantizer.vars" in out:
        out["quantizer.vars"] = state["quantizer.vars"][None]
    return out


def from_fairseq_pretrained_state(state: Mapping[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """fairseq pretrained ``model`` dict -> port ``Wav2Vec2Model`` state
    dict."""
    out = {k: torch.as_tensor(v)
           for k, v in canonical_fairseq_state(state).items()}
    if "quantizer.vars" in out and out["quantizer.vars"].dim() == 3:
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


def encoder_table(topo: Mapping[str, Any], num_fx_layers: int,
                  num_layers: int
                  ) -> List[Tuple[str, Tuple[str, ...], Callable]]:
    """(port key, JAX path, JAX -> port transform) for the body of a
    ``Wav2Vec2Encoder`` of topology ``topo`` (the ``EncoderConfig``
    topology fields; missing ones take their defaults): extractor,
    LayerNorm, input projection, mask embedding and encoder. Port keys
    are fairseq's (HF's for the conformer) relative to the body, as
    ``audio8_tpu/models/convert.py:_encoder_assignments`` names them; JAX
    paths are relative to the body in the JAX tree, the transformer at
    ``encoder/transformer``."""
    mode = topo.get("extractor_mode", "group")
    conformer = topo.get("encoder_type", "transformer") == "conformer"
    gated = topo.get("gated_rel_pos", False)
    out = []

    def add(key, path, tf=_same):
        out.append((key, tuple(path.split("/")), tf))

    def norm(key, path):
        add(key + ".weight", path + "/scale")
        add(key + ".bias", path + "/bias")

    def dense(key, path, bias=True):
        add(key + ".weight", path + "/kernel", _t)
        if bias:
            add(key + ".bias", path + "/bias")

    for i in range(num_fx_layers):
        conv = f"feature_extractor.conv_layers.{i}.0"
        add(conv + ".weight", f"feature_extractor/conv_{i}/kernel", _conv)
        if topo.get("conv_bias", False):
            add(conv + ".bias", f"feature_extractor/conv_{i}/bias")
        if mode == "layer":
            norm(f"feature_extractor.conv_layers.{i}.2.1",
                 f"feature_extractor/ln_{i}")
    if mode == "group":
        norm("feature_extractor.conv_layers.0.2", "feature_extractor/norm_0")
    norm("layer_norm", "layer_norm")
    dense("post_extract_proj", "proj_to_input")
    add("mask_emb", "mask_emb")
    if conformer:
        norm("encoder.layer_norm", "encoder/transformer/ln_out")
        for i in range(num_layers):
            base, ours = f"encoder.layers.{i}", f"encoder/transformer/layer_{i}"
            for ffn in ("ffn1", "ffn2"):
                norm(f"{base}.{ffn}_layer_norm", f"{ours}/{ffn}_ln")
                dense(f"{base}.{ffn}.intermediate_dense",
                      f"{ours}/{ffn}/expand")
                dense(f"{base}.{ffn}.output_dense", f"{ours}/{ffn}/contract")
            norm(f"{base}.self_attn_layer_norm", f"{ours}/attn_ln")
            for hf, mine in (("linear_q", "w_Q"), ("linear_k", "w_K"),
                             ("linear_v", "w_V"), ("linear_out", "w_O")):
                dense(f"{base}.self_attn.{hf}", f"{ours}/self_attn/{mine}")
            if topo.get("position_embeddings_type", "relative") == "relative":
                dense(f"{base}.self_attn.linear_pos",
                      f"{ours}/self_attn/linear_pos", bias=False)
                add(f"{base}.self_attn.pos_bias_u",
                    f"{ours}/self_attn/pos_bias_u")
                add(f"{base}.self_attn.pos_bias_v",
                    f"{ours}/self_attn/pos_bias_v")
            cm = f"{base}.conv_module"
            norm(f"{cm}.layer_norm", f"{ours}/conv/ln")
            dense(f"{cm}.pointwise_conv1", f"{ours}/conv/pw1", bias=False)
            dense(f"{cm}.pointwise_conv2", f"{ours}/conv/pw2", bias=False)
            add(f"{cm}.depthwise_conv.weight", f"{ours}/conv/dw/kernel",
                _conv)
            add(f"{cm}.bn_folded.scale", f"{ours}/conv/bn_scale")
            add(f"{cm}.bn_folded.bias", f"{ours}/conv/bn_bias")
            norm(f"{base}.final_layer_norm", f"{ours}/final_ln")
        return out
    depth = topo.get("pos_conv_depth", 1)
    if depth > 1:
        for i in range(depth):
            add(f"encoder.pos_conv.{i}.0.weight",
                f"encoder/pos_conv/layer_{i}/kernel", _conv)
            add(f"encoder.pos_conv.{i}.0.bias",
                f"encoder/pos_conv/layer_{i}/bias")
    else:
        add("encoder.pos_conv.0.weight_v", "encoder/pos_conv/weight_v", _conv)
        add("encoder.pos_conv.0.weight_g", "encoder/pos_conv/weight_g", _conv)
        add("encoder.pos_conv.0.bias", "encoder/pos_conv/bias")
    # the stack's final norm under pre-norm, the post-pos-conv norm else
    norm("encoder.layer_norm", "encoder/transformer/ln_out"
         if topo.get("pre_norm", False) else "encoder/ln")
    for i in range(num_layers):
        base, ours = f"encoder.layers.{i}", f"encoder/transformer/layer_{i}"
        for fs, mine in (("q_proj", "w_Q"), ("k_proj", "w_K"),
                         ("v_proj", "w_V"), ("out_proj", "w_O")):
            dense(f"{base}.self_attn.{fs}", f"{ours}/self_attn/{mine}")
        norm(f"{base}.self_attn_layer_norm", f"{ours}/ln_attn")
        dense(f"{base}.fc1", f"{ours}/ffn/expand")
        dense(f"{base}.fc2", f"{ours}/ffn/contract")
        norm(f"{base}.final_layer_norm", f"{ours}/ln_ffn")
        if gated:
            dense(f"{base}.self_attn.gru_rel_pos_linear",
                  f"{ours}/self_attn/gru_rel_pos_linear")
            add(f"{base}.self_attn.gru_rel_pos_const",
                f"{ours}/self_attn/gru_rel_pos_const")
    if gated and num_layers:
        add("encoder.layers.0.self_attn.rel_attn_embed.weight",
            "encoder/transformer/rel_pos_bias/rel_attn_embed/embedding")
    return out


def jax_topology(body: Mapping[str, Any]) -> Dict[str, Any]:
    """The topology fields of :func:`encoder_table` read off a JAX
    encoder body's keys."""
    fx, enc = body["feature_extractor"], body["encoder"]
    tr = enc["transformer"]
    layer0 = tr.get("layer_0", {})
    topo = {"extractor_mode": "layer" if "ln_0" in fx else "group",
            "conv_bias": "bias" in fx["conv_0"]}
    if "ffn1" in layer0:
        topo["encoder_type"] = "conformer"
        topo["position_embeddings_type"] = (
            "relative" if "linear_pos" in layer0["self_attn"] else "rotary")
        return topo
    pos = enc["pos_conv"]
    topo["pos_conv_depth"] = sum(1 for k in pos if k.startswith("layer_")) \
        or 1
    topo["pre_norm"] = "ln_out" in tr
    topo["gated_rel_pos"] = "rel_pos_bias" in tr
    return topo


def _body_assignments(tree: Mapping[str, Any], jax_root: Tuple[str, ...],
                      port_root: str):
    """(JAX path, port key, transform) for the encoder body at
    ``jax_root``, its topology and depths read from the tree."""
    body = tree
    for p in jax_root:
        body = body[p]
    num_fx = sum(1 for k in body["feature_extractor"]
                 if k.startswith("conv_"))
    num_layers = sum(1 for k in body["encoder"]["transformer"]
                     if k.startswith("layer_"))
    return [(jax_root + path, port_root + key, tf) for key, path, tf in
            encoder_table(jax_topology(body), num_fx, num_layers)]


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


def jax_named_assignments(module: torch.nn.Module
                          ) -> List[Tuple[Tuple[str, ...], str, Callable]]:
    """(JAX path, port key, transform) for every parameter of a port
    module whose submodules carry the JAX names (a text tower, the
    decoder): :func:`_by_name_assignments` over the JAX layout of the
    module, which undoes its renames: a ``Dense``'s ``weight`` is its
    ``kernel``, a ``LayerNorm``'s its ``scale``, and a child in
    ``_RENAMES`` takes flax's automatic name of its class
    (``TwoHeadConcat_0``). A transform maps a JAX array to the port's and
    is its own inverse (a transpose or nothing)."""
    from audio8_tpu_torch.nn.layers import Dense, LayerNorm

    def layout(mod: torch.nn.Module) -> Dict[str, Any]:
        node: Dict[str, Any] = {}
        for name, p in mod.named_parameters(recurse=False):
            if name == "weight" and isinstance(mod, (Dense, LayerNorm)):
                name = "kernel" if isinstance(mod, Dense) else "scale"
            node[name] = p
        for name, child in mod.named_children():
            flax = f"{type(child).__name__}_0"
            if _RENAMES.get(flax) == name:
                name = flax
            sub = layout(child)
            if sub:
                node[name] = sub
        return node

    out = _by_name_assignments(layout(module), (), "")
    keys = [k for _, k, _ in out]
    if sorted(keys) != sorted(n for n, _ in module.named_parameters()):
        raise KeyError(f"{type(module).__name__}: parameters without JAX "
                       "names")
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


def _opt_count(opt_state: Any):
    """The step count of a JAX optimizer state: the outermost ``count``
    (optax's inject_hyperparams state, which SGD's is, or an Adam
    state)."""
    if hasattr(opt_state, "count"):
        return opt_state.count
    if isinstance(opt_state, (tuple, list)):
        for child in opt_state:
            found = _opt_count(child)
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

    With ``opt_state`` (the JAX AdamW or SGD state, arrays as numpy) it
    returns ``(state_dict, (count, mu, nu))`` where ``mu`` and ``nu``
    are state dicts laid out like the parameters (``None`` for SGD,
    whose state is its count): feed them to
    ``train.optim.TrainState.load_opt_state``."""
    state = _params_from_jax(tree)
    if opt_state is None:
        return state
    adam = _adam_state(opt_state)
    if adam is not None:
        return state, (int(np.asarray(adam.count)),
                       _params_from_jax(adam.mu), _params_from_jax(adam.nu))
    count = _opt_count(opt_state)
    if count is None:
        raise KeyError("no step count in the JAX optimizer state")
    return state, (int(np.asarray(count)), None, None)


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
