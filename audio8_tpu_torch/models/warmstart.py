"""Warm start of the paired model's text tower from a pretrained
transformer-LM ``.npz`` (``audio8_tpu/models/warmstart.py``), on the
port's modules.

The ``.npz`` is a flat dict of arrays under the JAX text tower's flax
paths joined with ``/`` (``embeddings/embedding``,
``transformer/layer_0/self_attn/w_Q/kernel``), as :func:`save_tlm_npz`
and the JAX ``save_tlm_npz`` write them. Keys may also be torch-style
(``.`` separators, ``.weight`` for a Dense kernel, transposed, or an
embedding); :func:`convert_transformers_keys` turns HF BERT-style keys
into the flax-path ones. The port's text tower carries the JAX names, so
the overlay goes through ``models.convert.jax_named_assignments``: the
module's parameters in the JAX layout, overlaid as the JAX package
overlays its tree, then written back. Arrays that match no parameter
(path or shape) are reported, not fatal, and so are the parameters the
file does not hold.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from audio8_tpu_torch.models.convert import jax_named_assignments


def _jax_layout(module: torch.nn.Module):
    """``{"/"-joined JAX path: (port key, transform)}`` and the flat JAX
    arrays, in the JAX tree's order (sorted per level)."""
    state = module.state_dict()
    table = {"/".join(path): (key, tf)
             for path, key, tf in sorted(jax_named_assignments(module))}
    flat = {path: tf(state[key].detach().float().cpu().numpy())
            for path, (key, tf) in table.items()}
    return table, flat


def load_tlm_npz(module: torch.nn.Module, npz_file: str) -> Dict[str, List]:
    """Overlay the arrays of ``npz_file`` onto ``module`` (the port's text
    tower, e.g. ``DualEncoderModel.text_encoder``) in place; returns the
    JAX package's report: ``loaded`` and ``unexpected`` file keys, in the
    file's order, and the ``missing_in_npz`` JAX paths."""
    table, flat = _jax_layout(module)
    blob = np.load(npz_file, allow_pickle=False)
    loaded: List[str] = []
    unexpected: List[str] = []
    for key in blob.files:
        arr = np.asarray(blob[key])
        norm = key.replace(".", "/")
        if norm.endswith("/weight"):  # a torch-style Dense or embedding
            stem = norm[:-len("/weight")]
            if stem + "/kernel" in flat and \
                    flat[stem + "/kernel"].shape == arr.T.shape:
                flat[stem + "/kernel"] = arr.T.astype(np.float32)
                loaded.append(key)
                continue
            if stem + "/embedding" in flat and \
                    flat[stem + "/embedding"].shape == arr.shape:
                flat[stem + "/embedding"] = arr.astype(np.float32)
                loaded.append(key)
                continue
        if norm in flat and flat[norm].shape == arr.shape:
            flat[norm] = arr.astype(np.float32)
            loaded.append(key)
        else:
            unexpected.append(key)
    given = {k.replace(".", "/") for k in blob.files}
    missing = [path for path in flat if path not in given]
    params = dict(module.named_parameters())
    with torch.no_grad():
        for path, (key, tf) in table.items():
            p = params[key]
            p.copy_(torch.from_numpy(np.ascontiguousarray(tf(flat[path])))
                    .to(p.dtype))
    return {"loaded": loaded, "unexpected": unexpected,
            "missing_in_npz": missing}


def save_tlm_npz(module: torch.nn.Module, npz_file: str) -> None:
    """Write ``module``'s parameters (a text tower) as the flat ``.npz``
    of flax-path keys that both packages' ``load_tlm_npz`` read."""
    _, flat = _jax_layout(module)
    np.savez(npz_file, **flat)


def convert_transformers_keys(state: Dict[str, np.ndarray]
                              ) -> Dict[str, np.ndarray]:
    """HF-transformers BERT-style encoder keys -> the text tower's
    ``.npz`` keys (the JAX ``convert_transformers_keys``), for
    :func:`load_tlm_npz`:

      embeddings.word_embeddings.weight          -> embeddings/embedding
      encoder.layer.N.attention.self.{query,key,value}  (w_Q, w_K, w_V)
      encoder.layer.N.attention.output.dense     (w_O)
      encoder.layer.N.attention.output.LayerNorm (ln_attn)
      encoder.layer.N.intermediate.dense         (ffn expand)
      encoder.layer.N.output.dense               (ffn contract)
      encoder.layer.N.output.LayerNorm           (ln_ffn)
    """
    out: Dict[str, np.ndarray] = {}

    def lin(src: str, dst: str) -> None:
        if src + ".weight" in state:
            out[dst + "/kernel"] = np.asarray(state[src + ".weight"]).T
        if src + ".bias" in state:
            out[dst + "/bias"] = np.asarray(state[src + ".bias"])

    def ln(src: str, dst: str) -> None:
        if src + ".weight" in state:
            out[dst + "/scale"] = np.asarray(state[src + ".weight"])
        if src + ".bias" in state:
            out[dst + "/bias"] = np.asarray(state[src + ".bias"])

    for k in state:
        if k.endswith("embeddings.word_embeddings.weight"):
            out["embeddings/embedding"] = np.asarray(state[k])
    layers = set()
    for k in state:
        parts = k.split(".")
        for i, p in enumerate(parts):
            if p == "layer" and i + 1 < len(parts) and parts[i + 1].isdigit():
                layers.add(int(parts[i + 1]))
    prefix = ""
    for cand in ("encoder.layer.", "bert.encoder.layer."):
        if any(k.startswith(cand) for k in state):
            prefix = cand
            break
    for n in sorted(layers):
        src, dst = f"{prefix}{n}", f"transformer/layer_{n}"
        lin(f"{src}.attention.self.query", f"{dst}/self_attn/w_Q")
        lin(f"{src}.attention.self.key", f"{dst}/self_attn/w_K")
        lin(f"{src}.attention.self.value", f"{dst}/self_attn/w_V")
        lin(f"{src}.attention.output.dense", f"{dst}/self_attn/w_O")
        ln(f"{src}.attention.output.LayerNorm", f"{dst}/ln_attn")
        lin(f"{src}.intermediate.dense", f"{dst}/ffn/expand")
        lin(f"{src}.output.dense", f"{dst}/ffn/contract")
        ln(f"{src}.output.LayerNorm", f"{dst}/ln_ffn")
    return out

