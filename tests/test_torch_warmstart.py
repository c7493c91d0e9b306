"""``--warmstart_text``: the port's ``models/warmstart.py`` against the
JAX package's, on the paired model's text tower (rpr transformer, a
two-head reduction) and on the bag-of-words tower, on the CPU.

For each of JAX's three ``.npz`` forms, each written from the tower's
weights shifted by 0.25:

* flax-path keys (``save_tlm_npz``),
* torch-style keys (``.`` separators, Dense kernels as ``(out, in)``
  ``.weight``, embeddings as ``.weight``),
* HF BERT-style keys turned into flax paths by
  ``convert_transformers_keys`` (a BERT state dict built from the second
  weights, with extra pooler and position keys the tower does not hold),

the port's overlaid tower equals JAX's overlaid tree (converted by
``params_from_jax``) bitwise, and the report (``loaded``,
``unexpected``, ``missing_in_npz``) equals JAX's. The port's
``save_tlm_npz`` writes the keys and arrays of JAX's own export, and
loads in JAX with nothing unexpected and nothing missing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.models.warmstart import \
    convert_transformers_keys as jax_convert
from audio8_tpu.models.warmstart import load_tlm_npz as jax_load
from audio8_tpu.models.warmstart import save_tlm_npz as jax_save
from audio8_tpu_torch.models.convert import params_from_jax
from audio8_tpu_torch.models.warmstart import (convert_transformers_keys,
                                               load_tlm_npz, save_tlm_npz)
from tests.test_torch_paired import models
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()


def _towers(text_type):
    """The JAX paired params, their text tower and the tower shifted by
    0.25 (numpy trees), and the port's paired module on the params."""
    _, _, params, module = models(0.0, jnp.float32, torch.float32,
                                  text_type)
    first = params["model"]["text_encoder"]
    second = jax.tree.map(lambda a: a + np.float32(0.25), first)
    return params, first, second, module


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _torch_style(tree):
    out = {}
    for path, v in _flat(tree):
        key = ".".join(path)
        if path[-1] == "kernel":
            out[key[:-len("kernel")] + "weight"] = v.T
        elif path[-1] == "embedding":
            out[key[:-len("embedding")] + "weight"] = v
        else:
            out[key] = v
    return out


def _bert_style(tree):
    """A BERT-style state dict holding the tower's transformer and
    embeddings, plus keys the tower lacks."""
    out = {"bert.embeddings.word_embeddings.weight":
           np.asarray(tree["embeddings"]["embedding"]),
           "bert.embeddings.position_embeddings.weight": np.ones((4, 2)),
           "bert.pooler.dense.weight": np.ones((3, 3))}
    names = {"w_Q": "attention.self.query", "w_K": "attention.self.key",
             "w_V": "attention.self.value",
             "w_O": "attention.output.dense"}
    for lname, layer in tree["transformer"].items():
        n = lname.split("_")[1]
        pre = f"bert.encoder.layer.{n}."
        for w, hf in names.items():
            out[pre + hf + ".weight"] = layer["self_attn"][w]["kernel"].T
            out[pre + hf + ".bias"] = layer["self_attn"][w]["bias"]
        out[pre + "intermediate.dense.weight"] = \
            layer["ffn"]["expand"]["kernel"].T
        out[pre + "intermediate.dense.bias"] = layer["ffn"]["expand"]["bias"]
        out[pre + "output.dense.weight"] = layer["ffn"]["contract"]["kernel"].T
        out[pre + "output.dense.bias"] = layer["ffn"]["contract"]["bias"]
        for ln, hf in (("ln_attn", "attention.output.LayerNorm"),
                       ("ln_ffn", "output.LayerNorm")):
            out[pre + hf + ".weight"] = layer[ln]["scale"]
            out[pre + hf + ".bias"] = layer[ln]["bias"]
    return out


def _write(form, second, path):
    if form == "flax":
        jax_save(second, path)
    elif form == "torch":
        np.savez(path, **_torch_style(second))
    else:
        keys = jax_convert(_bert_style(second))
        ours = convert_transformers_keys(_bert_style(second))
        assert sorted(keys) == sorted(ours)
        for k in keys:
            np.testing.assert_array_equal(ours[k], keys[k])
        np.savez(path, **keys)


@pytest.mark.parametrize("text_type,form", [
    ("transformer", "flax"), ("transformer", "torch"), ("transformer", "bert"),
    ("bow", "flax"), ("bow", "torch")])
def test_overlay_and_report_match_jax(tmp_path, text_type, form):
    params, first, second, module = _towers(text_type)
    path = str(tmp_path / "tlm.npz")
    _write(form, second, path)
    want_tree, want_report = jax_load(first, path)
    report = load_tlm_npz(module.model.text_encoder, path)
    assert report == want_report
    assert report["loaded"] and not report["unexpected"]
    full = dict(params, model=dict(params["model"], text_encoder=want_tree))
    want = params_from_jax(full)
    got = module.state_dict()
    for k, v in want.items():
        if k.startswith("model.text_encoder."):
            assert torch.equal(got[k], v), k
    key = "model.text_encoder.embeddings.embedding"
    assert torch.equal(got[key], torch.from_numpy(
        np.asarray(second["embeddings"]["embedding"])))


def test_bert_form_reports_what_it_lacks(tmp_path):
    _, first, second, module = _towers("transformer")
    path = str(tmp_path / "tlm.npz")
    _write("bert", second, path)
    report = load_tlm_npz(module.model.text_encoder, path)
    assert not report["unexpected"]  # the converter drops foreign keys
    assert any("rpr_key_emb" in m for m in report["missing_in_npz"])
    assert any("reduction" in m for m in report["missing_in_npz"])


@pytest.mark.parametrize("text_type", ["transformer", "bow"])
def test_port_export_loads_in_jax(tmp_path, text_type):
    _, first, second, module = _towers(text_type)
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    save_tlm_npz(module.model.text_encoder, ours)
    jax_save(first, theirs)
    a, b = np.load(ours), np.load(theirs)
    assert a.files == b.files
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    merged, report = jax_load(second, ours)
    assert not report["unexpected"] and not report["missing_in_npz"]
    for (pa, va), (pb, vb) in zip(_flat(merged), _flat(first)):
        assert pa == pb
        np.testing.assert_array_equal(va, vb)
