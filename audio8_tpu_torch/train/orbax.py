"""The JAX package's Orbax checkpoints (``audio8_tpu/train/checkpoint.py``)
read and written by the port, with no ``orbax``, ``tensorstore`` or
``zstandard``.

A checkpoint is a directory ``{base}-{tick_type}-{step}`` holding
``_METADATA`` (JSON: ``tree_metadata`` names every leaf by its key path,
``key_type`` 2 a dict key and 1 a sequence index, ``value_type``
``np.ndarray`` or ``None``; ``use_ocdbt`` says where the arrays are),
``_CHECKPOINT_METADATA`` and the arrays, one zarr v2 array per leaf
named by its keys joined with dots (``params.encoder.proj.kernel``,
``train/zarr.py``):

- ``use_ocdbt: true`` (what the JAX package writes): the arrays live in
  an OCDBT database (``train/ocdbt.py``), each chunk zstd-compressed;
- ``use_ocdbt: false``: each array is a directory of its own.

:func:`load_checkpoint` reads both and returns the tree JAX's
``load_checkpoint(path)`` returns without a target: dicts, lists for
sequence keys, ``None`` leaves, numpy arrays (bfloat16 ones as
``torch.bfloat16`` tensors). :func:`save_checkpoint` writes the second
form, with uncompressed chunks, which the JAX package's
``load_checkpoint`` restores with and without a target. That is a
deviation: JAX writes OCDBT with zstd, the port the plain layout, so the
port needs no compressor and no OCDBT writer.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from audio8_tpu_torch.train import zarr
from audio8_tpu_torch.train.ocdbt import OcdbtStore

METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
_DICT_KEY, _SEQ_KEY = 2, 1
_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
            "StandardCheckpointHandler")


def is_orbax_dir(path: str) -> bool:
    """Whether ``path`` is an Orbax checkpoint (it has ``_METADATA``)."""
    return os.path.isfile(os.path.join(path, METADATA))


def load_checkpoint(path: str) -> Any:
    """The tree of the Orbax checkpoint at ``path``, as JAX's
    ``load_checkpoint(path)`` gives it."""
    path = os.path.abspath(path)
    with open(os.path.join(path, METADATA)) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: zarr3 arrays are not read")
    if meta.get("use_ocdbt"):
        store = OcdbtStore(path)

        def get(key):
            return store.get(key.encode())
    else:
        get = zarr.directory_getter(path)
    root: Dict = {}
    for entry in meta["tree_metadata"].values():
        keys = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
        value = entry["value_metadata"]
        kind = value["value_type"]
        if kind == "None" or value.get("skip_deserialize"):
            leaf = None
        elif kind == "np.ndarray":
            leaf = zarr.read_array(get, ".".join(k for k, _ in keys))
        else:
            raise ValueError(f"{path}: leaf {keys} of type {kind!r} is not "
                             "read")
        node = root
        for key, key_type in keys[:-1]:
            node = node.setdefault(int(key) if key_type == _SEQ_KEY
                                   else key, {})
        key, key_type = keys[-1]
        node[int(key) if key_type == _SEQ_KEY else key] = leaf
    return _lists(root, meta["tree_metadata"])


def _seq_paths(tree_metadata: Dict) -> set:
    """The key paths (tuples) of every node whose children are sequence
    entries."""
    out = set()
    for entry in tree_metadata.values():
        keys = entry["key_metadata"]
        for i, k in enumerate(keys):
            if k["key_type"] == _SEQ_KEY:
                out.add(tuple(x["key"] for x in keys[:i]))
    return out


def _lists(root: Dict, tree_metadata: Dict) -> Any:
    seqs = _seq_paths(tree_metadata)

    def walk(node, path):
        if not isinstance(node, dict):
            return node
        out = {k: walk(v, path + (str(k),)) for k, v in node.items()}
        if path in seqs:
            return [out[i] for i in range(len(out))]
        return out

    return walk(root, ())


def _leaves(tree: Any, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(key path of (key, key_type) pairs, leaf) for every leaf."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _leaves(v, prefix + ((str(k), _DICT_KEY),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _leaves(v, prefix + ((str(i), _SEQ_KEY),))
        return out
    return [(prefix, tree)]


def _as_array(leaf: Any):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu()
    if isinstance(leaf, bool):
        return np.asarray(leaf, np.bool_)
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    if isinstance(leaf, float):
        return np.asarray(leaf, np.float32)
    return np.asarray(leaf)


def save_checkpoint(tree: Any, base: str, step: int,
                    tick_type: str = "step") -> str:
    """Write ``tree`` (nested dicts, lists or tuples of numpy arrays, CPU
    tensors, Python numbers or ``None``) as the Orbax checkpoint
    ``{base}-{tick_type}-{step}`` (replacing one that is there) in the
    plain layout (``use_ocdbt: false``, uncompressed chunks); returns its
    path. The directory is written under a temporary name and renamed
    when complete."""
    path = os.path.abspath(f"{base}-{tick_type}-{step}")
    tmp = f"{path}.orbax-checkpoint-tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    start = time.time_ns()
    tree_md = {}
    for keys, leaf in _leaves(tree):
        names = tuple(k for k, _ in keys)
        if leaf is None:
            value = {"value_type": "None", "skip_deserialize": True}
        else:
            zarr.write_array(os.path.join(tmp, ".".join(names)),
                             _as_array(leaf))
            value = {"value_type": "np.ndarray", "skip_deserialize": False}
        tree_md[str(names)] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in keys],
            "value_metadata": value}
    meta = {"tree_metadata": tree_md, "use_ocdbt": False,
            "use_zarr3": False, "store_array_data_equal_to_fill_value": True,
            "custom_metadata": None}
    for name, blob in (
            (METADATA, meta),
            (CHECKPOINT_METADATA, {
                "item_handlers": _HANDLER, "metrics": {},
                "performance_metrics": {}, "init_timestamp_nsecs": start,
                "commit_timestamp_nsecs": time.time_ns(),
                "custom_metadata": {}})):
        with open(os.path.join(tmp, name), "w") as f:
            json.dump(blob, f)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return path
