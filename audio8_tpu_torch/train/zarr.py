"""zarr v2 arrays, as Orbax keeps each leaf of a checkpoint: read from an
OCDBT store (``train/ocdbt.py``) or from a plain directory, and written
to a plain directory.

An array at ``name`` is a ``name/.zarray`` JSON (``shape``, ``chunks``,
``dtype``, ``compressor``, ``fill_value``, ``order``, ``filters``,
``dimension_separator``) and one value per chunk at
``name/<i>.<j>...`` (``name/0`` for a 0-d array), each chunk the C-order
bytes of a whole chunk, edge chunks included, compressed or not. A
missing chunk is ``fill_value`` (0 where it is ``null``).

Read: C order, compressor ``zstd`` (the port's own decoder) or ``null``,
no filters, the dtypes of ``DTYPES``. A ``bfloat16`` array comes back as
a ``torch.bfloat16`` tensor made from its bits (numpy has no bfloat16);
every other array as a numpy array.

Write: the plain form Orbax restores with ``use_ocdbt: false``: one
directory per leaf, one chunk of the whole array, ``compressor: null``.
"""
from __future__ import annotations

import itertools
import json
import os
from typing import Callable, Optional, Union

import numpy as np
import torch

from audio8_tpu_torch.csrc import native

# zarr v2 dtype strings read and written (numpy's own spelling, and
# tensorstore's "bfloat16")
DTYPES = ("<f4", "<f2", "<f8", "<i4", "<i8", "<u4", "|b1", "|i1", "|u1",
          "bfloat16")
BF16 = "bfloat16"

Array = Union[np.ndarray, torch.Tensor]


def _np_dtype(name: str) -> np.dtype:
    if name not in DTYPES:
        raise ValueError(f"zarr dtype {name!r}: want one of {DTYPES}")
    return np.dtype("<u2") if name == BF16 else np.dtype(name)


def read_array(get: Callable[[str], Optional[bytes]], name: str) -> Array:
    """The array ``name`` of a store whose ``get(key)`` gives a value or
    ``None`` (a ``bytearray`` value is taken over without a copy)."""
    raw = get(f"{name}/.zarray")
    if raw is None:
        raise KeyError(f"no zarr array at {name!r}")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr_format {meta.get('zarr_format')}")
    if meta.get("order", "C") != "C" or meta.get("filters"):
        raise ValueError(f"{name}: only C order without filters is read")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {comp.get('id')!r}")
    dtype = _np_dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value")
    grid = [range(-(-s // c)) if c else range(0)
            for s, c in zip(shape, chunks)]
    whole = chunks == shape and int(np.prod(shape)) > 0
    out = None if whole else np.full(shape, 0 if fill is None else fill,
                                     dtype)
    for idx in itertools.product(*grid):
        key = sep.join(map(str, idx)) if idx else "0"
        data = get(f"{name}/{key}")
        if data is None:
            continue
        if comp is not None:
            data = bytearray(native.zstd_decompress(data))
        chunk = np.frombuffer(data, dtype)
        if chunk.size != int(np.prod(chunks)):
            raise ValueError(f"{name}/{key}: {chunk.size} values, want a "
                             f"chunk of {chunks}")
        chunk = chunk.reshape(chunks)
        if whole:
            out = chunk if isinstance(data, bytearray) else chunk.copy()
            continue
        box = tuple(slice(i * c, min((i + 1) * c, s))
                    for i, c, s in zip(idx, chunks, shape))
        out[box] = chunk[tuple(slice(0, b.stop - b.start) for b in box)]
    if out is None:  # one chunk, missing
        out = np.full(shape, 0 if fill is None else fill, dtype)
    if meta["dtype"] == BF16:
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


def directory_getter(root: str) -> Callable[[str], Optional[bytes]]:
    """``get`` over a plain directory: key ``a/b`` is the file
    ``root/a/b``."""

    def get(key: str) -> Optional[bytes]:
        path = os.path.join(root, key)
        if not os.path.isfile(path):
            return None
        buf = bytearray(os.path.getsize(path))
        with open(path, "rb") as f:
            f.readinto(buf)
        return buf

    return get


def zarr_dtype(array: Array) -> str:
    """The zarr v2 dtype string of an array or tensor."""
    if isinstance(array, torch.Tensor):
        if array.dtype == torch.bfloat16:
            return BF16
        array = array.numpy()
    name = array.dtype.newbyteorder("<").str if array.dtype.itemsize > 1 \
        else array.dtype.str
    if name not in DTYPES:
        raise ValueError(f"dtype {array.dtype} is not written (want one of "
                         f"{DTYPES})")
    return name


def write_array(path: str, array: Array) -> None:
    """Write ``array`` (numpy, or a CPU tensor; bf16 as its bits) as a
    plain zarr v2 directory at ``path``: one uncompressed chunk of the
    whole array. A zero-size array raises, as Orbax refuses to save
    one."""
    dtype = zarr_dtype(array)
    if isinstance(array, torch.Tensor):
        t = array.detach().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        array = t.numpy()
    array = np.asarray(array, order="C")  # keeps a 0-d array 0-d
    if array.size == 0:
        raise ValueError(f"{path}: cannot save an array of zero size")
    os.makedirs(path, exist_ok=True)
    meta = {"chunks": list(array.shape), "compressor": None,
            "dimension_separator": ".", "dtype": dtype, "fill_value": None,
            "filters": None, "order": "C", "shape": list(array.shape),
            "zarr_format": 2}
    with open(os.path.join(path, ".zarray"), "w") as f:
        json.dump(meta, f, sort_keys=True)
    key = ".".join("0" for _ in array.shape) or "0"
    data = array.astype(array.dtype.newbyteorder("<"), copy=False)
    with open(os.path.join(path, key), "wb") as f:
        f.write(data.reshape(-1).view(np.uint8))
