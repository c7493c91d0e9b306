"""A read-only OCDBT key-value store: the layout tensorstore's ``ocdbt``
driver writes, in which the JAX package's Orbax checkpoints keep their
arrays (``_METADATA``'s ``use_ocdbt: true``).

A database is a directory with a ``manifest.ocdbt`` and data files
under ``d/``. Every manifest and B+tree node is a file or a byte range of
a data file that starts with a 4-byte magic (``0x0cdb3a2a`` manifest,
``0x0cdb20de`` node, big-endian), its length as a u64 (little-endian),
the varints version 0 and compression (0 none, 1 zstd), then its body
and a CRC32C of everything before it. Numbers in a body are LEB128
varints unless said otherwise; arrays are stored column by column.

- the manifest's body is the config (a 16-byte uuid, the manifest kind,
  the largest inline value, the largest decoded node, the version tree's
  arity as a byte, the compression with zstd's level as an int32) and
  the version tree's newest leaf: a data file table, then per version its
  generation, root height (a byte), root address (data file, offset,
  length), statistics and commit time. The newest version's root is the
  tree this store reads; older versions are never needed;
- a data file table lists paths relative to the database's directory,
  each stored as the length it shares with the previous path, its own
  suffix and the length of its base path;
- a node's body is its height (a byte), its data file table and its
  entries. Keys are prefix-compressed against the previous key of the
  node, and relative to the prefix its parent gives it. A leaf (height
  0) gives per entry its value's length and kind: 0 inline (the bytes
  follow, in order, at the end), 1 a reference (data file, offset; the
  length above). An interior node gives per entry the length of the key
  prefix its child's keys share, the child's address and its
  statistics.

Orbax writes one database per process under ``ocdbt.process_N/`` and a
root manifest whose tree points into them with paths such as
``ocdbt.process_0/d/<hex>``; those read like any other path.

The format follows tensorstore's documentation of the OCDBT driver. The
zstd bodies and the checksums go through the port's own host library
(``csrc/zstd.cc``); no ``tensorstore`` or ``zstandard`` is used.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple

from audio8_tpu_torch.csrc import native

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_NULL = (1 << 64) - 1  # the offset and length of an empty tree's root


class OcdbtError(ValueError):
    """A file that is not the OCDBT layout, or is corrupt."""


class _Body:
    """A cursor over a decoded body."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise OcdbtError(f"{self.what}: truncated")
        self.pos += 1
        return self.data[self.pos - 1]

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise OcdbtError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise OcdbtError(f"{self.what}: truncated")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def keys(self, n: int, common_prefix: bool = False
             ) -> Tuple[List[bytes], List[int]]:
        """``n`` prefix-compressed keys (and, in an interior node, the
        length of the prefix each child's keys share)."""
        shared = [0] + self.varints(n - 1) if n else []
        suffix = self.varints(n)
        common = self.varints(n) if common_prefix else []
        keys, prev = [], b""
        for s, k in zip(shared, suffix):
            if s > len(prev):
                raise OcdbtError(f"{self.what}: bad key prefix")
            prev = prev[:s] + self.raw(k)
            keys.append(prev)
        return keys, common

    def file_table(self) -> List[str]:
        n = self.varint()
        shared = [0] + self.varints(n - 1) if n else []
        suffix = self.varints(n)
        self.varints(n)  # base path lengths: the split does not matter here
        paths, prev = [], b""
        for s, k in zip(shared, suffix):
            prev = prev[:s] + self.raw(k)
            paths.append(prev.decode())
        return paths


def decode_file(blob: bytes, magic: int, what: str) -> bytes:
    """The body of one manifest or node, its header, length and CRC32C
    checked and its zstd decoded."""
    if len(blob) < 18:
        raise OcdbtError(f"{what}: too short")
    got, length = struct.unpack_from(">I", blob)[0], struct.unpack_from(
        "<Q", blob, 4)[0]
    if got != magic:
        raise OcdbtError(f"{what}: magic {got:#x}, want {magic:#x}")
    if length != len(blob):
        raise OcdbtError(f"{what}: length {length}, have {len(blob)}")
    crc = struct.unpack_from("<I", blob, len(blob) - 4)[0]
    if native.crc32c(memoryview(blob)[:-4]) != crc:
        raise OcdbtError(f"{what}: CRC32C mismatch")
    head = _Body(blob[12:16], what)
    if head.varint() != 0:
        raise OcdbtError(f"{what}: unknown format version")
    compression = head.varint()
    body = memoryview(blob)[12 + head.pos:-4]
    if compression == 0:
        return bytes(body)
    if compression == 1:
        return native.zstd_decompress(body)
    raise OcdbtError(f"{what}: unknown compression {compression}")


class OcdbtStore:
    """The newest version of the OCDBT database in ``root``: its keys
    (bytes, sorted) and values. Each data file is read once and kept for
    the store's life; open one store per checkpoint read."""

    def __init__(self, root: str):
        self.root = root
        self._files: Dict[str, bytes] = {}
        path = os.path.join(root, "manifest.ocdbt")
        if not os.path.exists(path):
            raise OcdbtError(f"{root}: no manifest.ocdbt (a numbered "
                             "manifest is not read)")
        with open(path, "rb") as f:
            body = _Body(decode_file(f.read(), MANIFEST_MAGIC, path), path)
        body.raw(16)  # uuid
        if body.varint() != 0:
            raise OcdbtError(f"{path}: only a single-file manifest is read")
        body.varint()  # max_inline_value_bytes
        body.varint()  # max_decoded_node_bytes
        body.byte()    # version_tree_arity_log2
        if body.varint() == 1:
            body.raw(4)  # zstd level, int32
        files = body.file_table()
        n = body.varint()
        self._values: Dict[bytes, Tuple] = {}
        if n == 0:
            return
        body.varints(n)  # generation numbers, oldest first
        heights = [body.byte() for _ in range(n)]
        ids, offsets, lengths = (body.varints(n), body.varints(n),
                                 body.varints(n))
        if offsets[-1] == _NULL:
            return  # the newest version is empty
        self._node(files[ids[-1]], offsets[-1], lengths[-1], heights[-1],
                   b"")

    def _read(self, path: str, offset: int, length: int) -> memoryview:
        data = self._files.get(path)
        if data is None:
            with open(os.path.join(self.root, path), "rb") as f:
                data = self._files[path] = f.read()
        if offset + length > len(data):
            raise OcdbtError(f"{path}: range past its end")
        return memoryview(data)[offset:offset + length]

    def _node(self, path: str, offset: int, length: int, height: int,
              prefix: bytes) -> None:
        what = f"{path}@{offset}"
        body = _Body(decode_file(bytes(self._read(path, offset, length)),
                                 NODE_MAGIC, what), what)
        if body.byte() != height:
            raise OcdbtError(f"{what}: height is not its parent's")
        files = body.file_table()
        n = body.varint()
        if height == 0:
            keys, _ = body.keys(n)
            lengths = body.varints(n)
            kinds = body.varints(n)
            refs = [i for i, k in enumerate(kinds) if k == 1]
            ids, offs = body.varints(len(refs)), body.varints(len(refs))
            for i, f, o in zip(refs, ids, offs):
                self._values[prefix + keys[i]] = (files[f], o, lengths[i])
            for i, k in enumerate(kinds):
                if k == 0:
                    self._values[prefix + keys[i]] = (body.raw(lengths[i]),)
                elif k != 1:
                    raise OcdbtError(f"{what}: unknown value kind {k}")
            return
        keys, common = body.keys(n, common_prefix=True)
        ids, offs, lens = body.varints(n), body.varints(n), body.varints(n)
        for key, c, f, o, ln in zip(keys, common, ids, offs, lens):
            self._node(files[f], o, ln, height - 1, prefix + key[:c])

    def keys(self) -> List[bytes]:
        return sorted(self._values)

    def get(self, key: bytes) -> Optional[bytes]:
        """The value at ``key``, or ``None``."""
        ref = self._values.get(key)
        if ref is None:
            return None
        if len(ref) == 1:
            return ref[0]
        return bytes(self._read(*ref))
