"""ctypes bindings of the port's host library (``csrc/*.cc``, plain C ABI):
edit distance, the CTC prefix beam search without and with LM fusion,
the ARPA and KenLM-binary LM readers, the FLAC decoder, and the zstd
decoder with the CRC32C and XXH64 checksums that read the JAX package's
Orbax checkpoints (``train/ocdbt.py``, ``train/zarr.py``).

The library is built with ``g++`` at first use (``csrc/build.py:
build_host``) and loaded once per process; nothing is built or loaded
when this module is imported. If it cannot be built, the first call
raises: there is no Python fallback. The plain Python versions the
tests hold these functions to are ``ops.metrics.edit_distance_plain``,
``ops.beam._prefix_beam_search_py`` and ``ops.lm.ArpaLM``.
"""
from __future__ import annotations

import ctypes
import gzip
import os
import shutil
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from audio8_tpu_torch.csrc import build as _build

_P64 = ctypes.POINTER(ctypes.c_int64)
_P32 = ctypes.POINTER(ctypes.c_int32)
_PF = ctypes.POINTER(ctypes.c_float)
_I64 = ctypes.c_int64
_F = ctypes.c_float

# C function -> (restype, argtypes)
_SIGNATURES = {
    "a8t_edit_distance": (_I64, [_P64, _I64, _P64, _I64]),
    "a8t_prefix_beam_search": (_I64, [_PF, _I64, _I64, _I64, _I64, _I64,
                                      _F, _F, _I64, _P64, _P64, _I64]),
    "a8t_prefix_beam_search_lm": (_I64, [_PF, _I64, _I64, _I64, _I64, _I64,
                                         _F, _F, _I64, ctypes.c_char_p,
                                         _P64, ctypes.c_void_p, _P64, _P64,
                                         _I64]),
    "a8t_flac_read": (_I64, [ctypes.c_char_p, _P32, _P32, _P32, _P64, _P32,
                             _I64]),
    "a8t_lm_load": (ctypes.c_void_p, [ctypes.c_char_p]),
    "a8t_lm_load_kenlm": (ctypes.c_void_p, [ctypes.c_char_p]),
    "a8t_lm_free": (None, [ctypes.c_void_p]),
    "a8t_lm_logp": (_F, [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p]),
    "a8t_zstd_decompress": (ctypes.c_void_p, [ctypes.c_void_p, _I64, _P64,
                                              ctypes.c_char_p, _I64]),
    "a8t_free": (None, [ctypes.c_void_p]),
    "a8t_crc32c": (ctypes.c_uint32, [ctypes.c_void_p, _I64, ctypes.c_uint32]),
    "a8t_xxh64": (ctypes.c_uint64, [ctypes.c_void_p, _I64, ctypes.c_uint64]),
}

_lock = threading.Lock()
_loaded: Optional[ctypes.CDLL] = None


def lib() -> ctypes.CDLL:
    """The host library, built and loaded on first use."""
    global _loaded
    with _lock:
        if _loaded is None:
            handle = ctypes.CDLL(_build.build_host())
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.restype, fn.argtypes = restype, argtypes
            _loaded = handle
        return _loaded


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _intern_pair(a: Sequence, b: Sequence):
    """Map arbitrary hashable tokens to dense ids (exact equality)."""
    table = {}

    def enc(seq):
        out = np.empty(len(seq), np.int64)
        for i, tok in enumerate(seq):
            out[i] = table.setdefault(tok, len(table))
        return out

    return enc(list(a)), enc(list(b))


def edit_distance(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance of two sequences of hashable tokens."""
    an, bn = _intern_pair(a, b)
    return int(lib().a8t_edit_distance(_ptr(an, ctypes.c_int64), len(an),
                                       _ptr(bn, ctypes.c_int64), len(bn)))


def prefix_beam_search(log_probs: np.ndarray, blank: int, beam: int,
                       space_idx: int = -1, alpha: float = 0.0,
                       beta: float = 0.0, n_best: int = 0) -> List[List[int]]:
    """Decode one utterance (T, V) -> n-best id sequences."""
    lp = np.ascontiguousarray(log_probs, np.float32)
    t, v = lp.shape
    n_best = n_best if n_best > 0 else beam
    out_ids = np.zeros((n_best, t), np.int64)
    out_lens = np.zeros((n_best,), np.int64)
    n = lib().a8t_prefix_beam_search(
        _ptr(lp, ctypes.c_float), t, v, blank, beam, space_idx, alpha, beta,
        n_best, _ptr(out_ids, ctypes.c_int64), _ptr(out_lens, ctypes.c_int64),
        t)
    return [out_ids[i, :out_lens[i]].tolist() for i in range(int(n))]


class NativeLM:
    """A handle over the C ABI ``Lm*`` (``csrc/lm_iface.h``). ``logp`` has
    ``ops.lm.ArpaLM``'s interface; the handle feeds
    :func:`prefix_beam_search_lm` directly."""

    _h = None

    def logp(self, word: str, context) -> float:
        ctx = context if isinstance(context, str) else " ".join(context)
        return float(lib().a8t_lm_logp(self._h, word.encode(), ctx.encode()))

    def __del__(self):
        if self._h and _loaded is not None:
            _loaded.a8t_lm_free(self._h)
            self._h = None


class NativeArpaLM(NativeLM):
    """ARPA text LM (``csrc/arpa_lm.cc``). The C++ reader takes plain
    text; a gzipped file (``.gz``) is decompressed into an anonymous
    in-memory file that it reads by its ``/proc/self/fd`` path."""

    def __init__(self, path: str):
        if path.endswith(".gz"):
            fd = os.memfd_create("arpa")
            try:
                with gzip.open(path, "rb") as src, \
                        os.fdopen(fd, "wb", closefd=False) as dst:
                    shutil.copyfileobj(src, dst)
                self._h = lib().a8t_lm_load(f"/proc/self/fd/{fd}".encode())
            finally:
                os.close(fd)
        else:
            self._h = lib().a8t_lm_load(path.encode())
        if not self._h:
            raise IOError(f"failed to load ARPA LM {path!r}")


class NativeKenLM(NativeLM):
    """mmap'd KenLM binary LM: PROBING, TRIE and QUANT_TRIE
    (``csrc/kenlm_bin.cc``). Raises ``IOError`` for a file its structural
    checks reject (REST_PROBING, array-trie binaries, truncated files)."""

    def __init__(self, path: str):
        self._h = lib().a8t_lm_load_kenlm(path.encode())
        if not self._h:
            raise IOError(
                f"failed to load KenLM binary {path!r}: PROBING, TRIE and "
                "QUANT_TRIE binaries are read; convert others to ARPA")


def _pack_vocab(vocab: Sequence[str]):
    offsets = np.zeros(len(vocab) + 1, np.int64)
    blobs = []
    for i, piece in enumerate(vocab):
        b = piece.encode()
        blobs.append(b)
        offsets[i + 1] = offsets[i] + len(b)
    return b"".join(blobs), offsets


def prefix_beam_search_lm(log_probs: np.ndarray, blank: int, beam: int,
                          space_idx: int, alpha: float, beta: float,
                          vocab: Sequence[str], lm: Optional[NativeLM],
                          n_best: int = 0) -> List[List[int]]:
    """LM-fused decode of one utterance (T, V) -> n-best id sequences."""
    lp = np.ascontiguousarray(log_probs, np.float32)
    t, v = lp.shape
    n_best = n_best if n_best > 0 else beam
    buf, offsets = _pack_vocab(vocab)
    out_ids = np.zeros((n_best, t), np.int64)
    out_lens = np.zeros((n_best,), np.int64)
    n = lib().a8t_prefix_beam_search_lm(
        _ptr(lp, ctypes.c_float), t, v, blank, beam, space_idx, alpha, beta,
        n_best, buf, _ptr(offsets, ctypes.c_int64),
        lm._h if lm is not None else None, _ptr(out_ids, ctypes.c_int64),
        _ptr(out_lens, ctypes.c_int64), t)
    return [out_ids[i, :out_lens[i]].tolist() for i in range(int(n))]


def flac_read(path: str) -> Tuple[np.ndarray, int, int]:
    """Decode a FLAC file -> (int32 array [T] or [T, C], sample_rate,
    bits_per_sample)."""
    sr, ch, bps = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    total = ctypes.c_int64()
    args = (path.encode(), ctypes.byref(sr), ctypes.byref(ch),
            ctypes.byref(bps), ctypes.byref(total))
    rc = lib().a8t_flac_read(*args, None, 0)
    if rc != 0:
        raise IOError(f"FLAC header read failed for {path!r} (rc={rc})")
    n = int(total.value) or 1 << 26  # unknown length: a generous cap
    data = np.zeros((n * ch.value,), np.int32)
    got = lib().a8t_flac_read(*args, _ptr(data, ctypes.c_int32), n)
    if got < 0:
        raise IOError(f"FLAC decode failed for {path!r} (rc={got})")
    data = data[:int(got) * ch.value]
    if ch.value > 1:
        data = data.reshape(-1, ch.value)
    return data, int(sr.value), int(bps.value)


def _bytes_ptr(data) -> Tuple[np.ndarray, int]:
    """A bytes-like object as a uint8 array (no copy) and its address."""
    a = np.frombuffer(data, np.uint8)
    return a, a.ctypes.data


def zstd_decompress(data) -> bytes:
    """Decode every zstd frame of ``data`` (RFC 8878); raises
    ``ValueError`` naming the fault on a corrupt frame, a frame that needs
    a dictionary, or a content size or checksum that does not match."""
    a, ptr = _bytes_ptr(data)
    n = ctypes.c_int64()
    err = ctypes.create_string_buffer(256)
    out = lib().a8t_zstd_decompress(ptr, a.size, ctypes.byref(n), err, 256)
    if not out:
        raise ValueError(err.value.decode(errors="replace"))
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib().a8t_free(out)


def crc32c(data, crc: int = 0) -> int:
    """CRC32C (Castagnoli) of ``data``, continuing from ``crc``."""
    a, ptr = _bytes_ptr(data)
    return int(lib().a8t_crc32c(ptr, a.size, crc))


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of ``data`` (zstd's content checksum is its low 32 bits)."""
    a, ptr = _bytes_ptr(data)
    return int(lib().a8t_xxh64(ptr, a.size, seed))
