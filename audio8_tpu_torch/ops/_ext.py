"""ctypes bindings of the CUDA kernels in ``audio8_tpu_torch/csrc``.

The libraries are built on first use (``csrc/build.py``) and loaded once
per process. Every launch function takes raw device pointers and the
CUDA stream as ``c_void_p`` and returns the launch's ``cudaError_t``;
:func:`check` turns a non-zero code into an exception. Nothing here runs
at import time: the CPU-only test machine imports this module but never
builds or loads a kernel.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict

import torch

from audio8_tpu_torch.csrc import build as _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint32

# source -> (C function, argtypes)
_SIGNATURES = {
    "conv_k3s2_fwd.cu": ("a8t_conv_k3s2_fwd",
                         [_P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "attention_fwd.cu": ("a8t_attention_fwd",
                         [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F,
                          _U, _U, _I, _P]),
}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_functions: Dict[str, ctypes._CFuncPtr] = {}


def build_all() -> Dict[str, str]:
    """Build (or find) every kernel library and load it."""
    libs = _build.build(tuple(_SIGNATURES))
    for source in _SIGNATURES:
        function(source)
    return libs


def function(source: str):
    """The launch function of ``source``, built and loaded on first use."""
    with _lock:
        fn = _functions.get(source)
        if fn is None:
            path = _build.build((source,))[source]
            name, argtypes = _SIGNATURES[source]
            fn = getattr(ctypes.CDLL(path), name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _functions[source] = fn
        return fn


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{code}")


def stream_handle(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device`` as a raw handle."""
    return torch.cuda.current_stream(device).cuda_stream
