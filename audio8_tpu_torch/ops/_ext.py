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
_L = ctypes.c_longlong

# source -> {entry: (C function, argtypes)}; each entry is one launch
# function of the source's library
_SIGNATURES = {
    "conv_k3s2_fwd.cu": {"main": ("a8t_conv_k3s2_fwd",
                                  [_P, _P, _P, _I, _I, _I, _I, _I, _P]),
                         "route": ("a8t_conv_k3s2_fwd_route", [_I] * 4)},
    "conv_k3s2_bwd.cu": {"dgrad": ("a8t_conv_k3s2_dgrad",
                                   [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
                         "dgrad_route": ("a8t_conv_k3s2_dgrad_route",
                                         [_I] * 3),
                         "wgrad": ("a8t_conv_k3s2_wgrad",
                                   [_P, _P, _P, _P, _I, _I, _I, _I, _I, _L,
                                    _I, _P]),
                         "wgrad_route": ("a8t_conv_k3s2_wgrad_route",
                                         [_I] * 3)},
    "dropout.cu": {"main": ("a8t_dropout",
                            [_P, _P, _L, _U, _U, _F, _I, _P])},
    "attention_fwd.cu": {"main": ("a8t_attention_fwd",
                                  [_P] * 7 + [_I] * 5
                                  + [_F, _F, _U, _U, _I, _I, _I, _P]),
                         "route": ("a8t_attention_fwd_route", [_I] * 3)},
    "attention_bwd.cu": {"main": ("a8t_attention_bwd",
                                  [_P] * 15 + [_I] * 5
                                  + [_F, _F, _U, _U, _I, _I, _I, _P])},
    "attention_block_fwd.cu": {"main": ("a8t_attention_block_fwd",
                                        [_P] * 17 + [_I] * 6
                                        + [_F, _F, _U, _U, _I, _I, _P]),
                               "route": ("a8t_attention_block_route",
                                         [_I] * 4)},
    "attention_block_bwd.cu": {"main": ("a8t_attention_block_bwd",
                                        [_P] * 26 + [_I] * 6
                                        + [_F, _F, _U, _U, _I, _I, _I, _I,
                                           _P])},
    "ctc_loss.cu": {"main": ("a8t_ctc_loss",
                             [_P] * 6 + [_I] * 5 + [_P]),
                    "bwd": ("a8t_ctc_loss_bwd", [_P] * 7 + [_I] * 5 + [_P])},
    "adamw.cu": {"main": ("a8t_adamw",
                          [_P, _I, _I, _F, _F, _F, _F, _F, _F, _F, _P,
                           _P])},
}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_functions: Dict[tuple, ctypes._CFuncPtr] = {}


def build_all() -> Dict[str, str]:
    """Build (or find) every kernel library and load it."""
    libs = _build.build(tuple(_SIGNATURES))
    for source, entries in _SIGNATURES.items():
        for entry in entries:
            function(source, entry)
    return libs


def function(source: str, entry: str = "main"):
    """The launch function ``entry`` of ``source``, built and loaded on
    first use."""
    with _lock:
        fn = _functions.get((source, entry))
        if fn is None:
            path = _build.build((source,))[source]
            name, argtypes = _SIGNATURES[source][entry]
            fn = getattr(ctypes.CDLL(path), name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _functions[(source, entry)] = fn
        return fn


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{code}")


def stream_handle(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device`` as a raw handle."""
    return torch.cuda.current_stream(device).cuda_stream
