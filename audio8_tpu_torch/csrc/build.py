"""Build the port's CUDA kernels into shared libraries with ``nvcc``.

Each ``*.cu`` source in this directory has a plain C interface and is
compiled on its own (all sources in parallel) into
``<repo>/build/audio8_tpu_torch/<stem>-<hash>.so``, where the hash covers
the source text, the text of the files of this directory it includes, and
the compiler flags: an unchanged source is not rebuilt,
and an edited one never loads a stale library. The libraries are loaded
with ``ctypes`` by ``audio8_tpu_torch.ops._ext``; nothing here includes
PyTorch's headers, so a cold build takes seconds.

    python -m audio8_tpu_torch.csrc.build      # build (or find) every kernel
"""
from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Dict, Sequence

CSRC = os.path.dirname(os.path.abspath(__file__))
SOURCES = tuple(sorted(f for f in os.listdir(CSRC) if f.endswith(".cu")))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def build_dir() -> str:
    """``build/audio8_tpu_torch`` beside the package (ignored by git)."""
    root = os.path.dirname(os.path.dirname(CSRC))
    return os.path.join(root, "build", "audio8_tpu_torch")


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        if os.path.exists(cand):
            nvcc = cand
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin or "
                           "/usr/local/cuda/bin): the CUDA kernels of "
                           "audio8_tpu_torch cannot be built")
    return nvcc


def local_includes(source: str) -> list:
    """``source`` and every file of this directory it ``#include "..."``s,
    directly or not, in first-seen order."""
    seen, todo = [], [source]
    while todo:
        name = todo.pop(0)
        if name in seen:
            continue
        seen.append(name)
        with open(os.path.join(CSRC, name)) as f:
            todo += re.findall(r'^\s*#include\s+"([^"]+)"', f.read(), re.M)
    return seen


def library_path(source: str) -> str:
    digest = hashlib.sha256()
    for name in local_includes(source):
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(build_dir(), f"{stem}-{digest.hexdigest()[:16]}.so")


def build(sources: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library, all ``nvcc`` runs started together.

    Returns ``{source: library path}``; raises ``RuntimeError`` with the
    compiler's output if any build fails."""
    os.makedirs(build_dir(), exist_ok=True)
    out = {s: library_path(s) for s in sources}
    todo = [s for s in sources if not os.path.exists(out[s])]
    if not todo:
        return out
    nvcc = find_nvcc()
    procs = []
    for s in todo:
        tmp = f"{out[s]}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, s)]
        procs.append((s, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failures = []
    for s, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{s}:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out[s])  # atomic: a reader never sees half a file
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return out


if __name__ == "__main__":
    t0 = time.perf_counter()
    libs = build()
    for src, lib in libs.items():
        print(f"{src} -> {lib}")
    print(f"build seconds: {time.perf_counter() - t0:.3f}")
