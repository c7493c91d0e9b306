"""Build the port's CUDA kernels into shared libraries with ``nvcc``.

Each ``*.cu`` source in this directory has a plain C interface and is
compiled on its own (all sources in parallel) into
``<repo>/build/audio8_tpu_torch/<stem>-<hash>.so``, where the hash covers
the source text, the text of the files of this directory it includes, and
the compiler flags: an unchanged source is not rebuilt,
and an edited one never loads a stale library. The libraries are loaded
with ``ctypes`` by ``audio8_tpu_torch.ops._ext``; nothing here includes
PyTorch's headers, so a cold build takes seconds. ``ptxas -v`` reports
each kernel's registers and spills; the report is kept beside the library
(``<stem>-<hash>.log``) and read back by :func:`ptxas_report`.

    python -m audio8_tpu_torch.csrc.build      # build every kernel, print
                                               # registers and spills
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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
        with open(log_path(out[s]), "wb") as f:
            f.write(log)
        os.replace(tmp, out[s])  # atomic: a reader never sees half a file
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return out


def log_path(library: str) -> str:
    return os.path.splitext(library)[0] + ".log"


def kernel_name(mangled: str) -> str:
    """``name<args>`` of a mangled ``__global__`` function whose name ends
    in ``kernel`` (type arguments stay mangled), else ``mangled``."""
    for i in range(len(mangled)):
        j = i
        while j < len(mangled) and mangled[j].isdigit():
            j += 1
        if j == i or mangled[i] == "0":
            continue
        ident = mangled[j:j + int(mangled[i:j])]
        if ident.endswith("kernel") and ident.isidentifier():
            rest = mangled[j + len(ident):]
            args = re.match(r"I((?:L[a-z]-?\d+E)+)E", rest)
            if args:  # integer template arguments
                return ident + "<" + ", ".join(
                    re.findall(r"L[a-z](-?\d+)E", args.group(1))) + ">"
            args = re.match(r"I(.+?)E+v", rest)  # others, still mangled
            return ident + (f"<{args.group(1)}>" if args else "")
    return mangled


def ptxas_report(library: str) -> Dict[str, dict]:
    """``{kernel: {"registers", "spill_stores", "spill_loads"}}`` (bytes
    for the spills) from the ``ptxas -v`` log kept beside ``library``."""
    out, entry, props = {}, None, None
    if not os.path.exists(log_path(library)):
        return out
    with open(log_path(library), errors="replace") as f:
        for line in f:
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                entry = kernel_name(m.group(1))
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                props = kernel_name(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and props is not None:
                out.setdefault(props, {}).update(
                    spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and entry is not None:
                out.setdefault(entry, {})["registers"] = int(m.group(1))
    return {k: r for k, r in out.items() if "registers" in r}


if __name__ == "__main__":
    t0 = time.perf_counter()
    libs = build()
    for src, lib in libs.items():
        print(f"{src} -> {lib}")
        for kernel, r in ptxas_report(lib).items():
            print(f"  {kernel}: {r['registers']} registers, spills "
                  f"{r['spill_stores']} B stored / {r['spill_loads']} B "
                  "loaded")
    print(f"build seconds: {time.perf_counter() - t0:.3f}")
