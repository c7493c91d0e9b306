"""Build the port's CUDA kernels with ``nvcc`` and its host library with
``g++``.

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

The host library (:func:`build_host`) holds the C++ host code of the
decode and data layer: edit distance, the CTC prefix beam search with
and without LM fusion, the ARPA and KenLM-binary LM readers and the FLAC
decoder (``HOST_SOURCES``). ``g++`` links them into one
``libaudio8_host-<hash>.so`` beside the kernels, under the same content
hash; ``csrc/native.py`` loads it with ``ctypes``.

    python -m audio8_tpu_torch.csrc.build      # build every kernel, print
                                               # registers and spills
    python -m audio8_tpu_torch.csrc.build --host   # the host library only
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Dict, Sequence

CSRC = os.path.dirname(os.path.abspath(__file__))
SOURCES = tuple(sorted(f for f in os.listdir(CSRC) if f.endswith(".cu")))
HOST_SOURCES = ("editdistance.cc", "beam.cc", "flac.cc", "arpa_lm.cc",
                "kenlm_bin.cc")
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
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


def _content_hash(sources: Sequence[str], flags: Sequence[str]) -> str:
    digest = hashlib.sha256()
    for source in sources:
        for name in local_includes(source):
            with open(os.path.join(CSRC, name), "rb") as f:
                digest.update(f.read())
    digest.update(" ".join(flags).encode())
    return digest.hexdigest()[:16]


def library_path(source: str) -> str:
    stem = os.path.splitext(source)[0]
    return os.path.join(build_dir(),
                        f"{stem}-{_content_hash((source,), NVCC_FLAGS)}.so")


def host_library_path() -> str:
    return os.path.join(build_dir(), "libaudio8_host-"
                        f"{_content_hash(HOST_SOURCES, HOST_FLAGS)}.so")


def build_host() -> str:
    """Compile the host library with ``g++`` unless it is built already;
    returns its path. Processes that start together build it once (a
    file lock), and a reader never sees half a file. Raises
    ``RuntimeError`` with the compiler's output if ``g++`` is missing or
    fails: nothing falls back to Python."""
    out = host_library_path()
    if os.path.exists(out):
        return out
    os.makedirs(build_dir(), exist_ok=True)
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):
            return out
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found on PATH: the host library of "
                               "audio8_tpu_torch cannot be built")
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [gxx, *HOST_FLAGS, *(os.path.join(CSRC, s) for s in HOST_SOURCES),
             "-o", tmp], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if proc.returncode != 0:
            raise RuntimeError("g++ failed for the host library:\n"
                               + proc.stdout.decode(errors="replace"))
        os.replace(tmp, out)
    return out


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
    import sys

    t0 = time.perf_counter()
    print(f"host library -> {build_host()}")
    if "--host" in sys.argv[1:]:
        raise SystemExit(0)
    libs = build()
    for src, lib in libs.items():
        print(f"{src} -> {lib}")
        for kernel, r in ptxas_report(lib).items():
            print(f"  {kernel}: {r['registers']} registers, spills "
                  f"{r['spill_stores']} B stored / {r['spill_loads']} B "
                  "loaded")
    print(f"build seconds: {time.perf_counter() - t0:.3f}")
