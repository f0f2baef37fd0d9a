"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
build happens at first use, from the package's own sources only, into
``dilqr_tpu_torch/_build/`` (listed in ``.gitignore``), under a name that
carries the hash of the sources and flags: a changed source is rebuilt, an
unchanged one is loaded from the earlier build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built on a machine with the "
            "CUDA toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _digest(source: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(name.encode() + f.read())
    h.update(source.encode())
    return h.hexdigest()[:16]


def library_path(source: str) -> str:
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{_digest(source)}.so")


def start_build(source: str):
    """Start nvcc on ``csrc/<source>`` unless its library is built already.
    Returns (library path, Popen or None, temp path)."""
    out = library_path(source)
    if os.path.exists(out):
        return out, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    log = open(tmp + ".log", "w")
    proc = subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp, os.path.join(CSRC, source)],
        stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return out, proc, tmp


def finish_build(out: str, proc, tmp) -> str:
    """Wait for a build started by start_build; returns nvcc's output
    (the -Xptxas -v report) and leaves the library at ``out``."""
    if proc is None:
        report = out + ".log"
        return open(report).read() if os.path.exists(report) else ""
    rc = proc.wait()
    with open(tmp + ".log") as f:
        report = f.read()
    os.remove(tmp + ".log")
    if rc != 0:
        os.remove(tmp)
        raise RuntimeError(f"nvcc failed on {out} (exit {rc}):\n{report}")
    with open(out + ".log", "w") as f:
        f.write(report)
    os.replace(tmp, out)
    return report


def build_all(sources: Sequence[str]) -> Dict[str, str]:
    """Build the given sources in parallel (one nvcc each, all started
    together). Returns {source: nvcc report}."""
    started = {s: start_build(s) for s in sources}
    return {s: finish_build(*started[s]) for s in sources}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built first if needed."""
    lib = _LOADED.get(source)
    if lib is None:
        out = library_path(source)
        if not os.path.exists(out):
            build_all([source])
        lib = ctypes.CDLL(out)
        _LOADED[source] = lib
    return lib
