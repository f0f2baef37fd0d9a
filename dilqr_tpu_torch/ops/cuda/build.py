"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
build happens at first use, from the package's own sources only, into
``dilqr_tpu_torch/_build/`` (listed in ``.gitignore``), under a name that
carries the hash of the sources and flags: a changed source is rebuilt, an
unchanged one is loaded from the earlier build.

A source may be built more than once with preprocessor defines (a
``Spec``: the source and its ``(name, value)`` pairs), one library each:
``ilqr_lindx.cu`` is built per LinDx shape and cost form
(``ilqr_fused.lindx_spec``), ``ilqr_jvp.cu`` per device env and
linearization method (``ilqr_fused.jvp_spec``), ``ilqr_mlp.cu`` per MLP
shape (``ilqr_fused.mlp_spec``, whose hidden widths are one define, the
widths joined by "x": nvcc splits a value at its commas). The defines are part of the library's name and
hash, so each is built once and cached.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Sequence, Tuple, Union

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# a source, or a source with its preprocessor defines (a number, or a
# token such as 6x6)
Spec = Union[str, Tuple[str, Tuple[Tuple[str, Union[int, str]], ...]]]

_LOADED: Dict[Spec, ctypes.CDLL] = {}


def _split(spec: Spec):
    return (spec, ()) if isinstance(spec, str) else spec


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built on a machine with the "
            "CUDA toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _define_flags(defines) -> list:
    return [f"-D{name}={value}" for name, value in defines]


def _digest(source: str, defines=()) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(_define_flags(defines))).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(name.encode() + f.read())
    h.update(source.encode())
    return h.hexdigest()[:16]


def library_path(spec: Spec) -> str:
    source, defines = _split(spec)
    stem = os.path.splitext(source)[0]
    tag = "".join(f"_{name.split('_')[-1].lower()}{value}" for name, value in defines)
    return os.path.join(BUILD_DIR, f"lib{stem}{tag}_{_digest(source, defines)}.so")


def start_build(spec: Spec):
    """Start nvcc on ``csrc/<source>`` (with its defines) unless its library
    is built already. Returns (library path, Popen or None, temp path)."""
    source, defines = _split(spec)
    out = library_path(spec)
    if os.path.exists(out):
        return out, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    log = open(tmp + ".log", "w")
    proc = subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, *_define_flags(defines), "-I", CSRC, "-o", tmp,
         os.path.join(CSRC, source)],
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


def build_all(specs: Sequence[Spec]) -> Dict[Spec, str]:
    """Build the given sources (or sources with defines) in parallel, one
    nvcc each, all started together. Returns {spec: nvcc report}."""
    started = {s: start_build(s) for s in specs}
    return {s: finish_build(*started[s]) for s in specs}


def load(spec: Spec) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>`` (with its defines), built
    first if needed."""
    lib = _LOADED.get(spec)
    if lib is None:
        out = library_path(spec)
        if not os.path.exists(out):
            build_all([spec])
        lib = ctypes.CDLL(out)
        _LOADED[spec] = lib
    return lib
