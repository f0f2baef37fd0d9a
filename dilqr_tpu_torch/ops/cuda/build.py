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

A spec may also carry the text of a generated header (a third element):
``ilqr_user.cu`` for a user's model and any source built with a callable
cost (``ilqr_fused.user_spec``, ``ilqr_fused.with_cost``) include
``dilqr_traced.cuh``, the C++ that ``traced.py`` generated from the user's
PyTorch code. The text enters the library's hash, hence its name; it is
written into a directory of the library's own, put on nvcc's include path.

Several processes (the ranks of a multi-process job) may build the same
library at once: each compiles into a file of its own and moves it into
place with one rename, and so writes the header and the nvcc report, so
none reads another's half-written file.
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
# token such as 6x6), and optionally a generated header's text
Spec = Union[str, Tuple[str, Tuple[Tuple[str, Union[int, str]], ...]],
             Tuple[str, Tuple[Tuple[str, Union[int, str]], ...], str]]
# the name a generated header is included by
GENERATED_HEADER = "dilqr_traced.cuh"

_LOADED: Dict[Spec, ctypes.CDLL] = {}


def _split(spec: Spec):
    """(source, defines, generated header text or None)."""
    if isinstance(spec, str):
        return spec, (), None
    return (spec + (None,))[:3]


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built on a machine with the "
            "CUDA toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _define_flags(defines) -> list:
    return [f"-D{name}={value}" for name, value in defines]


def _digest(source: str, defines=(), header=None) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(_define_flags(defines))).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(name.encode() + f.read())
    h.update(source.encode())
    if header is not None:
        h.update(b"generated header\0" + header.encode())
    return h.hexdigest()[:16]


def library_path(spec: Spec) -> str:
    source, defines, header = _split(spec)
    stem = os.path.splitext(source)[0]
    tag = "".join(f"_{name.split('_')[-1].lower()}{value}" for name, value in defines)
    return os.path.join(BUILD_DIR, f"lib{stem}{tag}_{_digest(source, defines, header)}.so")


def _write_atomic(path: str, text: str):
    """Write ``text`` to ``path`` by a rename, so that a concurrent reader
    sees the old file or the whole new one."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".part")
    with os.fdopen(fd, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def start_build(spec: Spec):
    """Start nvcc on ``csrc/<source>`` (with its defines) unless its library
    is built already. Returns (library path, Popen or None, temp path)."""
    source, defines, header = _split(spec)
    out = library_path(spec)
    if os.path.exists(out):
        return out, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    include = ["-I", CSRC]
    if header is not None:
        gen = os.path.splitext(out)[0] + "_gen"
        os.makedirs(gen, exist_ok=True)
        _write_atomic(os.path.join(gen, GENERATED_HEADER), header)
        include += ["-I", gen]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    log = open(tmp + ".log", "w")
    proc = subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, *_define_flags(defines), *include, "-o", tmp,
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
    _write_atomic(out + ".log", report)
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
