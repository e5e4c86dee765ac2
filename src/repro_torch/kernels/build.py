"""Build the port's CUDA sources on first use and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled by ``nvcc`` for Hopper (``sm_90a``) into
``build/kernels/`` at the root of the checkout (git ignores it).  The
library's file name carries a hash of the source, of the headers it may
include and of the flags, so an edited source or header is rebuilt and a
stale library is never loaded.  Nothing here includes PyTorch's headers:
a build takes seconds.

The argument types of every entry point are declared here: pointers and
the stream are ``c_void_p`` (ctypes would otherwise pass a 32-bit int and
cut them), sizes are ``c_int``, scalars ``c_float``, and every entry point returns the
``cudaGetLastError()`` of its launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES: Dict[str, Dict[str, list]] = {
    "pi_search": {
        "pi_search_i32": [_P, _P, _I, _P, _I, _P, _I, _I, _P, _P],
        "pi_search_f32": [_P, _P, _I, _P, _I, _P, _I, _I, _P, _P],
        "pi_probe_i32": [_P, _P, _I, _P, _I, _P, _I, _P, _I, _I,
                         _P, _P, _P, _P],
        "pi_probe_f32": [_P, _P, _I, _P, _I, _P, _I, _P, _I, _I,
                         _P, _P, _P, _P],
    },
    "pi_range": {
        "pi_range_i32": [_P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _P,
                         _P, _P, _P, _I, _I, _I, _P, _P, _P],
    },
    "bitonic_sort": {
        "bitonic_sort": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _P],
        "bitonic_argsort": [_P, _P, _P, _I, _I, _I, _P, _I, _P],
        "launch_floor": [_P],
    },
    "flash_attention": {
        "flash_fwd_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _F, _F, _P],
        "flash_fwd_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          _F, _F, _P],
    },
}

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default install directory."""
    home = os.environ.get("CUDA_HOME")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + \
            [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives: the name carries a
    hash of the source, of every header in ``csrc/`` (which the source may
    include) and of the flags."""
    digest = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start one nvcc into a temporary file; (process, tmp, final, log)."""
    final = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    log = final.with_suffix(".log")
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, final, log


def build(names: Iterable[str] | None = None) -> List[Path]:
    """Compile every listed source that has no current library, all nvcc
    processes at once; returns the library paths.  Raises on a failed
    build with the compiler's output."""
    names = list(SIGNATURES if names is None else names)
    jobs = [_start(n) for n in names if not library_path(n).exists()]
    errors = []
    for proc, tmp, final, log in jobs:
        out, _ = proc.communicate()
        log.write_text(out)
        if proc.returncode == 0:
            os.replace(tmp, final)
        else:
            os.unlink(tmp)
            errors.append(f"{final.name}:\n{out}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return [library_path(n) for n in names]


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        path, = build([name])
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LOADED[name] = lib
    return lib


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, spills) of the
    current build of ``name``, or "" when it was not built here."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
