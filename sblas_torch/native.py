"""The port's host library: incomplete factorizations in C++, through ctypes.

``sblas_torch/hostsrc/factor.cpp`` compiles at first use with

    g++ -O3 -march=native -shared -fPIC
        -o build/sblas_torch/libsblas_torch_host_<h>.so factor.cpp

(``-march=native`` as the JAX package builds its own copy, so that both
round alike), where ``<h>`` hashes the source, the flags and
:func:`host_tag`, what ``-march=native`` resolves to on this host (``g++
-march=native -Q --help=target``): a library built from another source,
or for another CPU or compiler, is never loaded, so a ``build/`` copied
from one machine to another rebuilds. A missing ``g++`` or a failed
build raises ``RuntimeError`` with the compiler's output; there is no numpy
fallback on this path (the numpy versions in :mod:`sblas_torch.solvers` are
the plain versions the tests hold the library to).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "hostsrc" / "factor.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "sblas_torch"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_LIB: ctypes.CDLL | None = None


def _cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the host factorizations "
                           "of sblas_torch cannot be built")
    return cxx


@functools.lru_cache(maxsize=None)
def host_tag() -> str:
    """What ``-march=native`` means here: g++'s version and its resolved
    target options (``g++ -march=native -Q --help=target``), which name
    the host CPU's architecture and instruction sets."""
    cxx = _cxx()
    out = [subprocess.run([cxx, *args], capture_output=True, text=True,
                          timeout=60).stdout
           for args in (["-dumpfullversion"],
                        ["-march=native", "-Q", "--help=target"])]
    return "\n".join(out)


def library_path(src: Path = SRC, out_dir: Path = BUILD_DIR) -> Path:
    """Where the library built from ``src`` lives: keyed on a hash of the
    source, the flags and :func:`host_tag`."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(src.read_bytes())
    h.update(host_tag().encode())
    return out_dir / f"libsblas_torch_host_{h.hexdigest()[:16]}.so"


def build(src: Path = SRC, out_dir: Path = BUILD_DIR) -> Path:
    """Compile ``src`` unless the library for it exists; return its path."""
    lib = library_path(src, out_dir)
    if lib.exists():
        return lib
    cxx = _cxx()
    out_dir.mkdir(parents=True, exist_ok=True)
    # built under a temporary name and then renamed: a concurrent loader
    # never sees a half-written library
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        so = Path(tmp) / lib.name
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(so), str(src)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed (exit {proc.returncode}) "
                               f"compiling {src.name}:\n{proc.stderr}"
                               f"{proc.stdout}")
        os.replace(so, lib)
    return lib


def load() -> ctypes.CDLL:
    """The host library, built on first call and then kept."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        i32p = ctypes.POINTER(ctypes.c_int32)
        f64p = ctypes.POINTER(ctypes.c_double)
        for fn in (lib.sblas_ic0_f64, lib.sblas_ilu0_f64):
            fn.restype = ctypes.c_int64
            fn.argtypes = [i32p, i32p, f64p, ctypes.c_int64]
        _LIB = lib
    return _LIB


def _factor(fn, indptr, indices, data64: np.ndarray) -> int:
    if data64.dtype != np.float64 or not data64.flags.c_contiguous:
        raise ValueError("the factor values must be contiguous f64")
    indptr = np.ascontiguousarray(indptr, dtype=np.int32)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    if len(indices) != len(data64):
        raise ValueError("indices and values differ in length")
    i32p = ctypes.POINTER(ctypes.c_int32)
    return int(fn(indptr.ctypes.data_as(i32p), indices.ctypes.data_as(i32p),
                  data64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                  len(indptr) - 1))


def ic0_inplace(indptr, indices, data64: np.ndarray) -> int:
    """IC(0) over the CSR of tril(A) (sorted columns, the diagonal last in
    each row), in place in ``data64``. Returns 0, or i+1 on a non-positive
    pivot at row i."""
    return _factor(load().sblas_ic0_f64, indptr, indices, data64)


def ilu0_inplace(indptr, indices, data64: np.ndarray) -> int:
    """ILU(0) over a square CSR (sorted columns, full diagonal), in place in
    ``data64``: L unit-lower and U upper. Returns 0, or i+1 on a zero pivot
    or a missing diagonal at row i."""
    return _factor(load().sblas_ilu0_f64, indptr, indices, data64)
