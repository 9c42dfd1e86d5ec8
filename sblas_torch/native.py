"""The port's host library: its serial host passes in C++, through ctypes.

The port's own copies of the JAX package's native helpers, one file a
pass under ``sblas_torch/hostsrc/``: the incomplete factorizations
(``factor.cpp``: IC(0), ILU(0) in f64), the solves' dependency levels
(``levels.cpp``: one O(nnz) sweep) and the MatrixMarket coordinate parse
(``mtx.cpp``), and, of the port's own, the CSR transpose
(``transpose.cpp``: a counting sort by column). Every ``hostsrc/*.cpp``
compiles at first use into one library,

    g++ -O3 -march=native -shared -fPIC
        -o build/sblas_torch/libsblas_torch_host_<h>.so hostsrc/*.cpp

(``-march=native`` as the JAX package builds its own copy, so that both
round alike), where ``<h>`` hashes the sources, the flags and
:func:`host_tag`, what ``-march=native`` resolves to on this host (``g++
-march=native -Q --help=target``): a library built from other sources,
or for another CPU or compiler, is never loaded, so a ``build/`` copied
from one machine to another rebuilds. A missing ``g++`` or a failed
build raises ``RuntimeError`` with the compiler's output; there is no numpy
fallback on this path (the numpy versions in :mod:`sblas_torch.solvers`,
:func:`sblas_torch.levels.level_schedule_plain`,
:func:`sblas_torch.io.parse_coordinate_plain` and
:func:`sblas_torch.formats.csr_transpose_plain` are the plain versions the
tests hold the library to).
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

HOSTSRC = Path(__file__).resolve().parent / "hostsrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "sblas_torch"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_LIB: ctypes.CDLL | None = None


def _cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the host library of "
                           "sblas_torch (factorizations, levels, .mtx "
                           "parse, transpose) cannot be built")
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


def sources() -> list[Path]:
    """The host library's sources: every ``hostsrc/*.cpp``."""
    return sorted(HOSTSRC.glob("*.cpp"))


def library_path(srcs=None, out_dir: Path = BUILD_DIR) -> Path:
    """Where the library built from ``srcs`` (default :func:`sources`)
    lives: keyed on a hash of each source's name and text, the flags and
    :func:`host_tag`."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in sources() if srcs is None else srcs:
        h.update(Path(src).name.encode() + b"\0")
        h.update(Path(src).read_bytes())
    h.update(host_tag().encode())
    return out_dir / f"libsblas_torch_host_{h.hexdigest()[:16]}.so"


def build(srcs=None, out_dir: Path = BUILD_DIR) -> Path:
    """Compile ``srcs`` (default :func:`sources`) into one library unless
    it exists; return its path."""
    srcs = sources() if srcs is None else [Path(s) for s in srcs]
    lib = library_path(srcs, out_dir)
    if lib.exists():
        return lib
    cxx = _cxx()
    out_dir.mkdir(parents=True, exist_ok=True)
    # built under a temporary name and then renamed: a concurrent loader
    # never sees a half-written library
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        so = Path(tmp) / lib.name
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(so),
                               *map(str, srcs)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            names = ", ".join(src.name for src in srcs)
            raise RuntimeError(f"g++ failed (exit {proc.returncode}) "
                               f"compiling {names}:\n{proc.stderr}"
                               f"{proc.stdout}")
        os.replace(so, lib)
    return lib


def load() -> ctypes.CDLL:
    """The host library, built on first call and then kept."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        for fn in (lib.sblas_ic0_f64, lib.sblas_ilu0_f64):
            fn.restype = ctypes.c_int64
            fn.argtypes = [i32p, i32p, f64p, ctypes.c_int64]
        for fn in (lib.sblas_torch_levels_lower,
                   lib.sblas_torch_levels_upper):
            fn.restype = ctypes.c_int32
            fn.argtypes = [i32p, i32p, ctypes.c_int64, i32p]
        fn = lib.sblas_torch_parse_mtx_body
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int32, i64p, i64p, f64p]
        fn = lib.sblas_torch_csr_transpose
        fn.restype = ctypes.c_int32
        fn.argtypes = [i32p, i32p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int64, i32p, i32p,
                       ctypes.c_void_p]
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


def level_sweep(indptr, indices, n: int, *,
                lower: bool = True) -> tuple[np.ndarray, int]:
    """``(levels[n] int32, nlevels)`` of the ``n x n`` triangular CSR
    pattern: one serial sweep over the rows in dependency order (forward
    for ``lower``, backward else), O(n + nnz)."""
    indptr = np.ascontiguousarray(indptr, dtype=np.int32)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    if len(indptr) != n + 1:
        raise ValueError(f"indptr has {len(indptr)} entries for n = {n}")
    # the sweep reads indices[indptr[i]:indptr[i + 1]] unchecked
    if indptr[0] != 0 or indptr[-1] > len(indices) or \
            (np.diff(indptr) < 0).any():
        raise ValueError("indptr must rise from 0 to at most "
                         f"len(indices) = {len(indices)}")
    lib = load()
    fn = lib.sblas_torch_levels_lower if lower else \
        lib.sblas_torch_levels_upper
    levels = np.zeros(n, dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    nlevels = fn(indptr.ctypes.data_as(i32p), indices.ctypes.data_as(i32p),
                 n, levels.ctypes.data_as(i32p))
    if nlevels < 0:
        raise ValueError(f"a column index outside [0, {n}) on the strict "
                         "side of the diagonal")
    return levels, int(nlevels)


def csr_transpose(indptr, indices, data: np.ndarray, shape):
    """``(indptr, indices, data)`` of the CSR of the transpose of the
    ``shape = (m, n)`` CSR given, by a counting sort on the columns: each
    column's entries in row order, values copied bit for bit. ``indptr``
    must run from 0 to ``len(indices)``; a column outside ``[0, n)``
    raises ``ValueError``."""
    m, n = (int(s) for s in shape)
    indptr = np.ascontiguousarray(indptr, dtype=np.int32)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    data = np.ascontiguousarray(data)
    if len(indptr) != m + 1:
        raise ValueError(f"indptr has {len(indptr)} entries for m = {m}")
    if len(indices) != len(data):
        raise ValueError("indices and values differ in length")
    # the passes read indices[indptr[i]:indptr[i + 1]] unchecked
    if indptr[0] != 0 or indptr[-1] != len(indices) or \
            (np.diff(indptr) < 0).any():
        raise ValueError("indptr must rise from 0 to len(indices) = "
                         f"{len(indices)}")
    t_indptr = np.empty(n + 1, dtype=np.int32)
    t_indices = np.empty(len(indices), dtype=np.int32)
    t_data = np.empty_like(data)
    i32p = ctypes.POINTER(ctypes.c_int32)
    got = load().sblas_torch_csr_transpose(
        indptr.ctypes.data_as(i32p), indices.ctypes.data_as(i32p),
        data.ctypes.data, m, n, data.itemsize, t_indptr.ctypes.data_as(i32p),
        t_indices.ctypes.data_as(i32p), t_data.ctypes.data)
    if got == -2:
        raise ValueError(f"no transpose for {data.itemsize}-byte values")
    if got != 0:
        raise ValueError(f"a column index outside [0, {n})")
    return t_indptr, t_indices, t_data


def parse_mtx_body(body: bytes, nnz: int, has_value: bool):
    """``(rows int64, cols int64, vals f64)`` of the first ``nnz`` entries
    of a MatrixMarket coordinate body, 0-based (values 1.0 without
    ``has_value``). A body with fewer entries, or a token that is not a
    number, raises ``ValueError``."""
    if not isinstance(body, bytes):
        raise TypeError("the body must be bytes (NUL-terminated)")
    rows = np.empty(nnz, dtype=np.int64)
    cols = np.empty(nnz, dtype=np.int64)
    vals = np.empty(nnz, dtype=np.float64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    got = load().sblas_torch_parse_mtx_body(
        body, len(body), nnz, int(has_value), rows.ctypes.data_as(i64p),
        cols.ctypes.data_as(i64p),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if got != nnz:
        raise ValueError(f"malformed .mtx body: parsed {got} of {nnz} "
                         "entries")
    return rows, cols, vals
