"""Matrix Market (.mtx) reader and writer of the port.

``coordinate`` and dense ``array`` formats; real, integer, pattern and
complex fields; general, symmetric, skew-symmetric and hermitian symmetry;
1-based indices; ``%`` comments; ``.gz`` files. The file is read in
binary: the header lines are decoded, the body stays bytes. A coordinate
body of a ``real``, ``integer`` or ``pattern`` field goes to the port's
host library (:func:`sblas_torch.native.parse_mtx_body`, ``hostsrc/mtx.cpp``,
the copy of the JAX package's native parse): without ``g++`` it raises.
``complex`` bodies and ``array`` files take the numpy parse;
:func:`parse_coordinate_plain` is the plain version the tests hold the
host parse to.
"""

from __future__ import annotations

import gzip
from pathlib import Path
from typing import Union

import numpy as np

from . import native
from .formats import COO, CSR, coo_to_csr

_FIELDS = {"real", "integer", "pattern", "double", "complex"}
_SYMMETRIES = {"general", "symmetric", "skew-symmetric", "hermitian"}


def _open(path: Union[str, Path]):
    path = Path(path)
    if path.suffix == ".gz":
        return gzip.open(path, "rb")
    return open(path, "rb")


def _line(f) -> str:
    return f.readline().decode("utf-8", "replace")


def _resolve_dtype(field: str, dtype):
    """Complex fields force a complex dtype; real fields keep the request."""
    if field == "complex":
        if not np.issubdtype(np.dtype(dtype), np.complexfloating):
            return np.complex128
    return dtype


def _read_header(f, path):
    header = _line(f).strip().lower().split()
    if len(header) < 5 or header[0] != "%%matrixmarket" or header[1] != "matrix":
        raise ValueError(f"not a MatrixMarket matrix file: {path}")
    fmt, field, symmetry = header[2], header[3], header[4]
    if fmt not in ("coordinate", "array"):
        raise ValueError(f"unsupported format {fmt!r}")
    if field not in _FIELDS:
        raise ValueError(f"unsupported field {field!r}")
    if symmetry not in _SYMMETRIES:
        raise ValueError(f"unsupported symmetry {symmetry!r}")
    if fmt == "array" and field == "pattern":
        raise ValueError("pattern field is invalid for array format")
    line = _line(f)
    while line.startswith("%") or not line.strip():
        line = _line(f)
    sizes = [int(t) for t in line.split()]
    return fmt, field, symmetry, sizes


def parse_coordinate(body: bytes, nnz, field, dtype):
    """Parse a coordinate body -> (row, col, data), 0-based: the host
    library's parse, or for a ``complex`` field the numpy one."""
    if field == "complex":
        return parse_coordinate_plain(body, nnz, field, dtype)
    pattern = field == "pattern"
    row, col, vals = native.parse_mtx_body(body, nnz, not pattern)
    data = np.ones(nnz, dtype=dtype) if pattern else \
        vals.astype(dtype, copy=False)
    return row, col, data


def parse_coordinate_plain(body, nnz, field, dtype):
    """:func:`parse_coordinate` in numpy (``body`` bytes or str)."""
    ncols = {"pattern": 2, "complex": 4}.get(field, 3)
    toks = np.array(body.split(), dtype=np.float64)
    if len(toks) < nnz * ncols:
        raise ValueError(f"truncated .mtx body: expected {nnz * ncols} "
                         f"tokens, got {len(toks)}")
    toks = toks[: nnz * ncols].reshape(nnz, ncols)
    row = toks[:, 0].astype(np.int64) - 1
    col = toks[:, 1].astype(np.int64) - 1
    if field == "pattern":
        data = np.ones(nnz, dtype=dtype)
    elif field == "complex":
        data = (toks[:, 2] + 1j * toks[:, 3]).astype(dtype)
    else:
        data = toks[:, 2].astype(dtype)
    return row, col, data


def _parse_array(body, m, n, field, symmetry, dtype):
    """Parse a dense ``array`` body (column-major) -> ndarray (m, n).

    Non-general symmetries store only the on/below-diagonal part of each
    column (skew-symmetric omits the diagonal), as ``scipy.io.mmread``
    reads them.
    """
    toks = np.array(body.split(), dtype=np.float64)
    if field == "complex":
        if len(toks) % 2:
            raise ValueError("odd token count in complex array body")
        vals = toks[0::2] + 1j * toks[1::2]
    else:
        vals = toks
    vals = vals.astype(dtype)

    dense = np.zeros((m, n), dtype=dtype)
    if symmetry == "general":
        if len(vals) < m * n:
            raise ValueError(f"truncated array body: expected {m * n} "
                             f"values, got {len(vals)}")
        return np.ascontiguousarray(vals[: m * n].reshape(n, m).T)

    if m != n:
        raise ValueError(f"{symmetry} array matrix must be square, got {m}x{n}")
    start = 1 if symmetry == "skew-symmetric" else 0
    counts = np.maximum(m - np.arange(n) - start, 0)
    total = int(counts.sum())
    if len(vals) < total:
        raise ValueError(f"truncated array body: expected {total} values, "
                         f"got {len(vals)}")
    cols = np.repeat(np.arange(n), counts)
    rows = np.concatenate([np.arange(j + start, m) for j in range(n)]) \
        if n else np.empty(0, dtype=np.int64)
    dense[rows, cols] = vals[:total]
    mirror = {"symmetric": lambda v: v,
              "skew-symmetric": lambda v: -v,
              "hermitian": np.conj}[symmetry]
    off = rows != cols
    dense[cols[off], rows[off]] = mirror(dense[rows[off], cols[off]])
    return dense


def read_mtx_dense(path: Union[str, Path], dtype=np.float64) -> np.ndarray:
    """Any .mtx file as a dense ndarray, symmetry expanded (small matrices
    only)."""
    return read_mtx_coo(path, dtype=dtype).todense()


def read_mtx_coo(path: Union[str, Path], dtype=np.float64) -> COO:
    """Parse a Matrix Market file into COO, symmetry expanded. ``array``
    files are sparsified (explicit zeros dropped)."""
    with _open(path) as f:
        fmt, field, symmetry, sizes = _read_header(f, path)
        body = f.read()
    dtype = _resolve_dtype(field, dtype)

    if fmt == "array":
        m, n = sizes[0], sizes[1]
        dense = _parse_array(body.decode(), m, n, field, symmetry, dtype)
        row, col = np.nonzero(dense)
        return COO((m, n), row.astype(np.int64), col.astype(np.int64),
                   dense[row, col])

    m, n, nnz = sizes[0], sizes[1], sizes[2]
    row, col, data = parse_coordinate(body, nnz, field, dtype)
    del body
    # out-of-range indices fail loudly instead of wrapping in a gather
    if nnz and (row.min(initial=0) < 0 or col.min(initial=0) < 0
                or row.max(initial=-1) >= m or col.max(initial=-1) >= n):
        raise ValueError(
            f"index out of range in {path}: rows in "
            f"[{row.min() + 1}, {row.max() + 1}], cols in "
            f"[{col.min() + 1}, {col.max() + 1}] (1-based) vs shape {m}x{n}")

    if symmetry in ("symmetric", "skew-symmetric", "hermitian"):
        off = row != col
        if symmetry == "skew-symmetric":
            mirrored = -data[off]
        elif symmetry == "hermitian":
            mirrored = np.conj(data[off])
        else:
            mirrored = data[off]
        row, col = (np.concatenate([row, col[off]]),
                    np.concatenate([col, row[off]]))
        data = np.concatenate([data, mirrored])

    return COO((m, n), row, col, data)


def read_mtx(path: Union[str, Path], dtype=np.float64) -> CSR:
    """Parse a .mtx file straight to canonical CSR (sorted, deduplicated)."""
    return coo_to_csr(read_mtx_coo(path, dtype=dtype))


def write_mtx(path: Union[str, Path], a, *, symmetry: str = "general") -> None:
    """Write a COO or CSR as a MatrixMarket coordinate file (1-based): the
    ``real`` field for real values, ``complex`` (``i j re im``) else."""
    coo = a.tocoo() if isinstance(a, CSR) else a
    if symmetry != "general":
        raise ValueError("only general symmetry supported for writing")
    is_complex = np.issubdtype(coo.data.dtype, np.complexfloating)
    field = "complex" if is_complex else "real"
    with open(Path(path), "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} general\n")
        f.write(f"{coo.shape[0]} {coo.shape[1]} {coo.nnz}\n")
        idx = [coo.row.astype(np.int64) + 1, coo.col.astype(np.int64) + 1]
        if is_complex:
            np.savetxt(f, np.column_stack(idx + [coo.data.real,
                                                 coo.data.imag]),
                       fmt="%d %d %.17g %.17g")
        else:
            np.savetxt(f, np.column_stack(idx + [coo.data]), fmt="%d %d %.17g")
