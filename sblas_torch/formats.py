"""Host sparse matrices of the port, and their trip onto a torch device.

``COO``/``CSR``/``CSC`` are numpy holders with int32 indices
(``INDEX_DTYPE``) and float32/float64 (or complex) values, copied from the
JAX package's ``formats`` module and owned by the port: the port never
imports that package. :func:`from_reference` turns a matrix of the JAX
package (or anything with ``shape, indptr, indices, data``) into the port's
own, so that tests can hand both packages the same arrays.
:func:`to_device` uploads a CSR as the plain triple the port's kernels read.

The classes are ``eq=False`` dataclasses: the plan caches are weak-keyed on
matrix identity.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Tuple

import numpy as np
import torch

from . import native
from .trace import span

INDEX_DTYPE = np.int32
HOST_VALUE_DTYPES = (np.float32, np.float64, np.complex64, np.complex128)
VALUE_DTYPES = (torch.float32, torch.bfloat16, torch.float64)


def _check_values(data: np.ndarray) -> np.ndarray:
    data = np.asarray(data)
    if data.dtype not in tuple(np.dtype(d) for d in HOST_VALUE_DTYPES):
        # complex of odd precision widens to complex128, everything else
        # (ints, bools, f16) to float64; imaginary parts are never dropped
        if np.issubdtype(data.dtype, np.complexfloating):
            data = data.astype(np.complex128)
        else:
            data = data.astype(np.float64)
    return data


def _check_index(idx: np.ndarray) -> np.ndarray:
    idx = np.asarray(idx)
    if idx.size and idx.min(initial=0) < 0:
        # negative indices silently wrap in gathers and scatters
        raise ValueError("negative index")
    if idx.dtype != INDEX_DTYPE:
        if idx.size and (idx.max(initial=0) > np.iinfo(INDEX_DTYPE).max):
            raise ValueError("index exceeds int32 range")
        idx = idx.astype(INDEX_DTYPE)
    return idx


@dataclasses.dataclass(frozen=True, eq=False)
class COO:
    """Coordinate-format sparse matrix (row, col, data triplets)."""

    shape: Tuple[int, int]
    row: np.ndarray
    col: np.ndarray
    data: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "row", _check_index(self.row))
        object.__setattr__(self, "col", _check_index(self.col))
        object.__setattr__(self, "data", _check_values(self.data))
        if not (len(self.row) == len(self.col) == len(self.data)):
            raise ValueError("row/col/data length mismatch")

    @property
    def nnz(self) -> int:
        return len(self.data)

    @property
    def dtype(self):
        return self.data.dtype

    def todense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.data.dtype)
        np.add.at(out, (self.row, self.col), self.data)
        return out

    def tocsr(self) -> "CSR":
        return coo_to_csr(self)

    def tocsc(self) -> "CSC":
        return coo_to_csc(self)


@dataclasses.dataclass(frozen=True, eq=False)
class CSR:
    """Compressed sparse row. ``indptr`` has length ``shape[0]+1``; column
    indices within each row are sorted ascending and unique."""

    shape: Tuple[int, int]
    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray

    @span("sblas.CSR", "build")
    def __post_init__(self):
        object.__setattr__(self, "indptr", _check_index(self.indptr))
        object.__setattr__(self, "indices", _check_index(self.indices))
        object.__setattr__(self, "data", _check_values(self.data))
        if len(self.indptr) != self.shape[0] + 1:
            raise ValueError("indptr length must be nrows+1")
        if len(self.indices) != len(self.data):
            raise ValueError("indices/data length mismatch")

    @property
    def nnz(self) -> int:
        return len(self.data)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr)

    @span("sblas.CSR.row_ids", "convert")
    def row_ids(self) -> np.ndarray:
        """Per-nnz row index (the COO row array in CSR order)."""
        return np.repeat(np.arange(self.shape[0], dtype=INDEX_DTYPE),
                         self.row_lengths)

    @span("sblas.CSR.tocoo", "convert")
    def tocoo(self) -> COO:
        return COO(self.shape, self.row_ids(), self.indices.copy(),
                   self.data.copy())

    def tocsc(self) -> "CSC":
        t = csr_transpose(self)
        return CSC(self.shape, t.indptr, t.indices, t.data)

    def todense(self) -> np.ndarray:
        return self.tocoo().todense()

    def astype(self, dtype) -> "CSR":
        return CSR(self.shape, self.indptr, self.indices,
                   self.data.astype(dtype))

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix((self.data, self.indices, self.indptr),
                             shape=self.shape)

    @staticmethod
    def from_scipy(m) -> "CSR":
        m = m.tocsr()
        m.sort_indices()
        m.sum_duplicates()
        return CSR(m.shape, m.indptr, m.indices, m.data)


@dataclasses.dataclass(frozen=True, eq=False)
class CSC:
    """Compressed sparse column. ``indptr`` has length ``shape[1]+1``."""

    shape: Tuple[int, int]
    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "indptr", _check_index(self.indptr))
        object.__setattr__(self, "indices", _check_index(self.indices))
        object.__setattr__(self, "data", _check_values(self.data))
        if len(self.indptr) != self.shape[1] + 1:
            raise ValueError("indptr length must be ncols+1")

    @property
    def nnz(self) -> int:
        return len(self.data)

    @property
    def dtype(self):
        return self.data.dtype

    def tocsr(self) -> CSR:
        # the CSC of A is the CSR of A^T; its transpose is the CSR of A
        t = csr_transpose(CSR((self.shape[1], self.shape[0]), self.indptr,
                              self.indices, self.data))
        return CSR(self.shape, t.indptr, t.indices, t.data)

    def tocoo(self) -> COO:
        col = np.repeat(np.arange(self.shape[1], dtype=INDEX_DTYPE),
                        np.diff(self.indptr))
        return COO(self.shape, self.indices.copy(), col, self.data.copy())

    def todense(self) -> np.ndarray:
        return self.tocoo().todense()

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csc_matrix((self.data, self.indices, self.indptr),
                             shape=self.shape)


@span("sblas.coo_to_csr", "convert")
def coo_to_csr(a: COO, *, sum_duplicates: bool = True) -> CSR:
    """Sort triplets by (row, col), optionally merge duplicates, compress
    rows."""
    m, n = a.shape
    order = np.lexsort((a.col, a.row))
    row = a.row[order]
    col = a.col[order]
    data = a.data[order]
    if sum_duplicates and len(row):
        new = np.empty(len(row), dtype=bool)
        new[0] = True
        np.logical_or(row[1:] != row[:-1], col[1:] != col[:-1], out=new[1:])
        group = np.cumsum(new) - 1
        merged = np.zeros(int(group[-1]) + 1, dtype=data.dtype)
        np.add.at(merged, group, data)
        row, col, data = row[new], col[new], merged
    counts = np.bincount(row, minlength=m).astype(INDEX_DTYPE)
    indptr = np.zeros(m + 1, dtype=INDEX_DTYPE)
    np.cumsum(counts, out=indptr[1:])
    return CSR((m, n), indptr, col, data)


def coo_to_csc(a: COO) -> CSC:
    t = coo_to_csr(COO((a.shape[1], a.shape[0]), a.col, a.row, a.data))
    return CSC(a.shape, t.indptr, t.indices, t.data)


@span("sblas.csr_transpose", "convert")
def csr_transpose(a: CSR) -> CSR:
    """CSR of A^T, by a counting sort on the columns in the host library
    (:func:`sblas_torch.native.csr_transpose`): each column's entries in
    row order, the stable sort's order, for any input. Raises
    ``RuntimeError`` without ``g++``, as the level sweep does."""
    m, n = a.shape
    indptr, indices, data = native.csr_transpose(a.indptr, a.indices, a.data,
                                                 (m, n))
    return CSR((n, m), indptr, indices, data)


def csr_transpose_plain(a: CSR) -> CSR:
    """:func:`csr_transpose` in numpy, the version the tests hold it to. A
    stable sort of the nonzeros by column is exactly the transpose's CSR
    order: grouped by column, each column in row order."""
    m, n = a.shape
    counts = np.bincount(a.indices, minlength=n).astype(INDEX_DTYPE)
    indptr = np.zeros(n + 1, dtype=INDEX_DTYPE)
    np.cumsum(counts, out=indptr[1:])
    order = np.argsort(a.indices, kind="stable")
    return CSR((n, m), indptr, a.row_ids()[order], a.data[order])


def _canonical(a: CSR) -> bool:
    """True where ``indptr`` rises from 0 to nnz and every row's columns
    strictly increase: the CSR that a per-row mask keeps canonical. One
    vectorised pass over the columns."""
    indptr, indices = a.indptr, a.indices
    if indptr[0] != 0 or indptr[-1] != len(indices) or \
            (indptr[1:] < indptr[:-1]).any():
        return False
    rises = indices[1:] > indices[:-1]
    # the comparisons across a row boundary do not count
    starts = indptr[1:-1]
    rises[starts[(starts > 0) & (starts < len(indices))] - 1] = True
    return bool(rises.all())


def _masked(a: CSR, mask: np.ndarray, diag: np.ndarray | None = None) -> CSR:
    """The entries of the canonical ``a`` that ``mask`` keeps, in their
    order, with the values the COO round trip (:func:`tril_plain`) gives:
    summed onto zeros, so a stored ``-0.0`` comes out ``+0.0``. The entries
    under ``diag`` are set to 1."""
    m = a.shape[0]
    indices = a.indices[mask]
    data = a.data[mask]
    np.add(data, 0.0, out=data)
    if diag is not None:
        data[diag[mask]] = 1.0
    # each row's kept count; reduceat over the rows that hold entries,
    # since it reads one entry for an empty segment
    starts = a.indptr[:-1]
    full = a.indptr[1:] > starts
    counts = np.zeros(m, dtype=INDEX_DTYPE)
    counts[full] = np.add.reduceat(mask, starts[full], dtype=INDEX_DTYPE)
    indptr = np.zeros(m + 1, dtype=INDEX_DTYPE)
    np.cumsum(counts, out=indptr[1:])
    return CSR(a.shape, indptr, indices, data)


@span("sblas.tril", "convert")
def tril(a: CSR, k: int = 0, *, unit_diagonal: bool = False) -> CSR:
    """The lower-triangular part (col <= row + k). ``unit_diagonal`` sets
    the stored diagonal entries to exactly 1. A canonical ``a`` is masked
    row by row; any other goes the COO round trip of :func:`tril_plain`,
    which sorts and sums duplicates. Both give the same arrays."""
    if not _canonical(a):
        return tril_plain(a, k, unit_diagonal=unit_diagonal)
    rows = a.row_ids()
    return _masked(a, a.indices <= rows + k,
                   a.indices == rows if unit_diagonal else None)


@span("sblas.triu", "convert")
def triu(a: CSR, k: int = 0) -> CSR:
    """The upper-triangular part (col >= row + k), as :func:`tril`."""
    if not _canonical(a):
        return triu_plain(a, k)
    return _masked(a, a.indices >= a.row_ids() + k)


def tril_plain(a: CSR, k: int = 0, *, unit_diagonal: bool = False) -> CSR:
    """:func:`tril` through COO: the triplets masked, sorted by (row, col)
    and their duplicates summed (:func:`coo_to_csr`)."""
    coo = a.tocoo()
    mask = coo.col <= coo.row + k
    out = COO(a.shape, coo.row[mask], coo.col[mask], coo.data[mask]).tocsr()
    if unit_diagonal:
        d = out.tocoo()
        data = d.data.copy()
        data[d.row == d.col] = 1.0
        out = COO(a.shape, d.row, d.col, data).tocsr()
    return out


def triu_plain(a: CSR, k: int = 0) -> CSR:
    """:func:`triu` through COO, as :func:`tril_plain`."""
    coo = a.tocoo()
    mask = coo.col >= coo.row + k
    return COO(a.shape, coo.row[mask], coo.col[mask], coo.data[mask]).tocsr()


def has_full_diagonal(a: CSR) -> bool:
    """True iff every row i (i < min(shape)) stores an explicit (i, i) entry."""
    m = min(a.shape)
    coo = a.tocoo()
    diag_rows = np.unique(coo.row[coo.row == coo.col])
    return len(diag_rows) == m


def from_reference(a):
    """The port's CSR or CSC holding the same arrays as ``a``.

    ``a`` is a matrix of the JAX package (or any object with ``shape``,
    ``indptr``, ``indices`` and ``data``); it is read as numpy arrays and
    never imported. A CSC (its class is named ``CSC``) stays a CSC. The
    arrays are shared, not copied, where they already have the port's
    dtypes.
    """
    if isinstance(a, (CSR, CSC)):
        return a
    try:
        parts = (tuple(int(s) for s in a.shape), np.asarray(a.indptr),
                 np.asarray(a.indices), np.asarray(a.data))
    except AttributeError as e:
        raise TypeError(f"{type(a).__name__} is not a compressed sparse "
                        "matrix (needs shape, indptr, indices, data)") from e
    cls = CSC if type(a).__name__ == "CSC" else CSR
    return cls(*parts)


def as_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a name (``"bfloat16"``) or anything
    ``numpy.dtype`` takes (``np.float32``, ``ml_dtypes.bfloat16``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"not a dtype torch knows: {dtype!r}")
    return out


def check_uploadable(a: CSR, value_dtype=None) -> torch.dtype:
    """The value dtype ``a`` goes to the device in, after the checks every
    upload makes: f32, bf16 or f64 values, no complex, nnz < 2**31."""
    if not isinstance(a, CSR):
        raise TypeError(f"expected sblas_torch.CSR, got {type(a).__name__}")
    if a.nnz >= 2**31:
        raise ValueError(f"nnz={a.nnz} >= 2**31 overflows the int32 offsets")
    if np.iscomplexobj(a.data):
        raise ValueError("complex values are not supported by the port's "
                         "kernels (f32, bf16 or f64 only)")
    vd = as_torch_dtype(a.dtype if value_dtype is None else value_dtype)
    if vd not in VALUE_DTYPES:
        raise ValueError(f"value dtype must be f32, bf16 or f64, got {vd}")
    return vd


@span("sblas.cast", "convert")
def cast(values: np.ndarray, dtype) -> np.ndarray:
    """``values.astype(dtype)``, a value cast of the set-up."""
    return values.astype(dtype)


@span("sblas.upload", "upload")
def upload(arr: np.ndarray, device) -> torch.Tensor:
    """A contiguous numpy array as a tensor on ``device``. A read-only array
    (a matrix loaded memory-mapped, ``matrix_cache``) is copied: to the card
    as any array is, on the CPU into a tensor of its own."""
    arr = np.ascontiguousarray(arr)
    if arr.flags.writeable:
        return torch.from_numpy(arr).to(device)
    if torch.device(device).type == "cpu":
        return torch.from_numpy(arr.copy())
    with warnings.catch_warnings():
        # torch warns that it cannot mark the view read-only; .to copies it
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(arr).to(device)


@span("sblas.to_device", "upload")
def to_device(a: CSR, device, value_dtype=None) -> dict:
    """Upload ``a`` to ``device``.

    Returns ``{"shape": (m, n), "indptr", "indices", "data"}``: ``indptr``
    and ``indices`` as int32, ``data`` in ``value_dtype`` (default: the
    matrix's own), which must be f32, bf16 or f64. bf16 values are rounded
    from the host values to nearest even, as the JAX package does. Raises
    ``ValueError`` for nnz >= 2**31 (the int32 offsets would overflow) and
    for complex values.
    """
    vd = check_uploadable(a, value_dtype)
    device = torch.device(device)
    out = {
        "shape": tuple(a.shape),
        "indptr": upload(a.indptr.astype(INDEX_DTYPE, copy=False), device),
        "indices": upload(a.indices.astype(INDEX_DTYPE, copy=False), device),
    }
    data = upload(a.data, device)
    with span("sblas.cast", "convert"):
        out["data"] = data.to(vd)
    return out
