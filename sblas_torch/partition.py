"""1D multi-device partitioning of CSR matrices: the port's own copy of
``sblas/partition.py``, which the port never imports.

Rows split across ranks three ways: even-row split, nnz-balanced row split
(binary search on the row pointer), and nnz-split that may cut a row
(requiring a partial-sum merge of y). The output feeds the plans of
:mod:`sblas_torch.parallel`, which merge the cut rows' partial sums with
one ``all_reduce``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .formats import CSR, INDEX_DTYPE


@dataclasses.dataclass(frozen=True, eq=False)
class RowPartition:
    """Row-contiguous 1D partition: device d owns rows [row_starts[d],
    row_starts[d+1]). Sub-CSRs keep global column indices (x is replicated or
    gathered on device)."""

    ndev: int
    strategy: str
    row_starts: np.ndarray  # (ndev+1,)
    parts: Tuple[CSR, ...]

    @property
    def row_counts(self) -> np.ndarray:
        return np.diff(self.row_starts)

    @property
    def nnz_counts(self) -> np.ndarray:
        return np.array([p.nnz for p in self.parts])

    def balance(self) -> float:
        """max/mean nnz ratio (1.0 = perfectly balanced)."""
        c = self.nnz_counts
        return float(c.max() / max(c.mean(), 1))


@dataclasses.dataclass(frozen=True, eq=False)
class NnzSplitPartition:
    """Equal-nnz split that may cut rows ("nnz-split").

    Device d owns the nnz range [nnz_starts[d], nnz_starts[d+1]); its local
    rows span [first_row[d], last_row[d]] where boundary rows may be shared
    with neighbours. Each device computes partial sums for its row span; the
    merge plan is: y = sum over devices of scatter(partial, first_row[d]),
    one ``all_reduce`` of length-m partial vectors.
    """

    ndev: int
    nnz_starts: np.ndarray  # (ndev+1,)
    first_row: np.ndarray   # (ndev,)
    last_row: np.ndarray    # (ndev,)
    parts: Tuple[CSR, ...]  # local CSR with rows [first_row[d], last_row[d]]


def partition_rows(a: CSR, ndev: int, strategy: str = "nnz_balanced") -> RowPartition:
    """Row-contiguous split. Strategies: 'even_rows' | 'nnz_balanced'."""
    m, n = a.shape
    if strategy == "even_rows":
        row_starts = np.linspace(0, m, ndev + 1).astype(np.int64)
    elif strategy == "nnz_balanced":
        # Binary-search the row pointer for equal-nnz row boundaries, like the
        # reference's partitioner.
        targets = np.linspace(0, a.nnz, ndev + 1)
        row_starts = np.searchsorted(a.indptr, targets, side="left")
        row_starts[0], row_starts[-1] = 0, m
        row_starts = np.maximum.accumulate(row_starts)
    else:
        raise ValueError(f"unknown strategy {strategy!r}")

    parts = []
    for d in range(ndev):
        r0, r1 = int(row_starts[d]), int(row_starts[d + 1])
        p0, p1 = int(a.indptr[r0]), int(a.indptr[r1])
        indptr = (a.indptr[r0: r1 + 1].astype(np.int64) - p0).astype(INDEX_DTYPE)
        parts.append(
            CSR((r1 - r0, n), indptr, a.indices[p0:p1], a.data[p0:p1])
        )
    return RowPartition(ndev, strategy, row_starts.astype(np.int64), tuple(parts))


def partition_nnz_split(a: CSR, ndev: int) -> NnzSplitPartition:
    """Equal-nnz split allowed to cut rows; boundary rows produce partial
    sums merged across devices."""
    m, n = a.shape
    nnz_starts = np.linspace(0, a.nnz, ndev + 1).astype(np.int64)
    indptr64 = a.indptr.astype(np.int64)
    first_row = np.empty(ndev, dtype=np.int64)
    last_row = np.empty(ndev, dtype=np.int64)
    parts: List[CSR] = []
    for d in range(ndev):
        p0, p1 = int(nnz_starts[d]), int(nnz_starts[d + 1])
        if p1 <= p0:
            first_row[d], last_row[d] = 0, -1
            parts.append(CSR((0, n), np.zeros(1, INDEX_DTYPE),
                             np.empty(0, INDEX_DTYPE),
                             np.empty(0, a.data.dtype)))
            continue
        r0 = int(np.searchsorted(indptr64, p0, side="right")) - 1
        r1 = int(np.searchsorted(indptr64, p1 - 1, side="right")) - 1
        first_row[d], last_row[d] = r0, r1
        nrows = r1 - r0 + 1
        local_ptr = np.clip(indptr64[r0: r1 + 2], p0, p1) - p0
        parts.append(
            CSR((nrows, n), local_ptr.astype(INDEX_DTYPE),
                a.indices[p0:p1], a.data[p0:p1])
        )
    return NnzSplitPartition(ndev, nnz_starts, first_row, last_row, tuple(parts))


def validate_partition(a: CSR, part: RowPartition) -> None:
    """Partition invariants: full row coverage, nnz conservation, per-part
    reconstruction. A breach raises ``AssertionError``, as in the JAX
    package, also under ``python -O``."""
    if not (part.row_starts[0] == 0 and part.row_starts[-1] == a.shape[0]):
        raise AssertionError("the parts do not cover the rows")
    if sum(p.nnz for p in part.parts) != a.nnz:
        raise AssertionError("the parts do not hold every nonzero")
    for d, p in enumerate(part.parts):
        r0, r1 = int(part.row_starts[d]), int(part.row_starts[d + 1])
        if p.shape != (r1 - r0, a.shape[1]):
            raise AssertionError(f"part {d} has shape {p.shape}")
        np.testing.assert_array_equal(
            p.indices, a.indices[a.indptr[r0]: a.indptr[r1]]
        )
