"""Dependency levels of a triangular CSR matrix, for the triangular solves.

Row ``i`` of a lower-triangular ``L`` depends on every row ``j < i`` with a
stored entry ``L[i, j]`` (upper: ``j > i``); its level is one more than the
highest level among those rows, 0 when it has none. Entries on the diagonal
and on the other side of it are ignored.

:func:`level_schedule`, what every plan calls, is one serial sweep over the
rows in dependency order in the port's host library
(:func:`sblas_torch.native.level_sweep`, ``hostsrc/levels.cpp``, the copy
of the JAX package's ``sblas/native.py:level_schedule``): O(n + nnz). It
has no numpy fallback: without ``g++`` it raises.

:func:`level_schedule_plain` is its plain version, the one the tests hold
it to: level by level (Kahn's order), the in-degree of each row in the
strict part, the strict part's transpose (who depends on each row), then
one numpy pass per level that releases the rows whose last dependency it
holds. Each pass touches only the level's rows and their dependents, so
the whole is O(nnz + depth) numpy work, where relaxing all rows to a
fixpoint would be O(depth * nnz); each pass's fixed numpy cost still
leaves it well behind the sweep on a factor of thousands of levels.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .native import level_sweep
from .trace import span


@span("sblas.level_schedule", "levels")
def level_schedule(indptr: np.ndarray, indices: np.ndarray, n: int, *,
                   lower: bool = True) -> tuple[np.ndarray, int]:
    """``(levels[n] int32, nlevels)`` of the ``n x n`` triangular matrix with
    CSR pattern ``indptr``/``indices``, from the host library's sweep.
    Duplicate entries change nothing."""
    return level_sweep(indptr, indices, n, lower=lower)


def level_schedule_plain(indptr: np.ndarray, indices: np.ndarray, n: int,
                         *, lower: bool = True) -> tuple[np.ndarray, int]:
    """:func:`level_schedule` in numpy, Kahn's order. Duplicate entries
    count once per copy on both sides, so they change nothing."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int32)
    rows = np.repeat(np.arange(n, dtype=np.int32), np.diff(indptr))
    strict = indices < rows if lower else indices > rows
    dep_rows, dep_cols = rows[strict], indices[strict]
    indeg = np.bincount(dep_rows, minlength=n).astype(np.int64)
    # the strict part's transpose: for each row j, the rows that depend on j
    t = sp.csr_matrix((np.ones(len(dep_rows), np.int8), dep_cols,
                       np.concatenate([[0], np.cumsum(indeg)])),
                      shape=(n, n)).tocsc()
    tptr, tind = t.indptr.astype(np.int64), t.indices
    tlen = np.diff(tptr)
    levels = np.full(n, -1, dtype=np.int32)
    frontier = np.flatnonzero(indeg == 0)
    nlevels = 0
    while frontier.size:
        levels[frontier] = nlevels
        nlevels += 1
        starts, lens = tptr[frontier], tlen[frontier]
        total = int(lens.sum())
        if total == 0:
            break
        # every dependent of the frontier, one entry per stored dependency
        pos = np.repeat(starts - np.cumsum(lens) + lens, lens) + \
            np.arange(total, dtype=np.int64)
        dep, cnt = np.unique(tind[pos], return_counts=True)
        indeg[dep] -= cnt
        frontier = dep[indeg[dep] == 0]
    if (levels < 0).any():      # a strictly triangular part has no cycle
        raise RuntimeError("level schedule left rows unreached")
    return levels, nlevels
