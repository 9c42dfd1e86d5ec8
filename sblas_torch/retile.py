"""Host-side retiling into ELL layouts, the port's own copy.

The port's ``ell`` and ``bucket`` routes are plain-torch anchors of the JAX
package's routes of those names, and use the same layouts:

- ``EllPack``: classic ELLPACK, rows padded to the global max degree. Optimal
  for regular matrices (FEM suite); catastrophic for power-law tails.
- ``BucketEll``: rows grouped into power-of-two degree buckets, each bucket
  its own ELLPACK with a row permutation (a SELL-C-sigma variant with global
  sorting). Bounded padding (<2x) for any degree distribution.

All padding uses column 0 with value 0, so a gather needs no mask.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .formats import CSR, INDEX_DTYPE


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class EllPack:
    """ELLPACK: ``col[m_pad, width]`` / ``val[m_pad, width]``; padded entries
    point at column 0 with value 0. ``m`` is the logical row count."""

    m: int
    n: int
    width: int
    col: np.ndarray  # (m_pad, width) int32
    val: np.ndarray  # (m_pad, width) float
    nnz: int

    @property
    def fill(self) -> float:
        return self.nnz / max(self.col.size, 1)


def to_ell(a: CSR, *, width_multiple: int = 8, row_multiple: int = 8) -> EllPack:
    m, n = a.shape
    deg = a.row_lengths
    width = _round_up(max(int(deg.max(initial=1)), 1), width_multiple)
    m_pad = _round_up(max(m, 1), row_multiple)
    col = np.zeros((m_pad, width), dtype=INDEX_DTYPE)
    val = np.zeros((m_pad, width), dtype=a.data.dtype)
    rr = a.row_ids()
    pos = np.arange(a.nnz, dtype=np.int64) - a.indptr[:-1].astype(np.int64)[rr]
    col[rr, pos] = a.indices
    val[rr, pos] = a.data
    return EllPack(m, n, width, col, val, a.nnz)


@dataclasses.dataclass(frozen=True)
class BucketEll:
    """Degree-bucketed ELLPACK.

    Rows are permuted so similar-degree rows share a bucket; each bucket is an
    independent ELLPACK over the same column space. ``perm`` maps bucket-local
    padded row slots back to original rows: y[perm] = concat(bucket outputs).
    ``perm`` slots for pad rows point at row ``m`` (a dump row sliced off).
    """

    m: int
    n: int
    buckets: Tuple[EllPack, ...]
    perm: np.ndarray  # (sum of bucket m_pad,) int32, values in [0, m]
    nnz: int

    @property
    def fill(self) -> float:
        tot = sum(b.col.size for b in self.buckets)
        return self.nnz / max(tot, 1)


def to_bucket_ell(
    a: CSR, *, max_width: Optional[int] = None, row_multiple: int = 8,
    width_multiple: int = 8,
) -> BucketEll:
    """Bucket rows by ceil-power-of-two degree. Rows with degree above
    ``max_width`` (default: no cap) are split into multiple slots of width
    ``max_width`` whose partial results sum into the same output row — the
    TPU analogue of the reference's nnz-split of heavy rows (SURVEY.md C4).
    Splitting is handled by the caller via ``perm`` collisions being invalid;
    here heavy rows simply get the largest bucket unless capped."""
    m, n = a.shape
    deg = a.row_lengths.astype(np.int64)
    rr_all = np.arange(m, dtype=np.int64)

    # Row slots: (orig_row, start_offset, slot_deg). Heavy rows optionally split.
    if max_width is not None:
        n_slots = np.maximum((deg + max_width - 1) // max_width, 1)
        slot_row = np.repeat(rr_all, n_slots)
        slot_rank = np.arange(len(slot_row)) - np.repeat(
            np.cumsum(n_slots) - n_slots, n_slots
        )
        slot_start = slot_rank * max_width
        slot_deg = np.minimum(deg[slot_row] - slot_start, max_width)
        slot_deg = np.maximum(slot_deg, 0)
    else:
        slot_row = rr_all
        slot_start = np.zeros(m, dtype=np.int64)
        slot_deg = deg

    # Bucket id = ceil log2 of slot degree (degree 0 rows go to bucket 0).
    safe = np.maximum(slot_deg, 1)
    bucket_id = np.ceil(np.log2(safe)).astype(np.int64)
    bucket_id[slot_deg <= width_multiple] = 0

    buckets: List[EllPack] = []
    perms: List[np.ndarray] = []
    indptr64 = a.indptr.astype(np.int64)
    for b in np.unique(bucket_id):
        sel = np.flatnonzero(bucket_id == b)
        rows_b = slot_row[sel]
        starts_b = slot_start[sel]
        degs_b = slot_deg[sel]
        width = _round_up(max(int(degs_b.max(initial=1)), 1), width_multiple)
        mb = len(sel)
        mb_pad = _round_up(mb, row_multiple)
        col = np.zeros((mb_pad, width), dtype=INDEX_DTYPE)
        val = np.zeros((mb_pad, width), dtype=a.data.dtype)
        # Gather each slot's nnz range.
        local_row = np.repeat(np.arange(mb, dtype=np.int64), degs_b)
        local_pos = np.arange(len(local_row)) - np.repeat(
            np.cumsum(degs_b) - degs_b, degs_b
        )
        src = np.repeat(indptr64[rows_b] + starts_b, degs_b) + local_pos
        col[local_row, local_pos] = a.indices[src]
        val[local_row, local_pos] = a.data[src]
        buckets.append(EllPack(mb, n, width, col, val, int(degs_b.sum())))
        p = np.full(mb_pad, m, dtype=INDEX_DTYPE)
        p[:mb] = rows_b
        perms.append(p)

    return BucketEll(m, n, tuple(buckets), np.concatenate(perms), a.nnz)
