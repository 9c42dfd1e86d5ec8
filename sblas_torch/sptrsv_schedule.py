"""SpTRSV level-set schedule (host side): the port's copy of
``sblas/sptrsv_schedule.py``, on the port's own :mod:`sblas_torch.levels`.

Rows are bucketed by dependency level, then packed into fixed-size tiles
that never mix levels, so a solve can be a serial scan over tiles with all
dependencies in strictly earlier tiles. It feeds the torch ``tiles`` route
of :mod:`sblas_torch.ops.sptrsv`. The card's kernel needs no schedule: it
solves in natural row order and waits on each dependency itself.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .formats import CSR, INDEX_DTYPE
from .levels import level_schedule
from .trace import span


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True, eq=False)
class LevelSchedule:
    """Padded tile schedule for a triangular solve.

    Rows are ordered by (level, row) and padded so every level occupies a
    whole number of ``tile_rows``-row tiles. Slot arrays have one entry per
    padded slot:

    - ``slot_row``  (S,): original row for the slot, or ``n`` for pad slots.
    - ``col``  (S, W): off-diagonal column indices, padded with ``n``, which
      points at a constant-zero x slot.
    - ``val``  (S, W): matching off-diagonal values (0 for pads).
    - ``inv_diag`` (S,): 1/diagonal for the row (1 for pads/unit diag).
    - ``num_tiles``: S / tile_rows.
    - ``level_of_tile`` (num_tiles,): level id per tile (diagnostics).

    x is computed in a buffer of length n+2: slot n is the constant-zero
    gather target for padded columns; slot n+1 is the dump target written by
    pad slots.
    """

    n: int
    nnz: int
    tile_rows: int
    width: int
    nlevels: int
    slot_row: np.ndarray
    col: np.ndarray
    val: np.ndarray
    inv_diag: np.ndarray
    level_of_tile: np.ndarray
    levels: np.ndarray  # per original row

    @property
    def num_tiles(self) -> int:
        return len(self.slot_row) // self.tile_rows

    @property
    def padded_slots(self) -> int:
        return len(self.slot_row)


@span("sblas.diagonal", "build")
def diagonal(l: CSR, unit_diagonal: bool = False) -> np.ndarray:
    """The diagonal of a square ``l`` in float64 (ones for
    ``unit_diagonal``). Raises ``ValueError`` for a missing or zero
    diagonal entry."""
    n = l.shape[0]
    diag = np.ones(n, dtype=np.float64)
    if unit_diagonal:
        return diag
    rows = l.row_ids()
    dmask = rows == l.indices
    diag_rows = rows[dmask]
    diag[diag_rows] = l.data[dmask]
    found = np.zeros(n, dtype=bool)
    found[diag_rows] = True
    missing = np.flatnonzero(~found)
    if len(missing):
        raise ValueError(
            f"{len(missing)} rows have no diagonal entry "
            f"(first: {missing[:5]}); pass unit_diagonal=True or fix L")
    if np.any(diag == 0.0):
        raise ValueError("zero diagonal entry; matrix is singular")
    return diag


def build_level_schedule(
    l: CSR, *, lower: bool = True, unit_diagonal: bool = False,
    tile_rows: int = 0, width_multiple: int = 8,
) -> LevelSchedule:
    """Analyse a triangular CSR matrix into a :class:`LevelSchedule`.

    ``tile_rows=0`` picks a size balancing padding waste (small tiles) against
    per-tile parallelism (big tiles): max(8, min(512, mean level size rounded
    to 8)).
    """
    n = l.shape[0]
    if l.shape[0] != l.shape[1]:
        raise ValueError("sptrsv requires a square matrix")
    levels, nlevels = level_schedule(l.indptr, l.indices, n, lower=lower)

    if tile_rows <= 0:
        mean_level = max(n // max(nlevels, 1), 1)
        tile_rows = int(np.clip(_round_up(mean_level, 8), 8, 512))

    # Order rows by (level, row); pad each level to a multiple of tile_rows.
    order = np.lexsort((np.arange(n), levels))
    level_sizes = np.bincount(levels, minlength=nlevels)
    padded_sizes = np.maximum(
        ((level_sizes + tile_rows - 1) // tile_rows) * tile_rows, 0
    )
    total = int(padded_sizes.sum())
    slot_row = np.full(total, n, dtype=INDEX_DTYPE)
    starts = np.concatenate([[0], np.cumsum(padded_sizes)[:-1]])
    src = 0
    for lv in range(nlevels):
        sz = int(level_sizes[lv])
        slot_row[starts[lv]: starts[lv] + sz] = order[src: src + sz]
        src += sz

    # Off-diagonal ELL per slot + diagonal extraction.
    rows_nnz = l.row_ids().astype(np.int64)
    cols_nnz = l.indices.astype(np.int64)
    is_off = (cols_nnz < rows_nnz) if lower else (cols_nnz > rows_nnz)
    diag = diagonal(l, unit_diagonal)

    off_rows = rows_nnz[is_off]
    off_cols = cols_nnz[is_off]
    off_vals = l.data[is_off]
    off_deg = np.bincount(off_rows, minlength=n)
    width = _round_up(max(int(off_deg.max(initial=0)), 1), width_multiple)

    # slot index for each original row
    slot_of_row = np.full(n + 1, -1, dtype=np.int64)
    live = slot_row != n
    slot_of_row[slot_row[live]] = np.flatnonzero(live)

    col = np.full((total, width), n, dtype=INDEX_DTYPE)  # n -> zero slot
    val = np.zeros((total, width), dtype=l.data.dtype)
    if len(off_rows):
        o_indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(off_deg, out=o_indptr[1:])
        pos = np.arange(len(off_rows)) - o_indptr[off_rows]
        col[slot_of_row[off_rows], pos] = off_cols
        val[slot_of_row[off_rows], pos] = off_vals

    inv_diag = np.ones(total, dtype=l.data.dtype)
    inv_diag[live] = (1.0 / diag[slot_row[live]]).astype(l.data.dtype)

    level_of_tile = np.repeat(
        np.arange(nlevels, dtype=INDEX_DTYPE), padded_sizes // tile_rows
    )
    return LevelSchedule(
        n=n, nnz=l.nnz, tile_rows=tile_rows, width=width, nlevels=nlevels,
        slot_row=slot_row, col=col, val=val, inv_diag=inv_diag,
        level_of_tile=level_of_tile, levels=levels,
    )


def validate_schedule(sched: LevelSchedule) -> None:
    """Debug check: every slot's dependencies must resolve to strictly
    earlier tiles, and ``level_of_tile`` has one entry per tile. Raises
    ``ValueError`` where they do not."""
    tr = sched.tile_rows
    tile_of_slot = np.arange(sched.padded_slots) // tr
    slot_of_row = np.full(sched.n + 1, -1, dtype=np.int64)
    live = sched.slot_row != sched.n
    slot_of_row[sched.slot_row[live]] = np.flatnonzero(live)
    dep_cols = sched.col[live]
    real = dep_cols != sched.n
    dep_tiles = tile_of_slot[slot_of_row[dep_cols[real]]]
    own_tiles = np.repeat(tile_of_slot[live], real.sum(axis=1))
    if not np.all(dep_tiles < own_tiles):
        bad = np.flatnonzero(dep_tiles >= own_tiles)[:5]
        raise ValueError(f"schedule violates dependencies at {bad}")
    if len(sched.level_of_tile) != sched.num_tiles:
        raise ValueError("level_of_tile does not have one entry per tile")
