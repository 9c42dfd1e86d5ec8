"""Distributed triangular solve over level batches: the port of
``sblas/parallel/sptrsv_dist.py`` (``DistSptrsvPlan``, ``dist_sptrsv``).

The host plan is the JAX package's: rows go in tiles of ``tile_rows``
consecutive rows of one level ((level, row) order), each level's tiles are
dealt to the ranks by dependency affinity under an equal quota a rank
(:func:`deal_tiles`), and consecutive levels fuse into one *batch* while
every dependency whose source lies inside the batch stays on its rank
(:func:`make_batches`). The tile dealing and the batches are the
reference's bit for bit, but they are computed from the CSR and the levels:
the reference pads every row of its schedule to the longest one (an
``(S, W)`` array of columns and one of values), which at 1M rows and 50M
nonzeros takes tens of GB.

Each rank holds two local operands a batch, built once with the plan:

- ``E``: its rows of the batch, with the entries whose column was solved in
  an earlier batch (global columns of ``x``), under the port's single-device
  SpMV plan (the csr kernel; the SpMM plan's ``merge`` kernel in
  :mod:`.sptrsm_dist`);
- ``D``: the same rows, with the entries whose column lies in the batch
  (the batching rule makes them rank-local), in batch-local numbering and
  each row's CSR order, on the sync-free kernel (``csrc/sptrsv_csr.cu``)
  with its ticket order (``sptrsv_csr.ticket_order``). The ``D`` blocks of
  all the rank's batches are one upload; a batch's operand is views into it.

A call, batch by batch::

    rhs  = b[R] - E @ x                  # SpmvPlan(E, "csr"), alpha -1, beta 1
    x[R] = sptrsv_csr(D, rhs)            # the sync-free kernel
    x[rows of the batch] = all_gather(x[R] padded)   # one collective

The gathered slots go to their rows through a slot -> row index fixed with
the plan (each rank's block padded to the largest count a rank holds in the
batch; pads go to a row past ``n`` that the call drops): no slice of it can
run past its end, which was the reference's clamp fault
(``sptrsv_dist.py:222-228``). Every rank builds the plan from the same
global CSR, takes the global ``b`` and returns the global ``x``, the same
bits on every rank. At one rank the plan is one batch with no ``E``, and
the solve is the single-device plan's (``SptrsvPlan(l,
method="syncfree")``), bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..formats import CSR, as_torch_dtype, check_uploadable, upload
from ..levels import level_schedule
from ..ops.common import as_csr
from ..ops.kernels import sptrsv_csr
from ..ops.spmv import SpmvPlan, csr_stream_bytes
from ..ops.sptrsv import syncfree_bytes
from ..sptrsv_schedule import diagonal
from .comm import all_gather
from .mesh import Mesh, chips_axis, make_mesh
from .spmv_dist import check_member, pad_rows


def tile_size(n: int, nlevels: int, tile_rows: int) -> int:
    """``tile_rows``, or where it is 0 or less the JAX package's rule
    (``build_level_schedule``): the mean level size rounded up to 8, within
    8 and 512."""
    if tile_rows > 0:
        return tile_rows
    mean_level = max(n // max(nlevels, 1), 1)
    return int(np.clip(-(-mean_level // 8) * 8, 8, 512))


def strict_entries(l: CSR, lower: bool) -> tuple:
    """``(rows, cols)`` (int64) of the entries strictly on the solved side
    of the diagonal, in CSR order: the dependencies."""
    rows = np.repeat(np.arange(l.shape[0], dtype=np.int64),
                     np.diff(l.indptr))
    cols = l.indices.astype(np.int64)
    off = cols < rows if lower else cols > rows
    return rows[off], cols[off]


def _greedy(scores: np.ndarray, quota: int) -> np.ndarray:
    """The reference's dealing of one level's tiles (``sptrsv_dist.py:
    98-130``): tiles with the widest margin between their best and second
    best rank pick first, each its most preferred rank (ties to the lower
    rank) that has quota left. Runs of tiles whose picks fill no rank are
    dealt at once: each pass ends where a rank fills, so there are at most
    a pass a rank."""
    t, ndev = scores.shape
    srt = np.sort(scores, axis=1)
    margin = srt[:, -1] - (srt[:, -2] if ndev > 1 else 0)
    order = np.argsort(-margin, kind="stable")
    pref = np.argsort(-scores, axis=1, kind="stable")[order]
    out = np.empty(t, dtype=np.int64)
    left = np.full(ndev, quota, dtype=np.int64)
    pos = 0
    while pos < t:
        p = pref[pos:]
        pick = p[np.arange(len(p)), np.argmax(left[p] > 0, axis=1)]
        stop = len(p)
        for d in range(ndev):
            at = np.flatnonzero(pick == d)
            if len(at) > left[d]:
                stop = min(stop, int(at[left[d]]))
        out[order[pos:pos + stop]] = pick[:stop]
        left -= np.bincount(pick[:stop], minlength=ndev)
        pos += stop
    return out


def deal_tiles(l: CSR, levels: np.ndarray, nlevels: int, ndev: int,
               lower: bool, tile_rows: int) -> tuple:
    """The reference's ``_deal_tiles`` from the CSR: ``(tile_chip,
    tiles_per_level, chip_of_row)``. Tiles are numbered level by level;
    a tile's affinity to a rank counts its rows' dependencies that the rank
    owns. One rank takes every tile."""
    n = l.shape[0]
    tr = tile_rows
    order = np.argsort(levels, kind="stable")       # (level, row) order
    sizes = np.bincount(levels, minlength=nlevels)
    tpl = -(-sizes // tr)
    row0 = np.concatenate([[0], np.cumsum(sizes)])
    tile0 = np.concatenate([[0], np.cumsum(tpl)])
    tile_chip = np.zeros(int(tile0[-1]), dtype=np.int64)
    if ndev == 1:
        return tile_chip, tpl, np.zeros(n, dtype=np.int64)
    pos = np.empty(n, dtype=np.int64)
    pos[order] = np.arange(n)
    tile_in_level = (pos - row0[levels]) // tr
    r, c = strict_entries(l, lower)
    by_level = np.argsort(levels[r], kind="stable")
    r, c = r[by_level], c[by_level]
    ent0 = np.concatenate([[0], np.cumsum(np.bincount(levels[r],
                                                      minlength=nlevels))])
    chip_of_row = np.full(n, -1, dtype=np.int64)
    for lv in range(nlevels):
        t = int(tpl[lv])
        e0, e1 = ent0[lv], ent0[lv + 1]
        owner = chip_of_row[c[e0:e1]]
        live = owner >= 0
        scores = np.bincount(tile_in_level[r[e0:e1]][live] * ndev
                             + owner[live], minlength=t * ndev)
        deal = _greedy(scores.reshape(t, ndev), -(-t // ndev))
        tile_chip[tile0[lv]:tile0[lv + 1]] = deal
        rows = order[row0[lv]:row0[lv + 1]]
        chip_of_row[rows] = deal[np.arange(len(rows)) // tr]
    return tile_chip, tpl, chip_of_row


def make_batches(l: CSR, levels: np.ndarray, nlevels: int,
                 chip_of_row: np.ndarray, lower: bool) -> list:
    """The reference's ``_make_batches``: half-open level ranges ``(lv0,
    lv1)``, each extended while every dependency that crosses ranks has
    its source in an earlier batch."""
    if not len(chip_of_row) or (chip_of_row == chip_of_row[0]).all():
        return [(0, nlevels)]           # one rank: nothing crosses
    r, c = strict_entries(l, lower)
    cross = chip_of_row[r] != chip_of_row[c]
    min_start = np.zeros(nlevels, dtype=np.int64)
    if cross.any():
        np.maximum.at(min_start, levels[r[cross]], levels[c[cross]] + 1)
    min_start = np.maximum.accumulate(min_start)
    batches, s = [], 0
    for lv in np.flatnonzero(min_start[1:] > 0) + 1:
        if min_start[lv] > s:
            batches.append((s, int(lv)))
            s = int(lv)
    batches.append((s, nlevels))
    return batches


def _rank_entries(l: CSR, mine: np.ndarray) -> tuple:
    """The entries of the rows ``mine``, row after row in CSR order:
    ``(local row, global row, column, value)``."""
    if len(mine) == l.shape[0] and (mine == np.arange(len(mine))).all():
        rows = np.repeat(np.arange(len(mine), dtype=np.int64),
                         np.diff(l.indptr))
        return rows, rows, l.indices.astype(np.int64), l.data
    lens = np.diff(l.indptr)[mine]
    rows = np.repeat(np.arange(len(mine), dtype=np.int64), lens)
    pos = np.repeat(l.indptr[mine].astype(np.int64)
                    - np.concatenate([[0], np.cumsum(lens)[:-1]]), lens) \
        + np.arange(int(lens.sum()), dtype=np.int64)
    return rows, mine[rows], l.indices[pos].astype(np.int64), l.data[pos]


def _indptr(rows: np.ndarray, nrows: int) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(np.bincount(
        rows, minlength=nrows))]).astype(np.int64)


def layout(levels: np.ndarray, batches: list, chip: np.ndarray,
           ndev: int) -> dict:
    """Rows by (rank, batch, row), and the exchange. ``batch`` (a row's
    batch), ``order`` (the rows so sorted), ``counts`` (``(ndev,
    nbatches)`` rows a rank's block), ``local`` (a row's place in its
    block), ``width`` (a batch's largest block), ``slot0`` (a batch's first
    slot) and ``slot_row`` (a slot's row: batch after batch, rank after
    rank, each block padded to the batch's width with row ``n``)."""
    n, nb = len(levels), len(batches)
    bounds = np.array([b0 for b0, _ in batches] + [np.iinfo(np.int64).max])
    batch = np.searchsorted(bounds, levels, side="right") - 1
    group = chip * nb + batch
    order = np.argsort(group, kind="stable")
    counts = np.bincount(group, minlength=ndev * nb).reshape(ndev, nb)
    start = np.concatenate([[0], np.cumsum(counts)])[:-1]
    local = np.empty(n, dtype=np.int64)
    local[order] = np.arange(n) - start[group[order]]
    width = counts.max(axis=0)
    slot0 = np.concatenate([[0], np.cumsum(width * ndev)])
    slot_row = np.full(int(slot0[-1]), n, dtype=np.int64)
    slot_row[slot0[batch] + chip * width[batch] + local] = np.arange(n)
    return {"batch": batch, "order": order, "counts": counts,
            "start": start.reshape(ndev, nb), "local": local,
            "width": width, "slot0": slot0, "slot_row": slot_row}


def rank_blocks(l: CSR, levels: np.ndarray, chip: np.ndarray, lay: dict,
                me: int, lower: bool) -> dict:
    """Rank ``me``'s rows (``mine``, batch after batch) and its two host
    operands over them: ``D`` (``d_ptr``, ``d_col`` batch-local, ``d_val``,
    and ``d_levels``, each batch's levels from 0) and ``E`` (``e_ptr``,
    ``e_col`` global, ``e_val``), both with one row a row of ``mine``."""
    counts, batch, local = lay["counts"], lay["batch"], lay["local"]
    first = lay["start"][me, 0]
    mine = lay["order"][first:first + counts[me].sum()]
    rloc, rglob, cols, vals = _rank_entries(l, mine)
    ent_batch = batch[rglob]
    in_d = (chip[cols] == me) & (batch[cols] == ent_batch)
    strict = cols < rglob if lower else cols > rglob
    in_e = strict & ~in_d
    d_ptr = _indptr(rloc[in_d], len(mine))
    d_col = local[cols[in_d]]
    # the first batch's levels are the factor's own (its rows depend on
    # nothing outside it); the later batches' come from their blocks,
    # which together make one block-diagonal triangle
    c0 = int(counts[me, 0])
    d_levels = np.empty(len(mine), dtype=np.int32)
    d_levels[:c0] = levels[mine[:c0]]
    if len(mine) > c0:
        row0 = np.concatenate([[0], np.cumsum(counts[me])])
        e0 = d_ptr[c0]
        d_levels[c0:] = level_schedule(
            d_ptr[c0:] - e0, (d_col + row0[ent_batch[in_d]])[e0:] - c0,
            len(mine) - c0, lower=lower)[0]
    return {"mine": mine, "d_ptr": d_ptr, "d_col": d_col,
            "d_val": np.ascontiguousarray(vals[in_d]), "d_levels": d_levels,
            "e_ptr": _indptr(rloc[in_e], len(mine)), "e_col": cols[in_e],
            "e_val": vals[in_e]}


class DistSptrsvPlan:
    """Level-batched triangular solve of one CSR factor on a 1D mesh
    (default: :func:`make_mesh` of every rank), on ``mesh.device``.

    ``nlevels`` and ``nbatches`` are the reference's figures.
    ``bytes_per_iter`` and
    ``collective_bytes`` are the port's own counts, which differ from the
    reference's (``sptrsv_dist.py:235-240``): that one counts its padded
    slots, every row as wide as the longest (``S x W`` columns and values
    a rank) and every batch a segment's largest chunk of whole tiles; this
    one counts the CSR that the kernels read and the rows that the
    exchange moves. ``bytes_per_iter``: the bytes one solve streams, summed
    over the ranks: each ``D`` block as :func:`~sblas_torch.ops.sptrsv.
    syncfree_bytes` counts a solve, and each ``E`` block's CSR stream.
    ``collective_bytes``: the bytes the ``all_gather`` of one solve
    delivers to each rank, every rank's block of a batch padded to the
    largest."""

    def __init__(self, l, mesh: Mesh | None = None, *, lower: bool = True,
                 unit_diagonal: bool = False, tile_rows: int = 8):
        l = as_csr(l)
        n = l.shape[0]
        if l.shape[0] != l.shape[1]:
            raise ValueError(f"sptrsv needs a square matrix, got {l.shape}")
        if check_uploadable(l) not in (torch.float32, torch.float64):
            raise ValueError(f"the sync-free kernel takes f32 or f64 values, "
                             f"got {l.dtype}")
        self.mesh = mesh = mesh or make_mesh()
        check_member(mesh)
        if mesh.axis_names != (chips_axis,):
            raise ValueError(f"DistSptrsvPlan runs on a 1D {chips_axis!r} "
                             f"mesh, got axes {mesh.axis_names}")
        self.ndev = ndev = mesh.size
        self.shape = l.shape
        self.dtype = as_torch_dtype(l.dtype)
        self.device = dev = mesh.device
        self.lower = lower
        self.unit_diagonal = unit_diagonal
        self.local_method = "syncfree"
        inv_diag = (1.0 / diagonal(l, unit_diagonal)).astype(l.dtype)
        levels, self.nlevels = level_schedule(l.indptr, l.indices, n,
                                              lower=lower)
        _, _, chip = deal_tiles(l, levels, self.nlevels, ndev, lower,
                                tile_size(n, self.nlevels, tile_rows))
        batches = make_batches(l, levels, self.nlevels, chip, lower)
        self.nbatches = len(batches)
        lay = layout(levels, batches, chip, ndev)
        self.collective_bytes = len(lay["slot_row"]) * l.data.itemsize

        # this rank's operands: one upload each, a batch's are views
        blk = rank_blocks(l, levels, chip, lay, mesh.index, lower)
        mine, d_ptr, e_ptr = blk["mine"], blk["d_ptr"], blk["e_ptr"]
        bounds = np.concatenate([[0], np.cumsum(lay["counts"][mesh.index])])
        spans = list(zip(bounds[:-1].tolist(), bounds[1:].tolist()))
        perm = upload(np.concatenate([sptrsv_csr.ticket_order(
            blk["d_levels"][r0:r1], lower) for r0, r1 in spans]).astype(
                np.int32), dev)
        up = {"indptr": upload(d_ptr.astype(np.int32), dev),
              "indices": upload(blk["d_col"].astype(np.int32), dev),
              "data": upload(blk["d_val"], dev),
              "inv_diag": upload(inv_diag[mine], dev),
              "rows": upload(mine, dev),
              "slot_row": upload(lay["slot_row"], dev)}
        es = l.data.itemsize
        self._e_host, self._steps, nbytes = [], [], 0
        for b, (r0, r1) in enumerate(spans):
            e0, e1 = e_ptr[r0], e_ptr[r1]
            self._e_host.append(None if e1 == e0 else CSR(
                (r1 - r0, n), (e_ptr[r0:r1 + 1] - e0).astype(np.int32),
                blk["e_col"][e0:e1].astype(np.int32), blk["e_val"][e0:e1]))
            p0, p1 = int(d_ptr[r0]), int(d_ptr[r1])
            nbytes += syncfree_bytes(r1 - r0, p1 - p0, 1, es) + (
                csr_stream_bytes(r1 - r0, e1 - e0, es) if e1 > e0 else 0)
            lv = blk["d_levels"][r0:r1]
            rows = mine[r0:r1]
            s0, s1 = int(lay["slot0"][b]), int(lay["slot0"][b + 1])
            self._steps.append({
                # a run of consecutive rows is a slice of b; the slots of
                # one batch that holds every row in order need no scatter
                "rows": slice(int(rows[0]), int(rows[-1]) + 1)
                if len(rows) and rows[-1] - rows[0] == len(rows) - 1
                else up["rows"][r0:r1],
                "d": {"shape": (r1 - r0, r1 - r0),
                      "indptr": up["indptr"][r0:r1 + 1] - p0,
                      "indices": up["indices"][p0:p1],
                      "data": up["data"][p0:p1],
                      "inv_diag": up["inv_diag"][r0:r1],
                      "perm": perm[r0:r1], "lower": lower, "levels": lv,
                      "nlevels": int(lv.max()) + 1 if len(lv) else 0},
                "width": int(lay["width"][b]),
                "slots": None if s1 - s0 == n and (
                    lay["slot_row"][s0:s1] == np.arange(n)).all()
                else up["slot_row"][s0:s1]})
        # the off-batch products: the csr kernel, a plan a batch with an E
        self._spmv = [None if e is None else SpmvPlan(e, "csr", device=dev)
                      for e in self._e_host]
        self.routes = [None] * ndev
        dist.all_gather_object(self.routes, (
            self.local_method, "the sync-free kernel on each batch's "
            "diagonal block; the csr kernel on its off-batch part", nbytes),
            group=mesh.world_group())
        self.bytes_per_iter = sum(r[2] for r in self.routes)
        self.step_methods = ["syncfree"] + (
            ["csr"] if any(p is not None for p in self._spmv) else [])

    def __repr__(self):
        n = self.shape[0]
        return (f"DistSptrsvPlan({n}x{n}, ranks={self.ndev}, "
                f"nlevels={self.nlevels}, nbatches={self.nbatches}, "
                f"lower={self.lower}, device={self.device})")

    def solve(self, b: torch.Tensor, products: list) -> torch.Tensor:
        """``x`` for ``b`` of shape ``(n,)`` or ``(n, K)`` on the plan's
        device in its dtype, each batch's off-batch product through
        ``products[batch]`` (a plan called as ``plan(x, -1, 1, rhs)``, or
        None where the batch has no ``E`` on this rank)."""
        n = self.shape[0]
        # every row is written before an E reads it; row n takes the pads
        x = b.new_empty((n + 1, *b.shape[1:]))
        for step, prod in zip(self._steps, products):
            rhs = b[step["rows"]]
            if prod is not None:
                rhs = prod(x[:n], -1.0, 1.0, rhs)
            if len(rhs):
                rhs = sptrsv_csr.sptrsv_csr(step["d"], rhs.contiguous())
            got = all_gather(self.mesh, chips_axis,
                             pad_rows(rhs, step["width"]))
            if step["slots"] is None:
                x = got
            else:
                x.index_copy_(0, step["slots"], got)
        return x[:n]

    def __call__(self, b):
        n = self.shape[0]
        b = torch.as_tensor(b, dtype=self.dtype, device=self.device)
        if b.shape != (n,):
            raise ValueError(f"b must have shape ({n},), got "
                             f"{tuple(b.shape)}")
        return self.solve(b, self._spmv)


def dist_sptrsv(l, b, mesh: Mesh | None = None, **kw):
    """One-shot distributed triangular solve (the :class:`DistSptrsvPlan`
    keywords)."""
    return DistSptrsvPlan(l, mesh, **kw)(b)
