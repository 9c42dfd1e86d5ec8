"""Halo-exchange distributed SpMV and SpMM: the port of
``sblas/parallel/spmv_halo.py`` (``HaloSpmvPlan``, ``HaloSpmmPlan``,
``halo_spmv``, ``halo_spmm``).

For banded and FEM matrices under an even row split, rank ``d``'s rows
touch columns only inside ``[d * chunk - H, (d + 1) * chunk + H)``: beyond
its own ``x`` shard it needs the edge strips of its two ring neighbours.
The 1D ``all_gather`` moves ``~n`` entries a rank; the halo plan moves
``2 H``, whatever ``n`` and the rank count (``H``: the widest one-sided
halo over the ranks, rounded up to 8, at least 8)::

    left  = ppermute(my bottom H rows -> next rank)
    right = ppermute(my top H rows    -> previous rank)
    x_ext = concat(left, x_own, right)
    y_own = local plan(block, x_ext)

The ring wraps, but the wrapped strips are never read. At one rank there
is no neighbour, and nothing is sent. Building refuses (``ValueError``) a
matrix whose halo passes ``max_halo_frac`` of the shard, as the JAX package
does: a scattered matrix takes the all-gather, PSEG or 2D plans. The
block's local plan is the port's, on ``chunk + 2 H`` columns
(``local_method`` as in :class:`~sblas_torch.parallel.spmv_dist.
DistSpmvPlan`); no row is split, so ``alpha``, ``beta`` and ``y`` go into
its epilogue.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats import CSR, as_torch_dtype
from ..ops.common import as_csr
from ..ops.spmm import K_HINT
from ..ops.spmv import SpmvPlan
from .comm import all_gather, ppermute
from .mesh import Mesh, chips_axis, make_mesh
from .spmm_dist import local_spmm
from .spmv_dist import (SPMV_LOCAL, _round_up, as_dense, check_member,
                        gather_routes, pad_rows)


def _halo_partition(a: CSR, ndev: int, max_halo_frac: float):
    """Even row split and halo width: ``(chunk, halo, row_starts)``, or
    ``ValueError`` where the matrix is not band-local enough."""
    m, n = a.shape
    chunk = _round_up(-(-n // ndev), 8)
    row_starts = [min(d * chunk, n) for d in range(ndev + 1)]

    halo = 0
    for d in range(ndev):
        p0, p1 = a.indptr[row_starts[d]], a.indptr[row_starts[d + 1]]
        cols = a.indices[p0:p1]
        if cols.size:
            lo, hi = int(cols.min()), int(cols.max())
            halo = max(halo, d * chunk - lo if lo < d * chunk else 0,
                       hi - (d * chunk + chunk - 1)
                       if hi >= d * chunk + chunk else 0)
    halo = _round_up(max(halo, 8), 8)
    if halo > max_halo_frac * chunk:
        raise ValueError(
            f"halo {halo} exceeds {max_halo_frac:.0%} of the {chunk}-row "
            "shard — matrix is not band-local; use DistSpmvPlan "
            "(all_gather), the PSEG path, or the 2D plan"
        )
    if halo > chunk:
        raise ValueError("halo wider than a shard; fewer chips or "
                         "another plan")
    return chunk, halo, row_starts


def _halo_block(a: CSR, r0: int, r1: int, base: int, ext: int) -> CSR:
    """Rows ``[r0, r1)`` with columns shifted to ``x_ext`` coordinates
    (``base`` is ``x_ext``'s first column): a shift keeps each row's sorted
    order."""
    p0, p1 = int(a.indptr[r0]), int(a.indptr[r1])
    return CSR((r1 - r0, ext), a.indptr[r0:r1 + 1].astype(np.int64) - p0,
               a.indices[p0:p1].astype(np.int64) - base, a.data[p0:p1])


class HaloPlan:
    """The even row split, this rank's block under a local plan
    (``make_local(block)``), and the halo call."""

    def __init__(self, a, mesh: Mesh, max_halo_frac: float, make_local):
        a = as_csr(a)
        m, n = a.shape
        if m != n:
            raise ValueError("halo plan needs a square matrix (x partition "
                             "= row partition)")
        check_member(mesh)
        self.mesh = mesh
        self.ndev = ndev = mesh.size
        self.shape = a.shape
        self.dtype = as_torch_dtype(a.dtype)
        self.device = mesh.device
        chunk, halo, row_starts = _halo_partition(a, ndev, max_halo_frac)
        self.x_chunk = chunk
        self.n_pad = chunk * ndev
        self.halo = halo
        self.ext = chunk + 2 * halo
        d = mesh.index
        self._row0 = row_starts[d]
        self._rows = row_starts[d + 1] - row_starts[d]
        self._local = make_local(_halo_block(
            a, row_starts[d], row_starts[d + 1], d * chunk - halo, self.ext))
        self.local_method = self._local.method
        self.route_reason = self._local.route_reason
        # the collective model: two H-slabs a rank a call
        self.collective_bytes_per_chip = 2 * halo * a.data.itemsize

    def _apply(self, x, alpha, beta, y):
        n, halo = self.shape[0], self.halo
        if y is None and beta != 0.0:
            raise ValueError("beta != 0 requires y")
        c0 = self.mesh.index * self.x_chunk
        x_own = pad_rows(x[c0:c0 + self.x_chunk], self.x_chunk)
        left = ppermute(self.mesh, chips_axis, x_own[-halo:], 1)
        right = ppermute(self.mesh, chips_axis, x_own[:halo], -1)
        x_ext = torch.cat([left, x_own, right])
        r0, rows = self._row0, self._rows
        y_own = None if y is None else y[r0:r0 + rows].contiguous()
        y_loc = self._local(x_ext, alpha, beta, y_own)
        return all_gather(self.mesh, chips_axis,
                          pad_rows(y_loc, self.x_chunk))[:n]


class HaloSpmvPlan(HaloPlan):
    """Row-partitioned SpMV with neighbour halo exchange (square A)."""

    def __init__(self, a, mesh: Mesh | None = None, *,
                 local_method: str = "auto", max_halo_frac: float = 0.5,
                 min_fill: float = 0.2, th: int = 1024):
        if local_method not in SPMV_LOCAL:
            raise ValueError(f"unknown local_method {local_method!r}")
        mesh = mesh or make_mesh()
        super().__init__(a, mesh, max_halo_frac,
                         lambda b: SpmvPlan(b, local_method,
                                            device=mesh.device))
        self.routes = gather_routes(mesh, self._local,
                                    self._local.bytes_per_iter)
        self.bytes_per_iter = sum(r[2] for r in self.routes)

    def __call__(self, x, alpha: float = 1.0, beta: float = 0.0, y=None):
        x = as_dense(self, x, "x", False)
        if y is not None:
            y = torch.as_tensor(y, dtype=self.dtype, device=self.device)
        return self._apply(x, alpha, beta, y)


def halo_spmv(a: CSR, x, mesh: Mesh | None = None, **kw):
    """One-shot halo-exchange distributed SpMV."""
    return HaloSpmvPlan(a, mesh, **kw)(x)


class HaloSpmmPlan(HaloPlan):
    """Row-partitioned SpMM with neighbour halo exchange: ``X`` is
    row-sharded like ``x``, the exchange moves two ``(H, K)`` slabs a
    rank. The local plan is the port's SpMM (``local_method`` as in
    :class:`~sblas_torch.parallel.spmm_dist.DistSpmmPlan`, built for
    ``k_hint`` columns)."""

    def __init__(self, a, mesh: Mesh | None = None, *,
                 max_halo_frac: float = 0.5, local_method: str = "auto",
                 k_hint: int = K_HINT):
        mesh = mesh or make_mesh()
        self.k_hint = k_hint
        make = local_spmm(mesh, local_method, k_hint)
        super().__init__(a, mesh, max_halo_frac,
                         lambda b: make(b, local_method))
        self.routes = gather_routes(mesh, self._local,
                                    self._local.bytes_per_iter_nx)
        self.bytes_per_iter = sum(r[2] for r in self.routes)

    def __call__(self, x, alpha: float = 1.0, beta: float = 0.0, y=None):
        x = as_dense(self, x, "X", True)
        if y is not None:
            y = torch.as_tensor(y, dtype=self.dtype, device=self.device)
        return self._apply(x, alpha, beta, y)


def halo_spmm(a: CSR, x, mesh: Mesh | None = None, **kw):
    """One-shot halo-exchange distributed SpMM."""
    return HaloSpmmPlan(a, mesh, **kw)(x)
