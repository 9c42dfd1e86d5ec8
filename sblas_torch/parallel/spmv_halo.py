"""Halo-exchange distributed SpMV and SpMM: the port of
``sblas/parallel/spmv_halo.py`` (``HaloSpmvPlan``, ``HaloSpmmPlan``,
``halo_spmv``, ``halo_spmm``), and CG's vectors sharded by the same rows.

For banded and FEM matrices under an even row split, rank ``d``'s rows
touch columns only inside ``[d * chunk - H, (d + 1) * chunk + H)``: beyond
its own ``x`` shard it needs the edge strips of its two ring neighbours.
The 1D ``all_gather`` moves ``~n`` entries a rank; the halo plan moves
``2 H``, whatever ``n`` and the rank count (``H``: the widest one-sided
halo over the ranks, rounded up to 8, at least 8)::

    left  = ppermute(my bottom H rows -> next rank)   } one batch
    right = ppermute(my top H rows    -> previous rank) }
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

**A plan from a rank's own rows.** ``HaloSpmvPlan(rows, mesh, row0=r0)``
takes only this rank's rows: a ``(rows, n)`` CSR with global column
indices whose first row is row ``r0`` of the matrix, which must be the
rank's even split (rank ``d``: rows ``[d * chunk, (d + 1) * chunk)``,
``chunk`` = ``ceil(n / ranks)`` rounded up to 8). No rank holds the whole
matrix: each finds how far its own rows reach past them, and one
``all_reduce`` (``MAX``) over the mesh gives every rank the halo width and
whether every rank's rows are its split, so that a refusal is every
rank's. Given the whole matrix, a plan cuts this rank's rows from it and
goes on the same way: the same block, local plan and ``halo``.

**Row-sharded vectors.** :meth:`HaloPlan.local` is a call without its
``all_gather``: this rank's rows of ``x`` in, its rows of ``y`` out (the
two strips and the local kernel). ``HaloSpmvPlan.sharded()`` is that call
as a plan of the solvers' protocol (:class:`RowSharded`) whose dot
products and norms are this rank's partial sums added over the mesh
(:class:`RowReductions`): ``dist_cg`` runs CG on it with every vector held
as each rank's rows, reading its stopping test one iteration behind
(:func:`sblas_torch.solvers.cg`).

**Counters**, always on, added to where the work is launched:
``EXCHANGES`` (calls whose strips went to the neighbours),
``EXCHANGE_BYTES`` (the bytes of those strips this rank sent) and
``REDUCTIONS`` (the ``all_reduce`` calls of :class:`RowReductions`);
``sblas_torch.trace.dist_counts`` reads them. While a profiler records,
the exchange and each reduction run inside the ranges
``sblas.halo.exchange`` and ``sblas.dist.allreduce``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..formats import CSR, as_torch_dtype
from ..ops.common import as_csr
from ..ops.spmm import K_HINT
from ..ops.spmv import SpmvPlan
from ..trace import op_range, span
from .comm import all_gather, all_reduce, ppermutes
from .mesh import Mesh, chips_axis, make_mesh
from .spmm_dist import local_spmm
from .spmv_dist import (SPMV_LOCAL, _round_up, as_dense, check_member,
                        gather_routes, pad_rows)

EXCHANGES = 0
EXCHANGE_BYTES = 0
REDUCTIONS = 0


def _even_split(n: int, ndev: int, d: int) -> tuple[int, int, int]:
    """``(chunk, first row, end row)`` of rank ``d``'s rows."""
    chunk = _round_up(-(-n // ndev), 8)
    return chunk, min(d * chunk, n), min((d + 1) * chunk, n)


@span("sblas.HaloPlan.rows", "convert")
def _rows_of(a: CSR, r0: int, r1: int) -> CSR:
    """Rows ``[r0, r1)`` of ``a``, global columns kept."""
    p0, p1 = int(a.indptr[r0]), int(a.indptr[r1])
    return CSR((r1 - r0, a.shape[1]), a.indptr[r0:r1 + 1] - p0,
               a.indices[p0:p1], a.data[p0:p1])


@span("sblas.HaloPlan.halo", "build")
def _agree_halo(mesh: Mesh, rows: CSR, row0: int,
                max_halo_frac: float) -> tuple[int, int]:
    """``(chunk, halo)`` over every rank's rows, or ``ValueError`` on every
    rank: from each rank's reach past its split and whether its rows are
    that split, by one ``all_reduce`` (``MAX``)."""
    m, n = rows.shape
    chunk, r0, r1 = _even_split(n, mesh.size, mesh.index)
    reach = 0
    if rows.nnz:
        lo, hi = int(rows.indices.min()), int(rows.indices.max())
        reach = max(r0 - lo, hi - (r0 + chunk - 1), 0)
    split = row0 == r0 and m == r1 - r0
    mine = torch.tensor([reach, int(not split), n, -n], dtype=torch.int64,
                        device=mesh.device)
    reach, off_split, n_max, neg_n_min = all_reduce(
        mesh, chips_axis, mine, op=dist.ReduceOp.MAX).tolist()
    if n_max != -neg_n_min:
        raise ValueError("the ranks' rows have different column counts")
    if off_split:
        raise ValueError(
            f"rows not the even split: rank d takes rows [d * {chunk}, "
            f"(d + 1) * {chunk}) of {n} over {mesh.size} ranks")
    halo = _round_up(max(reach, 8), 8)
    if halo > max_halo_frac * chunk:
        raise ValueError(
            f"halo {halo} exceeds {max_halo_frac:.0%} of the {chunk}-row "
            "shard — matrix is not band-local; use DistSpmvPlan "
            "(all_gather), the PSEG path, or the 2D plan"
        )
    if halo > chunk:
        raise ValueError("halo wider than a shard; fewer chips or "
                         "another plan")
    return chunk, halo


@span("sblas.HaloPlan.shift", "convert")
def _shift_columns(rows: CSR, base: int, ext: int) -> CSR:
    """``rows`` with columns shifted to ``x_ext`` coordinates (``base`` is
    ``x_ext``'s first column): a shift keeps each row's sorted order, and
    every shifted column lies in ``[0, ext)``, so int32 holds it."""
    return CSR((rows.shape[0], ext), rows.indptr - rows.indptr[0],
               rows.indices - base, rows.data)


class HaloPlan:
    """The even row split, this rank's block under a local plan
    (``make_local(block)``), and the halo call. ``a`` is the whole square
    matrix, or, with ``row0``, this rank's rows (module note)."""

    def __init__(self, a, mesh: Mesh, max_halo_frac: float, make_local,
                 row0: int | None = None):
        a = as_csr(a)
        m, n = a.shape
        if row0 is None and m != n:
            raise ValueError("halo plan needs a square matrix (x partition "
                             "= row partition)")
        check_member(mesh)
        self.mesh = mesh
        self.ndev = ndev = mesh.size
        self.shape = (n, n)
        self.dtype = as_torch_dtype(a.dtype)
        self.device = mesh.device
        d = mesh.index
        _, r0, r1 = _even_split(n, ndev, d)
        if row0 is None:
            a, row0 = _rows_of(a, r0, r1), r0
        chunk, halo = _agree_halo(mesh, a, row0, max_halo_frac)
        self.x_chunk = chunk
        self.n_pad = chunk * ndev
        self.halo = halo
        self.ext = chunk + 2 * halo
        self.row0, self.rows = r0, r1 - r0
        self._local = make_local(_shift_columns(a, d * chunk - halo,
                                                self.ext))
        self.local_method = self._local.method
        self.route_reason = self._local.route_reason
        # the collective model: two H-slabs a rank a call
        self.collective_bytes_per_chip = 2 * halo * a.data.itemsize

    def exchange(self, x_own) -> tuple:
        """``(x_own padded to the shard, left, right)``: the strips of the
        ring neighbours for this rank's rows of ``x``, sent and received in
        one batch. Every rank of the mesh calls it at once."""
        global EXCHANGES, EXCHANGE_BYTES
        if x_own.shape[0] != self.rows:
            raise ValueError(f"x_own must have this rank's {self.rows} rows, "
                             f"got {x_own.shape[0]}")
        halo = self.halo
        x_own = pad_rows(x_own, self.x_chunk)
        with op_range("sblas.halo.exchange"):
            left, right = ppermutes(self.mesh, chips_axis,
                                    [(x_own[-halo:], 1), (x_own[:halo], -1)])
        if self.ndev > 1:
            EXCHANGES += 1
            EXCHANGE_BYTES += 2 * left.numel() * left.element_size()
        return x_own, left, right

    def local(self, x_own, alpha=1.0, beta=0.0, y_own=None):
        """``alpha A[rows] x + beta y_own`` on this rank's rows, from its
        rows of ``x`` (``x_own``: ``(rows,)`` or ``(rows, K)``, on the
        plan's device in its dtype): the strips of :meth:`exchange` and the
        local kernel, no ``all_gather``."""
        if y_own is None and beta != 0.0:
            raise ValueError("beta != 0 requires y")
        x_pad, left, right = self.exchange(x_own)
        return self._local(torch.cat([left, x_pad, right]), alpha, beta,
                           y_own)

    def _apply(self, x, alpha, beta, y):
        if y is None and beta != 0.0:
            raise ValueError("beta != 0 requires y")
        c0, r0 = self.mesh.index * self.x_chunk, self.row0
        y_own = None if y is None else y[r0:r0 + self.rows].contiguous()
        y_loc = self.local(x[c0:c0 + self.x_chunk], alpha, beta, y_own)
        return all_gather(self.mesh, chips_axis,
                          pad_rows(y_loc, self.x_chunk))[:self.shape[0]]


class HaloSpmvPlan(HaloPlan):
    """Row-partitioned SpMV with neighbour halo exchange (square A), from
    the whole matrix or, with ``row0``, from this rank's rows alone."""

    @span("sblas.HaloSpmvPlan", "build")
    def __init__(self, a, mesh: Mesh | None = None, *,
                 row0: int | None = None, local_method: str = "auto",
                 max_halo_frac: float = 0.5, min_fill: float = 0.2,
                 th: int = 1024):
        if local_method not in SPMV_LOCAL:
            raise ValueError(f"unknown local_method {local_method!r}")
        mesh = mesh or make_mesh()
        super().__init__(a, mesh, max_halo_frac,
                         lambda b: SpmvPlan(b, local_method,
                                            device=mesh.device), row0)
        self.routes = gather_routes(mesh, self._local,
                                    self._local.bytes_per_iter)
        self.bytes_per_iter = sum(r[2] for r in self.routes)

    def __call__(self, x, alpha: float = 1.0, beta: float = 0.0, y=None):
        x = as_dense(self, x, "x", False)
        if y is not None:
            y = torch.as_tensor(y, dtype=self.dtype, device=self.device)
        return self._apply(x, alpha, beta, y)

    def sharded(self) -> "RowSharded":
        """This plan on this rank's rows, for the solvers
        (:class:`RowSharded`)."""
        return RowSharded(self)


class RowReductions:
    """Dot products and norms of vectors held as each rank's rows: this
    rank's partial sums, added over the mesh by one ``all_reduce`` a call,
    so that every rank holds the same scalars. :meth:`dot_norm` gives
    ``r . z`` and ``||r||`` from one ``all_reduce``."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def _sum(self, t: torch.Tensor) -> torch.Tensor:
        global REDUCTIONS
        with op_range("sblas.dist.allreduce"):
            out = all_reduce(self.mesh, chips_axis, t)
        REDUCTIONS += 1
        return out

    def dot(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return self._sum(torch.dot(u, v).reshape(1))[0]

    def norm(self, v: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(self.dot(v, v))

    def dot_norm(self, r: torch.Tensor, z: torch.Tensor):
        s = self._sum(torch.stack([torch.dot(r, z), torch.dot(r, r)]))
        return s[0], torch.sqrt(s[1])


class RowSharded:
    """A halo SpMV plan on this rank's rows, in the solvers' plan protocol:
    ``shape`` is ``(rows, rows)``, the length of the vectors it takes and
    gives on this rank; a call is :meth:`HaloPlan.local`; ``reductions``
    (:class:`RowReductions`) gives the solvers their dot products and
    norms over every rank's rows."""

    def __init__(self, plan: HaloSpmvPlan):
        self.plan = plan
        self.shape = (plan.rows, plan.rows)
        self.dtype, self.device = plan.dtype, plan.device
        self.reductions = RowReductions(plan.mesh)

    def __call__(self, x, alpha: float = 1.0, beta: float = 0.0, y=None):
        return self.plan.local(x, alpha, beta, y)


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
