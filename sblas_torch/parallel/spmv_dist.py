"""Distributed SpMV over a row partition: the port of
``sblas/parallel/spmv_dist.py`` (``DistSpmvPlan``, ``RingSpmvPlan``,
``dist_spmv``), and the row-partitioned core that ``spmm_dist`` and
``hier`` share.

Every rank builds the plan from the same global CSR and keeps only its own
shard on its device; a call takes the global ``x`` on every rank and
returns the global ``y`` on every rank. Inside a call a rank reads only its
own ``x`` shard (``x[x_chunk * r : x_chunk * (r + 1)]``, zero-padded to
``n_pad``) and gets the rest through the collective of the JAX package's
``shard_map`` body (:mod:`~sblas_torch.parallel.comm`)::

    x_full  = all_gather(x_shard)               # over the mesh's axes
    y_local = local plan(shard, x_full)         # the port's kernels
    y       = all_gather(y_local)  [row strategies; unpadded]
    y       = all_reduce(y_local)  [nnz_split: cut rows' partial sums]

The local plan is the port's single-device plan on the shard
(:class:`~sblas_torch.ops.spmv.SpmvPlan`), ``local_method`` its route:
``auto`` (its own rule, on the shard), ``csr`` (the JAX package's
``pallas``), ``merge``, ``pseg``, ``ell``. ``self.local_method`` and
``self.route_reason`` are this rank's shard's; ``self.routes`` every
rank's ``(route, route_reason)``, gathered when the plan is built. The
JAX package's TPU thresholds (``min_fill``, ``th``: w-SELL fill and tile
height, VMEM fits) are accepted and have no effect on Hopper.

On the row strategies (``even_rows``, ``nnz_balanced``) no row is split:
the shard's kernel sums each row as the single-device plan does, and
``alpha``, ``beta`` and ``y`` go into its epilogue. Under ``nnz_split`` a
shard holds the rows its nonzero range touches, in global row numbers once
merged: its partial sums go to their rows of an ``m``-row vector, one
``all_reduce`` adds them, and ``alpha``, ``beta`` apply after. Every rank
returns the same bits. Plans are not cached (``dist_spmv`` is one-shot),
and a rank's local plan is built directly, never through the single-device
plan cache.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..formats import CSR, as_torch_dtype
from ..ops.common import as_csr
from ..ops.spmv import SpmvPlan
from ..partition import partition_nnz_split, partition_rows
from .comm import all_gather, all_reduce, ppermute
from .mesh import Mesh, chips_axis, make_mesh

SPMV_LOCAL = ("auto", "pallas", "csr", "merge", "pseg", "ell")
STRATEGIES = ("even_rows", "nnz_balanced", "nnz_split")


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def segments(row_starts, stride: int) -> list:
    """``(first, rows)`` of each rank's rows in the gathered padded output
    (rank ``i``'s block starts at ``i * stride``), merged where one block
    runs on into the next: the map that reassembles the ranks' outputs
    into the original row order."""
    out = []
    for i in range(len(row_starts) - 1):
        first, rows = i * stride, int(row_starts[i + 1] - row_starts[i])
        if out and out[-1][0] + out[-1][1] == first:
            out[-1] = (out[-1][0], out[-1][1] + rows)
        elif rows:
            out.append((first, rows))
    return out


def unpad(t: torch.Tensor, segs: list) -> torch.Tensor:
    """The rows of ``segments`` of ``t``, in order: a view where they are
    one run, else one concatenation."""
    if len(segs) == 1:
        return t[segs[0][0]:segs[0][0] + segs[0][1]]
    return torch.cat([t[a:a + r] for a, r in segs]) if segs else t[:0]


def column_block(p: CSR, c0: int, width: int) -> CSR:
    """The columns ``[c0, c0 + width)`` of ``p`` as a ``(rows, width)`` CSR
    with block-local column indices: one pass over the nonzeros, each row's
    order kept (a CSR's columns are sorted, so no sort is needed)."""
    keep = (p.indices >= c0) & (p.indices < c0 + width)
    kept = np.concatenate([[0], np.cumsum(keep)])   # kept before each entry
    return CSR((p.shape[0], width), kept[p.indptr], p.indices[keep] - c0,
               p.data[keep])


def check_member(mesh: Mesh) -> None:
    """Plans are built on the mesh's ranks only."""
    if not mesh.member:
        raise ValueError(f"rank {mesh.rank} is not on the mesh "
                         f"{mesh.devices.tolist()}")


def gather_routes(mesh: Mesh, plan, nbytes: int) -> list:
    """Every rank's ``(route, route_reason, bytes)`` of its local plan."""
    out = [None] * mesh.size
    dist.all_gather_object(out, (plan.method, plan.route_reason, nbytes),
                           group=mesh.world_group())
    return out


def pad_rows(t: torch.Tensor, rows: int, offset: int = 0) -> torch.Tensor:
    """``t`` placed at row ``offset`` of ``rows`` zero rows (``t`` itself
    where it fills them)."""
    if offset == 0 and t.shape[0] == rows:
        return t
    out = t.new_zeros((rows, *t.shape[1:]))
    out[offset:offset + t.shape[0]] = t
    return out


def as_dense(plan, x, what: str, k: bool) -> torch.Tensor:
    """``x`` on the plan's device in its dtype, checked: ``(n,)``, or
    ``(n, k)`` for ``k``."""
    m, n = plan.shape
    x = torch.as_tensor(x, dtype=plan.dtype, device=plan.device)
    if (x.dim() != 2 or x.shape[0] != n) if k else x.shape != (n,):
        raise ValueError(f"{what} must have shape ({n}{', k' if k else ','})"
                         f", got {tuple(x.shape)}")
    return x


class RowPlan:
    """A row partition of one matrix over a mesh's ranks, each rank's
    shard under a local plan of the port (``make_local(shard, method)``),
    and the call's collectives: ``x`` gathered along the mesh's axes, last
    axis first (a 1D mesh: ``chips``; the hierarchical mesh: ``chips``
    within a host, then ``hosts``), ``y`` gathered or summed the same
    way."""

    def __init__(self, a, mesh: Mesh, strategy: str, make_local,
                 local_method: str):
        a = as_csr(a)
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}")
        check_member(mesh)
        self.mesh = mesh
        self.ndev = ndev = mesh.size
        self.shape = a.shape
        self.dtype = as_torch_dtype(a.dtype)
        self.device = mesh.device
        self.strategy = strategy
        m, n = a.shape
        self.x_chunk = _round_up(max(-(-n // ndev), 1), 8)
        self.n_pad = self.x_chunk * ndev
        d = mesh.index
        self._split = strategy == "nnz_split"
        if self._split:
            part = partition_nnz_split(a, ndev)
            nnz = np.array([p.nnz for p in part.parts])
            self._row0 = int(part.first_row[d])
            self.rows_pad = _round_up(max(m, 1), 8)
            self._segs = None
        else:
            part = partition_rows(a, ndev, strategy)
            nnz = part.nnz_counts
            self._row0 = int(part.row_starts[d])
            self.rows_pad = max(_round_up(max(p.shape[0], 1), 8)
                                for p in part.parts)
            self._segs = segments(part.row_starts, self.rows_pad)
        self.nnz_balance = float(nnz.max() / max(nnz.mean(), 1))
        shard = part.parts[d]
        self._rows = shard.shape[0]
        self._local = make_local(shard, local_method)
        self.local_method = self._local.method
        self.route_reason = self._local.route_reason

    def _shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of ``x``, zero-padded to ``x_chunk`` rows."""
        c0 = self.mesh.index * self.x_chunk
        return pad_rows(x[c0:c0 + self.x_chunk], self.x_chunk)

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        for ax in reversed(self.mesh.axis_names):
            t = all_gather(self.mesh, ax, t)
        return t

    def _reduce(self, t: torch.Tensor) -> torch.Tensor:
        for ax in reversed(self.mesh.axis_names):
            t = all_reduce(self.mesh, ax, t)
        return t

    def local_x(self, x: torch.Tensor) -> torch.Tensor:
        """What this rank's local plan reads: the gathered ``x``."""
        return self._gather(self._shard(x))[:self.shape[1]]

    def _apply(self, x, alpha, beta, y):
        m, n = self.shape
        if y is None and beta != 0.0:
            raise ValueError("beta != 0 requires y")
        x_full = self.local_x(x)
        r0, rows = self._row0, self._rows
        if self._split:
            part = pad_rows(self._local(x_full), self.rows_pad, r0)
            out = alpha * self._reduce(part)[:m]
            return out if y is None else out + beta * y
        y_own = None if y is None else y[r0:r0 + rows].contiguous()
        y_loc = self._local(x_full, alpha, beta, y_own)
        return unpad(self._gather(pad_rows(y_loc, self.rows_pad)),
                     self._segs)

    def collective_bytes(self, k: int = 1) -> int:
        """Bytes a rank receives a call with ``k`` columns: the others'
        ``x`` chunks, then the others' padded ``y`` rows (row strategies)
        or a ring ``all_reduce``'s ``2 (P - 1) / P`` of the ``y`` rows
        (``nnz_split``)."""
        es, p = self.dtype.itemsize, self.ndev
        x = (self.n_pad - self.x_chunk) * k * es
        if self._split:
            return x + 2 * (p - 1) * self.rows_pad * k * es // p
        return x + (p - 1) * self.rows_pad * k * es


class DistSpmvPlan(RowPlan):
    """Partition + local plan + collectives for one matrix on one mesh
    (default: :func:`make_mesh` of every rank)."""

    def __init__(self, a, mesh: Mesh | None = None, *,
                 strategy: str = "nnz_balanced", local_method: str = "auto",
                 min_fill: float = 0.2, th: int = 1024):
        if local_method not in SPMV_LOCAL:
            raise ValueError(f"unknown local_method {local_method!r}")
        mesh = mesh or make_mesh()
        super().__init__(
            a, mesh, strategy,
            lambda s, meth: SpmvPlan(s, meth, device=mesh.device),
            local_method)
        self.routes = gather_routes(mesh, self._local,
                                    self._local.bytes_per_iter)
        self.bytes_per_iter = sum(r[2] for r in self.routes)

    def __call__(self, x, alpha: float = 1.0, beta: float = 0.0, y=None):
        x = as_dense(self, x, "x", False)
        if y is not None:
            y = torch.as_tensor(y, dtype=self.dtype, device=self.device)
        return self._apply(x, alpha, beta, y)


class RingSpmvPlan:
    """Ring SpMV: ``x`` stays sharded; shards rotate around the ring
    (:func:`~sblas_torch.parallel.comm.ppermute`) while each rank adds the
    matching column block's product. Rank ``d`` holds at step ``k`` the
    shard ``(d + k) mod P`` and applies ``A[rows_d, cols_(d+k) mod P]``, a
    local ``auto`` plan of its own, its sum carried in the kernel's
    epilogue (``beta = 1``). ``P`` steps of one chunk each: the
    bytes of one ``all_gather``, with one shard of ``x`` held at a time.
    At one rank there is no step to rotate for."""

    def __init__(self, a, mesh: Mesh | None = None, *,
                 strategy: str = "nnz_balanced"):
        a = as_csr(a)
        self.mesh = mesh = mesh or make_mesh()
        check_member(mesh)
        self.ndev = ndev = mesh.size
        self.shape = a.shape
        self.dtype = as_torch_dtype(a.dtype)
        self.device = mesh.device
        m, n = a.shape
        self.x_chunk = _round_up(max(-(-n // ndev), 1), 8)
        self.n_pad = self.x_chunk * ndev
        part = partition_rows(a, ndev, strategy)
        self.nnz_balance = part.balance()
        self.rows_pad = max(_round_up(max(p.shape[0], 1), 8)
                            for p in part.parts)
        d = mesh.index
        self._row0 = int(part.row_starts[d])
        # step k -> the plan of block (d, d + k)
        self._steps = [SpmvPlan(column_block(
            part.parts[d], (d + k) % ndev * self.x_chunk, self.x_chunk),
            "auto", device=self.device) for k in range(ndev)]
        self.local_method = self._steps[0].method
        self.route_reason = self._steps[0].route_reason
        # this rank's route at each step (a column block picks its own)
        self.step_methods = [s.method for s in self._steps]
        self._segs = segments(part.row_starts, self.rows_pad)
        self.routes = gather_routes(mesh, self._steps[0], sum(
            s.bytes_per_iter for s in self._steps))
        self.bytes_per_iter = sum(r[2] for r in self.routes)

    def __call__(self, x, alpha: float = 1.0, beta: float = 0.0, y=None):
        m, _ = self.shape
        x = as_dense(self, x, "x", False)
        if y is None and beta != 0.0:
            raise ValueError("beta != 0 requires y")
        c0 = self.mesh.index * self.x_chunk
        xcur = pad_rows(x[c0:c0 + self.x_chunk], self.x_chunk)
        acc = None
        for k, step in enumerate(self._steps):
            acc = step(xcur) if acc is None else step(xcur, 1.0, 1.0, acc)
            if k + 1 < self.ndev:
                # receive the next rank's shard (pairs (i, i - 1))
                xcur = ppermute(self.mesh, chips_axis, xcur, -1)
        out = unpad(all_gather(self.mesh, chips_axis,
                               pad_rows(acc, self.rows_pad)), self._segs)
        out = alpha * out
        if y is not None:
            out = out + beta * torch.as_tensor(y, dtype=self.dtype,
                                               device=self.device)
        return out


def dist_spmv(a: CSR, x, mesh: Mesh | None = None, *,
              strategy: str = "nnz_balanced", alpha: float = 1.0,
              beta: float = 0.0, y=None):
    """One-shot distributed SpMV (the plan is not cached; build a
    :class:`DistSpmvPlan` for repeated use)."""
    return DistSpmvPlan(a, mesh, strategy=strategy)(x, alpha, beta, y)
