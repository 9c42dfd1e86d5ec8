"""2D-partitioned SpMV over a (``rows``, ``cols``) mesh: the port of
``sblas/parallel/spmv2d.py`` (``Dist2DSpmvPlan``, ``dist_spmv2d``), and
the core ``spmm2d`` shares.

Rank ``(i, j)`` owns the block ``A[rows_i, cols_j]``: rows nnz-balanced
into ``R`` groups, columns in ``C`` equal chunks of ``x_chunk`` (a multiple
of 8; the JAX package's 128-alignment is a Pallas window rule). It reads
its chunk ``j`` of ``x``, which is all its block needs: no gather of ``x``.
The one collective of the JAX package's body is an ``all_reduce`` of the
partial ``y_i`` over the ``cols`` group (``spmv2d.py:146``); the global
``y`` then comes from an ``all_gather`` of the ``y_i`` over the ``rows``
group (what the JAX package's sharded output becomes when read). Per rank
the ``all_reduce`` moves ``~2 (C - 1) / C * m / R`` entries, where the 1D
plans gather ``~n``.

The block's local plan is the port's (``local_method``: ``auto``, ``csr``
(the JAX package's ``pallas``), ``merge``, ``pseg``, ``ell``); ``min_fill``
and ``th`` are accepted and have no effect on Hopper. The column split
adds each row in ``C`` partial sums: the result agrees with the
single-device plan to the dtype's tolerance, not bit for bit, and is the
same bits on every rank.
"""

from __future__ import annotations

import torch

from ..formats import CSR, as_torch_dtype
from ..ops.common import as_csr
from ..ops.spmv import SpmvPlan
from ..partition import partition_rows
from .comm import all_gather, all_reduce
from .mesh import Mesh, cols_axis, make_mesh2d, rows_axis
from .spmv_dist import (SPMV_LOCAL, _round_up, as_dense, check_member,
                        column_block, gather_routes, pad_rows, segments,
                        unpad)


class Plan2D:
    """The block of this rank under a local plan (``make_local(block)``),
    and the 2D call: ``x`` chunk ``j`` in, partial ``y_i`` summed over
    ``cols``, gathered over ``rows``."""

    def __init__(self, a, mesh: Mesh, make_local):
        a = as_csr(a)
        if mesh.axis_names != (rows_axis, cols_axis):
            raise ValueError(
                f"need a ('{rows_axis}', '{cols_axis}') mesh; got "
                f"{mesh.axis_names} (make_mesh2d builds one)")
        check_member(mesh)
        self.mesh = mesh
        R, C = mesh.shape
        self.grid = (R, C)
        self.shape = a.shape
        self.dtype = as_torch_dtype(a.dtype)
        self.device = mesh.device
        m, n = a.shape
        self.x_chunk = _round_up(max(-(-n // C), 1), 8)
        self.n_pad = self.x_chunk * C
        part = partition_rows(a, R, "nnz_balanced")
        self.nnz_balance = part.balance()
        self.rows_pad = max(_round_up(max(p.shape[0], 1), 8)
                            for p in part.parts)
        i, j = mesh.coord(rows_axis), mesh.coord(cols_axis)
        self._j = j
        self._local = make_local(column_block(part.parts[i],
                                              j * self.x_chunk, self.x_chunk))
        self.local_method = self._local.method
        self.route_reason = self._local.route_reason
        self._segs = segments(part.row_starts, self.rows_pad)

    def local_x(self, x: torch.Tensor) -> torch.Tensor:
        """What this rank's local plan reads: chunk ``j`` of ``x``."""
        c0 = self._j * self.x_chunk
        return pad_rows(x[c0:c0 + self.x_chunk], self.x_chunk)

    def _apply(self, x, alpha, beta, y):
        if y is None and beta != 0.0:
            raise ValueError("beta != 0 requires y")
        y_i = all_reduce(self.mesh, cols_axis, pad_rows(
            self._local(self.local_x(x)), self.rows_pad))
        out = alpha * unpad(all_gather(self.mesh, rows_axis, y_i),
                            self._segs)
        return out if y is None else out + beta * y

    def collective_bytes(self, k: int = 1) -> int:
        """Bytes a rank receives a call with ``k`` columns: a ring
        ``all_reduce``'s ``2 (C - 1) / C`` of the padded ``y_i`` rows, then
        the other row groups' ``y``."""
        (R, C), es = self.grid, self.dtype.itemsize
        rows = self.rows_pad * k * es
        return 2 * (C - 1) * rows // C + (R - 1) * rows


class Dist2DSpmvPlan(Plan2D):
    """2D-partitioned SpMV (default mesh: :func:`make_mesh2d`, the most
    square one of every rank)."""

    def __init__(self, a, mesh: Mesh | None = None, *,
                 local_method: str = "auto", min_fill: float = 0.2,
                 th: int = 1024):
        if local_method not in SPMV_LOCAL:
            raise ValueError(f"unknown local_method {local_method!r}")
        mesh = mesh or make_mesh2d()
        super().__init__(a, mesh, lambda b: SpmvPlan(b, local_method,
                                                     device=mesh.device))
        self.routes = gather_routes(mesh, self._local,
                                    self._local.bytes_per_iter)
        self.bytes_per_iter = sum(r[2] for r in self.routes)

    def __call__(self, x, alpha: float = 1.0, beta: float = 0.0, y=None):
        x = as_dense(self, x, "x", False)
        if y is not None:
            y = torch.as_tensor(y, dtype=self.dtype, device=self.device)
        return self._apply(x, alpha, beta, y)


def dist_spmv2d(a: CSR, x, mesh: Mesh | None = None, **kw):
    """One-shot 2D-partitioned distributed SpMV."""
    return Dist2DSpmvPlan(a, mesh, **kw)(x)
