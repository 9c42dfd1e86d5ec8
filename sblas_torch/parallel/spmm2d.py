"""2D-partitioned SpMM over a (``rows``, ``cols``) mesh: the port of
``sblas/parallel/spmm2d.py`` (``Dist2DSpmmPlan``, ``dist_spmm2d``).

The data flow of :mod:`~sblas_torch.parallel.spmv2d` with ``X (n, K)``:
rank ``(i, j)`` reads row chunk ``j`` of ``X``, its block's local SpMM
plan (the port's :class:`~sblas_torch.ops.spmm.SpmmPlan`, built for
``k_hint`` columns: ``auto``, ``block``, ``merge`` (the JAX package's
``pallas``), ``pseg``, ``ell``) gives the partial ``Y_i``, an
``all_reduce`` over ``cols`` sums it and an ``all_gather`` over ``rows``
assembles ``Y``. Where 1D plans replicate the whole ``(n, K)`` ``X`` on
every rank, this moves ``~2 (m / R) K``.
"""

from __future__ import annotations

import torch

from ..formats import CSR
from ..ops.spmm import K_HINT
from .mesh import Mesh, make_mesh2d
from .spmm_dist import local_spmm
from .spmv2d import Plan2D
from .spmv_dist import as_dense, gather_routes


class Dist2DSpmmPlan(Plan2D):
    """2D-partitioned SpMM (default mesh: :func:`make_mesh2d` of every
    rank)."""

    def __init__(self, a, mesh: Mesh | None = None, *,
                 local_method: str = "auto", min_fill: float = 0.2,
                 th: int = 1024, k_hint: int = K_HINT):
        mesh = mesh or make_mesh2d()
        self.k_hint = k_hint
        make = local_spmm(mesh, local_method, k_hint)
        super().__init__(a, mesh, lambda b: make(b, local_method))
        self.routes = gather_routes(mesh, self._local,
                                    self._local.bytes_per_iter_nx)
        self.bytes_per_iter = sum(r[2] for r in self.routes)

    def __call__(self, x, alpha: float = 1.0, beta: float = 0.0, y=None):
        x = as_dense(self, x, "X", True)
        if y is not None:
            y = torch.as_tensor(y, dtype=self.dtype, device=self.device)
            if y.shape != (self.shape[0], x.shape[1]):
                raise ValueError(f"Y must have shape ({self.shape[0]}, "
                                 f"{x.shape[1]}), got {tuple(y.shape)}")
        return self._apply(x, alpha, beta, y)


def dist_spmm2d(a: CSR, x, mesh: Mesh | None = None, **kw):
    """One-shot 2D-partitioned distributed SpMM."""
    return Dist2DSpmmPlan(a, mesh, **kw)(x)
