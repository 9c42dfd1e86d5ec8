"""Distributed SpMM over a row partition: the port of
``sblas/parallel/spmm_dist.py`` (``DistSpmmPlan``, ``dist_spmm``).

The data flow of :mod:`~sblas_torch.parallel.spmv_dist` with ``X (n, K)``:
a rank reads its row chunk of ``X``, ``all_gather`` makes the whole ``X``,
its shard's local plan runs, and ``Y`` comes back gathered (row
strategies) or summed (``nnz_split``). The local plan is the port's
:class:`~sblas_torch.ops.spmm.SpmmPlan` on the shard, built for ``k_hint``
columns: ``auto`` (its bytes rule on the shard: ``block`` or ``merge``),
``block`` (the JAX package's ``bsr_t``), ``merge`` (its ``pallas``),
``pseg``, ``ell``. The JAX package's ``row_block``, ``min_fill`` and
``th`` (XLA chunking, w-SELL and VMEM limits) are accepted and have no
effect on Hopper.
"""

from __future__ import annotations

import torch

from ..formats import CSR
from ..ops.spmm import K_HINT, SpmmPlan
from .mesh import Mesh, make_mesh
from .spmv_dist import RowPlan, as_dense, gather_routes

# the JAX package's local names -> the port's SpmmPlan routes
SPMM_LOCAL = {"auto": "auto", "bsr_t": "block", "block": "block",
              "pallas": "merge", "merge": "merge", "pseg": "pseg",
              "ell": "ell"}


def local_spmm(mesh: Mesh, local_method: str, k_hint: int):
    """The local SpMM plan factory for ``local_method``."""
    if local_method not in SPMM_LOCAL:
        raise ValueError(f"unknown local_method {local_method!r}")
    return lambda shard, meth: SpmmPlan(shard, SPMM_LOCAL[meth],
                                        k_hint=k_hint, device=mesh.device)


class DistSpmmPlan(RowPlan):
    """Partition + local SpMM plan + collectives for one matrix on one
    mesh (default: :func:`make_mesh` of every rank)."""

    def __init__(self, a, mesh: Mesh | None = None, *,
                 strategy: str = "nnz_balanced", row_block: int = 2048,
                 local_method: str = "auto", min_fill: float = 0.2,
                 th: int = 1024, k_hint: int = K_HINT):
        mesh = mesh or make_mesh()
        self.row_block = row_block
        self.k_hint = k_hint
        super().__init__(a, mesh, strategy,
                         local_spmm(mesh, local_method, k_hint),
                         local_method)
        self.routes = gather_routes(mesh, self._local,
                                    self._local.bytes_per_iter_nx)
        self.bytes_per_iter_nx = sum(r[2] for r in self.routes)

    def __call__(self, x, alpha: float = 1.0, beta: float = 0.0, y=None):
        x = as_dense(self, x, "X", True)
        if y is not None:
            y = torch.as_tensor(y, dtype=self.dtype, device=self.device)
            if y.shape != (self.shape[0], x.shape[1]):
                raise ValueError(f"Y must have shape ({self.shape[0]}, "
                                 f"{x.shape[1]}), got {tuple(y.shape)}")
        return self._apply(x, alpha, beta, y)


def dist_spmm(a: CSR, x, mesh: Mesh | None = None, **kw):
    """One-shot distributed SpMM (``alpha``, ``beta``, ``y`` and the
    :class:`DistSpmmPlan` keywords)."""
    alpha = kw.pop("alpha", 1.0)
    beta = kw.pop("beta", 0.0)
    y = kw.pop("y", None)
    return DistSpmmPlan(a, mesh, **kw)(x, alpha, beta, y)
