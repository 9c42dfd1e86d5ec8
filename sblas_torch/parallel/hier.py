"""Hierarchical (``hosts``, ``chips``) plans: the port of
``sblas/parallel/hier.py`` (``make_mesh_hier`` lives in
:mod:`~sblas_torch.parallel.mesh`).

Ranks on one host talk over NVLink, hosts over the network. The flat plans
send every rank's ``x`` chunk across hosts on its own; these split each
collective by mesh axis, as the JAX package does (``hier.py:157-170``)::

    x_host = all_gather(x_chunk, 'chips')      # within the host
    x_full = all_gather(x_host,  'hosts')      # once a host
    y      = local plan(shard, x_full)
    [nnz_split] y = all_reduce(y, 'chips') then all_reduce(y, 'hosts')

The partition over all ``hosts * chips`` ranks and the local plans are
those of the flat 1D plans (:class:`~sblas_torch.parallel.spmv_dist.
RowPlan` gathers along the mesh's axes, last first): only the mesh
differs.
"""

from __future__ import annotations

from ..ops.spmm import K_HINT
from .mesh import Mesh, chips_axis, hosts_axis
from .spmm_dist import DistSpmmPlan
from .spmv_dist import DistSpmvPlan


def _check(mesh: Mesh, name: str) -> None:
    if mesh.axis_names != (hosts_axis, chips_axis):
        raise ValueError(
            f"{name} needs a ('{hosts_axis}', '{chips_axis}') mesh, got "
            f"{mesh.axis_names}; use make_mesh_hier()")


class HierSpmvPlan(DistSpmvPlan):
    """1D row/nnz partition over all ``hosts * chips`` ranks, collectives
    by mesh axis."""

    def __init__(self, a, mesh: Mesh, *, strategy: str = "nnz_balanced",
                 local_method: str = "auto", min_fill: float = 0.2,
                 th: int = 1024):
        _check(mesh, "HierSpmvPlan")
        self.nhosts, self.nchips = mesh.shape
        super().__init__(a, mesh, strategy=strategy,
                         local_method=local_method)


class HierSpmmPlan(DistSpmmPlan):
    """The schedule of :class:`HierSpmvPlan` with ``K`` columns."""

    def __init__(self, a, mesh: Mesh, *, strategy: str = "nnz_balanced",
                 row_block: int = 2048, local_method: str = "auto",
                 k_hint: int = K_HINT):
        _check(mesh, "HierSpmmPlan")
        self.nhosts, self.nchips = mesh.shape
        super().__init__(a, mesh, strategy=strategy, row_block=row_block,
                         local_method=local_method, k_hint=k_hint)
