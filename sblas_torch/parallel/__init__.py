"""Distributed plans of the port over ``torch.distributed``: the port of
``sblas/parallel/``.

The JAX package runs one controller over a mesh of chips (``shard_map``
bodies, XLA collectives). The port runs one process a rank (SPMD): every
rank builds the same plan from the same global matrix, keeps its own shard
on its device, takes the global ``x`` and returns the global ``y``. Within a
call it reads only its own ``x`` shard and gets the rest through the
collective the JAX package's body uses (:mod:`.comm`); its shard runs the
port's own kernels through the single-device plans.

    from sblas_torch.parallel import make_mesh, DistSpmvPlan
    mesh = make_mesh()                        # every rank (torchrun), or 1
    y = DistSpmvPlan(a, mesh)(x)              # on every rank

Start ranks with ``torchrun``, or locally with
:func:`.launch.spawn`. ``NOT_PORTED`` names the JAX package's distributed
triangular solves, which have no port yet.
"""

from .hier import HierSpmmPlan, HierSpmvPlan
from .mesh import (Mesh, chips_axis, cols_axis, hosts_axis, make_mesh,
                   make_mesh2d, make_mesh_hier, rows_axis)
from .solvers_dist import dist_bicgstab, dist_cg, dist_gmres
from .spmm2d import Dist2DSpmmPlan, dist_spmm2d
from .spmm_dist import DistSpmmPlan, dist_spmm
from .spmv2d import Dist2DSpmvPlan, dist_spmv2d
from .spmv_dist import DistSpmvPlan, RingSpmvPlan, dist_spmv
from .spmv_halo import HaloSpmmPlan, HaloSpmvPlan, halo_spmm, halo_spmv

NOT_PORTED = ("DistSptrsvPlan", "dist_sptrsv", "DistSptrsmPlan",
              "dist_sptrsm")

__all__ = [
    "make_mesh", "make_mesh2d", "chips_axis", "rows_axis", "cols_axis",
    "hosts_axis", "HierSpmvPlan", "HierSpmmPlan", "make_mesh_hier",
    "DistSpmvPlan", "RingSpmvPlan", "dist_spmv",
    "HaloSpmvPlan", "halo_spmv", "HaloSpmmPlan", "halo_spmm",
    "Dist2DSpmvPlan", "dist_spmv2d",
    "Dist2DSpmmPlan", "dist_spmm2d",
    "DistSpmmPlan", "dist_spmm",
    "dist_cg", "dist_bicgstab", "dist_gmres",
]
