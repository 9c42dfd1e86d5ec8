"""Distributed Krylov solvers: the port of
``sblas/parallel/solvers_dist.py`` (``dist_cg``, ``dist_bicgstab``,
``dist_gmres``).

As the JAX package reuses its solver loops with the distributed SpMV
(``solvers_dist.py:30-105``), these are :func:`sblas_torch.solvers.cg`,
``bicgstab`` and ``gmres`` over a
:class:`~sblas_torch.parallel.spmv_dist.DistSpmvPlan`. Every rank runs the
same loop on replicated vectors; the one collective of an iteration's SpMV
is the plan's own, and since every rank's SpMV returns the same bits, the
ranks' dot products, and so their convergence tests, agree.

    x, info = dist_cg(A, b, tol=1e-8, mesh=make_mesh(device="cpu"))
    x, info = dist_cg(plan, b, M=solvers.jacobi(A, device=plan.device))

``M`` is a preconditioner of :mod:`sblas_torch.solvers` (a callable
``M(r)`` on the plan's device); ``x`` comes back on the plan's device.
"""

from __future__ import annotations

from .. import solvers as _solvers
from .spmv_dist import DistSpmvPlan


def _as_plan(a, mesh, strategy, local_method) -> DistSpmvPlan:
    if isinstance(a, DistSpmvPlan):
        return a
    return DistSpmvPlan(a, mesh, strategy=strategy,
                        local_method=local_method)


def dist_cg(a, b, *, mesh=None, strategy: str = "nnz_balanced",
            local_method: str = "auto", tol: float = 1e-6,
            maxiter: int = 1000, M=None, x0=None):
    """Conjugate gradient for SPD A over a mesh (default: every rank). ``a``
    is a CSR/CSC or a :class:`DistSpmvPlan` (reuse it across solves:
    partitioning is host work). Returns ``(x, {"iterations",
    "rel_residual"})``."""
    return _solvers.cg(_as_plan(a, mesh, strategy, local_method), b,
                       tol=tol, maxiter=maxiter, M=M, x0=x0)


def dist_gmres(a, b, *, mesh=None, strategy: str = "nnz_balanced",
               local_method: str = "auto", tol: float = 1e-6,
               maxiter: int = 1000, restart: int = 30, M=None, x0=None):
    """Restarted GMRES(m) for general square A over a mesh
    (right-preconditioned)."""
    return _solvers.gmres(_as_plan(a, mesh, strategy, local_method), b,
                          tol=tol, maxiter=maxiter, restart=restart, M=M,
                          x0=x0)


def dist_bicgstab(a, b, *, mesh=None, strategy: str = "nnz_balanced",
                  local_method: str = "auto", tol: float = 1e-6,
                  maxiter: int = 1000, M=None, x0=None):
    """BiCGSTAB for general square A over a mesh."""
    return _solvers.bicgstab(_as_plan(a, mesh, strategy, local_method), b,
                             tol=tol, maxiter=maxiter, M=M, x0=x0)
