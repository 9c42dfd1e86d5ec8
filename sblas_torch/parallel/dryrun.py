"""One step of every distributed plan and solver of the port on small
shapes, each against scipy: the port of ``dryrun_multichip``
(``__graft_entry__.py:35-167``).

    from sblas_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(4, device="cpu")       # 4 local gloo ranks
    dryrun_multichip(4)                     # 4 ranks, one a card

:func:`dryrun_multichip` starts ``n`` local ranks
(:func:`~sblas_torch.parallel.launch.spawn`) and runs :func:`gate` on each:
the 1D plans under every strategy, the ring, the SpMM plans, the 2D and
hierarchical plans (``n`` even, at least 4), the halo plans, the one-shot
functions, the three solvers and the triangular solves (``K = 4`` for
``sptrsm``), each result held to scipy. Every rank must
return the same bits. It fails, naming it, on any name that
``sblas_torch.parallel.__all__`` exports as a plan class or a function of
a plan and that it does not gate: the JAX package's dryrun missed
``Dist2DSpmmPlan``; this one cannot miss a new plan.
"""

from __future__ import annotations

import numpy as np

from .launch import spawn

# the exported names that are no plan or solver: meshes and axis names
_NOT_GATED = ("make_mesh", "make_mesh2d", "make_mesh_hier", "chips_axis",
              "rows_axis", "cols_axis", "hosts_axis")


def nonsymmetric(nx: int):
    """A shifted 2D Laplacian with some couplings scaled on one side: a
    nonsymmetric, well-conditioned f64 system."""
    from .. import datasets
    from ..formats import CSR

    s = datasets.poisson2d(nx, dtype=np.float64).to_scipy().tolil()
    for i in range(0, nx * nx - 1, 3):
        s[i, i + 1] *= 1.5
    s.setdiag(s.diagonal() + 4.0)
    return CSR.from_scipy(s.tocsr())


def gate(n: int, device: str) -> dict:
    """Every plan class and solver of :mod:`sblas_torch.parallel` on this
    rank, against scipy (``AssertionError`` on a miss): ``{name: bytes of
    the result}``, for the caller to hold the ranks' bits equal."""
    from .. import datasets, parallel
    from ..golden import (rel_err, spmm_golden, spmv_golden, sptrsm_golden,
                          sptrsv_golden)

    rng = np.random.default_rng(0)
    got = {}

    def held(name, out, want, tol=1e-4):
        out = out.cpu().numpy()
        err = rel_err(out, want)
        if not err < tol:
            raise AssertionError(f"{name}: rel_err {err} >= {tol}")
        got[name] = out.tobytes()

    mesh = parallel.make_mesh(n, device=device)
    a = datasets.random_csr(64 * n, 64 * n, 6, seed=1, dtype=np.float32)
    x = rng.standard_normal(a.shape[1]).astype(np.float32)
    xk = rng.standard_normal((a.shape[1], 8)).astype(np.float32)
    for strategy in ("even_rows", "nnz_balanced", "nnz_split"):
        held(f"DistSpmvPlan {strategy}",
             parallel.DistSpmvPlan(a, mesh, strategy=strategy)(x),
             spmv_golden(a, x))
        held(f"DistSpmmPlan {strategy}",
             parallel.DistSpmmPlan(a, mesh, strategy=strategy)(xk),
             spmm_golden(a, xk))
    held("RingSpmvPlan", parallel.RingSpmvPlan(a, mesh)(x),
         spmv_golden(a, x))
    held("dist_spmv", parallel.dist_spmv(a, x, mesh), spmv_golden(a, x))
    held("dist_spmm", parallel.dist_spmm(a, xk, mesh), spmm_golden(a, xk))
    if n >= 4 and n % 2 == 0:
        m2 = parallel.make_mesh2d(2, n // 2, device=device)
        held("Dist2DSpmvPlan", parallel.Dist2DSpmvPlan(a, m2)(x),
             spmv_golden(a, x))
        held("Dist2DSpmmPlan", parallel.Dist2DSpmmPlan(a, m2)(xk),
             spmm_golden(a, xk))
        held("dist_spmv2d", parallel.dist_spmv2d(a, x, m2),
             spmv_golden(a, x))
        held("dist_spmm2d", parallel.dist_spmm2d(a, xk, m2),
             spmm_golden(a, xk))
        mh = parallel.make_mesh_hier(2, n // 2, device=device)
        for strategy in ("nnz_balanced", "nnz_split"):
            held(f"HierSpmvPlan {strategy}",
                 parallel.HierSpmvPlan(a, mh, strategy=strategy)(x),
                 spmv_golden(a, x))
            held(f"HierSpmmPlan {strategy}",
                 parallel.HierSpmmPlan(a, mh, strategy=strategy)(xk),
                 spmm_golden(a, xk))
    ah = datasets.banded(96 * n, 5, seed=3, dtype=np.float32)
    xh = rng.standard_normal(ah.shape[0]).astype(np.float32)
    xhk = rng.standard_normal((ah.shape[0], 8)).astype(np.float32)
    held("HaloSpmvPlan", parallel.HaloSpmvPlan(ah, mesh)(xh),
         spmv_golden(ah, xh))
    held("HaloSpmmPlan", parallel.HaloSpmmPlan(ah, mesh)(xhk),
         spmm_golden(ah, xhk))
    held("halo_spmv", parallel.halo_spmv(ah, xh, mesh), spmv_golden(ah, xh))
    held("halo_spmm", parallel.halo_spmm(ah, xhk, mesh),
         spmm_golden(ah, xhk))
    spd = datasets.poisson2d(4 * n, dtype=np.float64)
    ns = nonsymmetric(4 * n)
    b = rng.standard_normal(spd.shape[0])
    for name, mat, kw in (("dist_cg", spd, {}),
                          ("dist_gmres", ns, {"restart": 20}),
                          ("dist_bicgstab", ns, {})):
        xs, info = getattr(parallel, name)(mat, b, mesh=mesh, tol=1e-8,
                                           maxiter=400, **kw)
        res = np.linalg.norm(mat.to_scipy() @ xs.cpu().numpy() - b) / \
            np.linalg.norm(b)
        if not (info["rel_residual"] < 1e-8 and res < 2e-8):
            raise AssertionError(f"{name}: {info}, true residual {res}")
        got[name] = xs.cpu().numpy().tobytes()
    # the triangular solves, as __graft_entry__.py:120-130 gates them
    lt = datasets.lower_triangular(32 * n, 4, seed=2, dtype=np.float32)
    bs = rng.standard_normal(lt.shape[0]).astype(np.float32)
    bk = rng.standard_normal((lt.shape[0], 4)).astype(np.float32)
    held("DistSptrsvPlan", parallel.DistSptrsvPlan(lt, mesh)(bs),
         sptrsv_golden(lt, bs), 1e-3)
    held("dist_sptrsv", parallel.dist_sptrsv(lt, bs, mesh),
         sptrsv_golden(lt, bs), 1e-3)
    held("DistSptrsmPlan", parallel.DistSptrsmPlan(lt, mesh)(bk),
         sptrsm_golden(lt, bk), 1e-3)
    held("dist_sptrsm", parallel.dist_sptrsm(lt, bk, mesh),
         sptrsm_golden(lt, bk), 1e-3)
    return got


def dryrun_multichip(n: int, device: str = "cuda") -> list:
    """:func:`gate` on ``n`` local ranks on ``device``. Raises where a
    check fails, where the ranks' results differ in a bit, or where an
    exported plan or solver went ungated. Returns the gated names."""
    from . import __all__ as exported

    results = spawn(n, gate, n, device, device=device)
    for r, got in enumerate(results[1:], 1):
        for name, bits in got.items():
            if bits != results[0][name]:
                raise AssertionError(f"{name}: rank {r} differs from rank 0")
    covered = {key.split(" ")[0] for key in results[0]}
    if n >= 4 and n % 2 == 0:
        missed = sorted(set(exported) - set(_NOT_GATED) - covered)
        if missed:
            raise AssertionError(f"exported but not gated: {missed}")
    return sorted(covered)
