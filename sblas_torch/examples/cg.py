"""Conjugate gradient on the port's plans: the counterpart of
``examples/cg.py``.

Shows the intended usage pattern for iterative solvers:

- build ONE plan per matrix (the analysis once) and call it in the loop;
- the preconditioned variant applies an SSOR preconditioner as two
  triangular solves per iteration (M = (D+L) D^-1 (D+L)^T for SPD A,
  applied as a forward solve and a backsolve on the transposed factor).

Run:  python -m sblas_torch.examples.cg [n] [--device cpu]
      (Poisson 2D on an n x n grid; the card unless --device cpu)
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import datasets, solvers
from ..formats import COO, coo_to_csr, csr_transpose, tril, upload
from ..ops.spmv import SpmvPlan
from ..ops.sptrsv import SptrsvPlan
from ..utils.backend import pick_device


def cg(a, b, *, tol=1e-6, maxiter=1000, m_solve=None, device=None):
    """Solve A x = b (SPD A) by (preconditioned) conjugate gradient.

    ``m_solve(r) -> z`` applies the preconditioner; None = identity.
    Returns (x on the plan's device, iterations, final relative residual).
    """
    plan = SpmvPlan(a, device=device)
    b = torch.as_tensor(np.asarray(b), dtype=plan.dtype, device=plan.device)
    bnorm = float(torch.linalg.vector_norm(b))
    x = torch.zeros_like(b)
    r = b.clone()
    z = m_solve(r) if m_solve else r
    p = z.clone()
    rz = float(r @ z)
    res = 1.0
    for it in range(1, maxiter + 1):
        ap = plan(p)
        alpha = rz / float(p @ ap)
        x += alpha * p
        r -= alpha * ap
        res = float(torch.linalg.vector_norm(r)) / max(bnorm, 1e-30)
        if res < tol:
            return x, it, res
        z = m_solve(r) if m_solve else r
        rz_new = float(r @ z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x, maxiter, res


def ssor_preconditioner(a, omega: float = 1.0, device=None):
    """SSOR: M = (D/w + L) (D/w)^-1 (D/w + L)^T for SPD A = L + D + L^T.

    Applied as one forward solve on (D/w + L), a diagonal scale, and one
    backsolve on its transpose (the sync-free kernel on the card)."""
    lo = tril(a)  # includes the diagonal
    coo = lo.tocoo()
    on_diag = coo.row == coo.col
    diag = np.zeros(a.shape[0], dtype=np.float64)
    diag[coo.row[on_diag]] = coo.data[on_diag]
    if omega != 1.0:
        scaled = coo.data.copy()
        scaled[on_diag] /= omega
        lo = coo_to_csr(COO(lo.shape, coo.row, coo.col, scaled))
        diag = diag / omega
    fwd = SptrsvPlan(lo, lower=True, device=device)
    bwd = SptrsvPlan(csr_transpose(lo), lower=False, device=device)
    dscale = upload(diag.astype(a.dtype), fwd.device)

    def m_solve(r):
        return bwd(fwd(r) * dscale)

    return m_solve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=48)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = pick_device(args.device)
    a = datasets.poisson2d(args.n, dtype=np.float32)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(a.shape[0]).astype(np.float32)

    x, it, res = cg(a, b, tol=1e-5, device=dev)
    print(f"CG          : {it:4d} iterations, rel residual {res:.2e}")

    x, it, res = cg(a, b, tol=1e-5, device=dev,
                    m_solve=ssor_preconditioner(a, device=dev))
    print(f"CG + SSOR   : {it:4d} iterations, rel residual {res:.2e}")

    # the library's solver with the IC(0) preconditioner
    _, info = solvers.cg(a, b, tol=1e-5, M=solvers.ichol(a, device=dev),
                         device=dev)
    print(f"CG + IC(0)  : {info['iterations']:4d} iterations, "
          f"rel residual {info['rel_residual']:.2e}")

    xs = x.cpu().numpy()
    err = np.linalg.norm(a.to_scipy() @ xs - b) / np.linalg.norm(b)
    print(f"check       : ||Ax-b||/||b|| = {err:.2e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
