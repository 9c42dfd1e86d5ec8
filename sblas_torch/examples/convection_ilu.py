"""ILU(0)-preconditioned GMRES on a convection-diffusion problem: the
counterpart of ``examples/convection_ilu.py``.

The nonsymmetric counterpart of :mod:`.cg`: an upwind-discretized
convection-diffusion operator (-eps*lap(u) + b . grad(u)) is far from
symmetric, so CG does not apply; restarted GMRES stalls when convection
dominates (small eps), and ILU(0), incomplete LU on the matrix's own
sparsity pattern applied as one forward and one backward triangular solve
per iteration, is the classic rescue (``sblas_torch.solvers.ilu``: the
factorization on the host, the solves on the card's sync-free kernel).

Run:  python -m sblas_torch.examples.convection_ilu [nx] [eps] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import solvers
from ..datasets import convection_diffusion
from ..utils.backend import pick_device

__all__ = ["convection_diffusion", "solve", "main"]


def solve(nx: int = 64, eps: float = 0.01, device=None):
    """GMRES(30) to 1e-6 on the f32 operator, plain and with ILU(0):
    ``(a, b, (x0, info0), (x1, info1))``."""
    a = convection_diffusion(nx, eps, dtype=np.float32)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(a.shape[0]).astype(np.float32)

    x0, plain = solvers.gmres(a, b, tol=1e-6, maxiter=2000, restart=30,
                              device=device)
    x1, pre = solvers.gmres(a, b, tol=1e-6, maxiter=2000, restart=30,
                            M=solvers.ilu(a, device=device), device=device)
    return a, b, (x0, plain), (x1, pre)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("nx", nargs="?", type=int, default=64)
    ap.add_argument("eps", nargs="?", type=float, default=0.01)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    a, b, (x0, plain), (x1, pre) = solve(args.nx, args.eps,
                                         pick_device(args.device))
    for tag, x, info in (("gmres", x0, plain), ("ilu0+gmres", x1, pre)):
        err = (np.linalg.norm(a.to_scipy() @ x.cpu().numpy() - b)
               / np.linalg.norm(b))
        print(f"{tag:>12}: {info['iterations']:5d} matvecs, "
              f"rel_residual {info['rel_residual']:.2e}, "
              f"true rel err {err:.2e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
