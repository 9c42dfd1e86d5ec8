"""SpTRSM: solve op(L) X = B for K right-hand sides (B is (n, K)), the port
of ``sblas/ops/sptrsm.py``.

A :class:`SptrsmPlan` holds the :class:`~sblas_torch.ops.sptrsv.SptrsvPlan`
of the same matrix and keywords (from the shared plan cache, so ``sptrsv``
and ``sptrsm`` of one factor upload it once) and solves all K columns in
one call of its route:

- ``'syncfree'`` (``'pallas'`` names it; ``'auto'`` for f32 and f64;
  ``'pallas_ds'`` names its f64 build): the sync-free kernel, K columns a
  launch, in register chunks of up to 16 columns (8 in f64); one flag a row
  covers all K. The JAX package's ``'pallas_ds'`` splits K into solves of 8 columns;
  here any K takes one launch.
- ``'tiles'``: the torch tile scan over an ``(n, K)`` buffer, each tile's
  gathers shared by the K columns, any value dtype.
- ``'jacobi'``, through :func:`sptrsm`: the Jacobi-sweep plan of
  :mod:`sblas_torch.ops.sptrsv_iter`, one SpMM a sweep.

A launch that fails raises; no narrower chunk and no other route is tried.
"""

from __future__ import annotations

import torch

from .spmv import _PLAN_CACHE
from .sptrsv import get_plan, syncfree_bytes


class SptrsmPlan:
    """Multi-RHS triangular-solve executor sharing SpTRSV's analysis."""

    def __init__(self, l, *, lower: bool = True, unit_diagonal: bool = False,
                 method: str = "auto", **kw):
        from .common import as_csr

        if method == "jacobi":
            raise ValueError("the Jacobi solve is SptrsmJacobiPlan "
                             "(sptrsm(..., method='jacobi'))")
        self._sv = get_plan(as_csr(l), lower=lower,
                            unit_diagonal=unit_diagonal, method=method, **kw)
        for name in ("shape", "nnz", "dtype", "lower", "unit_diagonal",
                     "device", "method", "nlevels", "route_reason"):
            setattr(self, name, getattr(self._sv, name))

    def bytes_per_iter(self, k: int) -> int:
        """Traffic model for one K-column solve: the matrix stream once, B
        and X K-fold (and, sync-free, a flag a row)."""
        n = self.shape[0]
        if self.method == "syncfree":
            return syncfree_bytes(n, self.nnz, k, self.dtype.itemsize)
        es = self.dtype.itemsize
        return self._sv.bytes_per_iter + n * 2 * es * (k - 1)

    def __repr__(self):
        return f"SptrsmPlan({self._sv!r})"

    def __call__(self, b):
        n = self.shape[0]
        b = torch.as_tensor(b, dtype=self.dtype, device=self.device)
        if b.dim() != 2 or b.shape[0] != n:
            raise ValueError(f"B must have shape ({n}, k), got "
                             f"{tuple(b.shape)}")
        return self._sv.solve(b)


def sptrsm(l, b, *, lower: bool = True, unit_diagonal: bool = False,
           trans: bool = False, method: str = "auto", **kw):
    """Solve op(L) X = B for (n, k) B, op = L^T if trans else L.

    ``l`` may be CSR or CSC; the analysis is cached per derived matrix and
    shared with :func:`~sblas_torch.ops.sptrsv.sptrsv` and across RHS
    widths. ``kw`` as for ``sptrsv`` (``'jacobi'``: ``sweeps=``,
    ``spmm_method=`` and the SpMM plan's keywords).
    """
    from .common import as_csr

    l = as_csr(l, trans)
    if trans:
        lower = not lower
    plans = _PLAN_CACHE.setdefault(l, {})
    key = ("sptrsm", lower, unit_diagonal, method, tuple(sorted(kw.items())))
    if key not in plans:
        if method == "jacobi":
            from .sptrsv_iter import SptrsmJacobiPlan

            plans[key] = SptrsmJacobiPlan(
                l, lower=lower, unit_diagonal=unit_diagonal, **kw)
        else:
            plans[key] = SptrsmPlan(l, lower=lower,
                                    unit_diagonal=unit_diagonal,
                                    method=method, **kw)
    return plans[key](b)
