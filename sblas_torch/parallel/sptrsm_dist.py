"""Distributed triangular solve of K right-hand sides: the port of
``sblas/parallel/sptrsm_dist.py`` (``DistSptrsmPlan``, ``dist_sptrsm``).

It shares :class:`~.sptrsv_dist.DistSptrsvPlan`'s plan (``_sv``: the tile
dealing, the level batches, each rank's ``D`` blocks and exchange index)
and runs the K columns together, batch by batch: ``E @ X`` through the
port's SpMM plan on each batch's ``E`` (``merge``: the nnz-balanced kernel,
any K, f32 and f64), the sync-free kernel on ``D`` at K columns (in
register chunks of up to 16 columns, 8 in f64, one launch), and one
``all_gather`` of a ``(rows, K)`` slab a batch. The reference runs K
one-column solves under ``lax.map`` and names the slab exchange as its next
step; the result is the same function.
"""

from __future__ import annotations

import torch

from ..ops.spmm import SpmmPlan
from .mesh import Mesh
from .sptrsv_dist import DistSptrsvPlan


class DistSptrsmPlan:
    """K-RHS distributed triangular solve sharing DistSptrsvPlan's plan
    (the same keywords)."""

    def __init__(self, l, mesh: Mesh | None = None, **kw):
        self._sv = sv = DistSptrsvPlan(l, mesh, **kw)
        for name in ("shape", "dtype", "mesh", "device", "ndev", "lower",
                     "unit_diagonal", "nlevels", "nbatches", "local_method",
                     "routes"):
            setattr(self, name, getattr(sv, name))
        self._spmm = [None if e is None else
                      SpmmPlan(e, "merge", device=self.device)
                      for e in sv._e_host]
        self.step_methods = ["syncfree"] + (
            ["merge"] if any(p is not None for p in self._spmm) else [])

    def __repr__(self):
        return f"DistSptrsmPlan({self._sv!r})"

    def __call__(self, b):
        n = self.shape[0]
        b = torch.as_tensor(b, dtype=self.dtype, device=self.device)
        if b.dim() != 2 or b.shape[0] != n:
            raise ValueError(f"B must have shape ({n}, k), got "
                             f"{tuple(b.shape)}")
        return self._sv.solve(b.contiguous(), self._spmm)


def dist_sptrsm(l, b, mesh: Mesh | None = None, **kw):
    """One-shot distributed K-RHS triangular solve (the
    :class:`DistSptrsvPlan` keywords)."""
    return DistSptrsmPlan(l, mesh, **kw)(b)
