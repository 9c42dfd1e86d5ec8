"""Iterative (Jacobi-sweep / truncated-Neumann) triangular solve, the port of
``sblas/ops/sptrsv_iter.py``.

Solve ``L x = b`` with the split ``L = D + E`` (``D`` the diagonal, ``E``
the strictly triangular part) by the Jacobi recurrence

    x_0     = D^{-1} b
    x_{k+1} = D^{-1} (b - E x_k)

``D^{-1}E`` is strictly triangular, hence nilpotent with index at most the
dependency depth (the level count), so the sweep is exact after
``nlevels - 1`` applications, and preconditioners can stop far earlier.
Each sweep is one product with ``E`` through the port's own plans: an
``SpmvPlan`` (single right-hand side; ``'auto'`` runs the csr or the
nnz-balanced kernel) or an ``SpmmPlan`` (``(n, K)``, one call for all K),
with ``b - E x`` in the plan's fused epilogue (``alpha = -1, beta = 1,
y = b``).

``sweeps=None`` is the exact count; fewer sweeps give the truncated solve,
whose error ``(-D^{-1}E)^k e_0`` can grow before it vanishes on an
ill-conditioned factor, so truncation is the caller's choice.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats import CSR, as_torch_dtype, tril, triu, upload
from ..levels import level_schedule
from ..sptrsv_schedule import diagonal
from ..utils.backend import default_device


def split_diag(l: CSR, lower: bool, unit_diagonal: bool):
    """(strict part E as CSR, inv_diag vector) of a triangular matrix.
    Raises ``ValueError`` for a missing or zero diagonal entry."""
    strict = tril(l, -1) if lower else triu(l, 1)
    return strict, (1.0 / diagonal(l, unit_diagonal)).astype(l.dtype)


class _JacobiBase:
    """What the single- and multi-RHS plans share: the split, the level
    count and the sweep loop over the inner plan ``self._e``."""

    def _analyse(self, l, lower: bool, unit_diagonal: bool,
                 sweeps: int | None, device) -> CSR:
        """Set the shared attributes; return the strict part ``E``."""
        from .common import as_csr

        l = as_csr(l)
        if l.shape[0] != l.shape[1]:
            raise ValueError(f"sptrsv needs a square matrix, got {l.shape}")
        self.shape = l.shape
        self.dtype = as_torch_dtype(l.dtype)
        self.lower = lower
        self.unit_diagonal = unit_diagonal
        self.device = torch.device(device) if device is not None \
            else default_device()
        strict, inv_d = split_diag(l, lower, unit_diagonal)
        _, self.nlevels = level_schedule(l.indptr, l.indices, l.shape[0],
                                         lower=lower)
        self.sweeps = max(self.nlevels - 1, 0) if sweeps is None else sweeps
        self._inv_d = upload(inv_d, self.device)
        return strict

    def _sweep(self, b: torch.Tensor, inv_d: torch.Tensor) -> torch.Tensor:
        x = inv_d * b
        if self._e is None:
            return x
        for _ in range(self.sweeps):
            x = inv_d * self._e(x, -1.0, 1.0, b)
        return x


class SptrsvJacobiPlan(_JacobiBase):
    """Jacobi-sweep triangular solve plan (single RHS).

    ``sweeps=None`` -> exact (``nlevels - 1``). ``spmv_method`` and the
    other keywords go to the inner :class:`~sblas_torch.ops.spmv.SpmvPlan`
    on ``E``.
    """

    def __init__(self, l, *, lower: bool = True,
                 unit_diagonal: bool = False, sweeps: int | None = None,
                 spmv_method: str = "auto", device=None, **spmv_kw):
        from .spmv import SpmvPlan

        strict = self._analyse(l, lower, unit_diagonal, sweeps, device)
        self._e = (SpmvPlan(strict, spmv_method, device=self.device,
                            **spmv_kw) if strict.nnz else None)
        self.method = ("jacobi+" + self._e.method) if self._e \
            else "jacobi+diag"
        # bytes per solve: sweeps E streams + per-sweep x/b/invd traffic
        per_sweep = (self._e.bytes_per_iter if self._e else 0) \
            + 3 * self.shape[0] * np.dtype(strict.dtype).itemsize
        self.bytes_per_iter = max(self.sweeps, 1) * per_sweep

    def __call__(self, b):
        n = self.shape[0]
        b = torch.as_tensor(b, dtype=self.dtype, device=self.device)
        if b.shape != (n,):
            raise ValueError(f"b must have shape ({n},), got {tuple(b.shape)}")
        return self._sweep(b, self._inv_d)


class SptrsmJacobiPlan(_JacobiBase):
    """Jacobi-sweep triangular solve plan for ``(n, K)`` right-hand sides:
    one SpMM a sweep serves all K columns. ``spmm_method`` and the other
    keywords go to the inner :class:`~sblas_torch.ops.spmm.SpmmPlan`."""

    def __init__(self, l, *, lower: bool = True,
                 unit_diagonal: bool = False, sweeps: int | None = None,
                 spmm_method: str = "auto", device=None, **spmm_kw):
        from .spmm import SpmmPlan

        strict = self._analyse(l, lower, unit_diagonal, sweeps, device)
        self._e = (SpmmPlan(strict, spmm_method, device=self.device,
                            **spmm_kw) if strict.nnz else None)
        self.method = ("jacobi+" + self._e.method) if self._e \
            else "jacobi+diag"

    def __call__(self, b):
        n = self.shape[0]
        b = torch.as_tensor(b, dtype=self.dtype, device=self.device)
        if b.dim() != 2 or b.shape[0] != n:
            raise ValueError(f"B must have shape ({n}, k), got "
                             f"{tuple(b.shape)}")
        return self._sweep(b, self._inv_d[:, None])
