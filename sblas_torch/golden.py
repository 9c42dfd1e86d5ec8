"""Scipy goldens and the port's tolerances, in one place.

The goldens compute in float64 through scipy. The limits the port is held
to are defined here once and imported by the benchmark, ``chip_smoke.py``
and the tests.
"""

from __future__ import annotations

import numpy as np
import torch

from .formats import CSR, as_torch_dtype

__all__ = ["KERNEL_TOL", "default_tol", "rel_err", "spmm_golden",
           "spmv_golden", "sptrsm_golden", "sptrsv_golden", "value_tol"]

# a CUDA kernel against its plain torch version: the same f32 products,
# summed in another order
KERNEL_TOL = 2e-5


def spmv_golden(a: CSR, x, alpha: float = 1.0, beta: float = 0.0, y=None):
    """y_out = alpha * A @ x + beta * y (dense x, CSR A), in float64, cast
    back to x's dtype (f32 or f64; float64 otherwise)."""
    x = np.asarray(x)
    out = alpha * (a.to_scipy() @ x.astype(np.float64))
    if beta != 0.0:
        if y is None:
            raise ValueError("beta != 0 requires y")
        out = out + beta * np.asarray(y, dtype=np.float64)
    return out.astype(x.dtype if x.dtype in (np.float32, np.float64)
                      else np.float64)


def spmm_golden(a: CSR, x, alpha: float = 1.0, beta: float = 0.0, y=None):
    """Y_out = alpha * A @ X + beta * Y (row-major dense X of shape (n, k))."""
    return spmv_golden(a, x, alpha, beta, y)


def sptrsv_golden(l: CSR, b, *, lower: bool = True,
                  unit_diagonal: bool = False):
    """Triangular solve L x = b through scipy, in float64."""
    from scipy.sparse.linalg import spsolve_triangular

    x = spsolve_triangular(l.to_scipy().astype(np.float64).tocsr(),
                           np.asarray(b, dtype=np.float64), lower=lower,
                           unit_diagonal=unit_diagonal)
    return x.astype(np.asarray(b).dtype)


def sptrsm_golden(l: CSR, b, *, lower: bool = True,
                  unit_diagonal: bool = False):
    """Multi-RHS triangular solve L X = B, B of shape (n, k), via scipy."""
    return sptrsv_golden(l, b, lower=lower, unit_diagonal=unit_diagonal)


def rel_err(approx, exact) -> float:
    """||approx - exact||_inf / max(||exact||_inf, tiny)."""
    approx = np.asarray(approx, dtype=np.float64)
    exact = np.asarray(exact, dtype=np.float64)
    denom = max(float(np.max(np.abs(exact), initial=0.0)), 1e-30)
    return float(np.max(np.abs(approx - exact), initial=0.0)) / denom


def default_tol(dtype) -> float:
    """Validation limit per dtype: loose enough for sums taken in another
    order over long rows, tight enough to catch an indexing fault."""
    dtype = np.dtype(dtype)
    if dtype == np.float64:
        return 1e-11
    if dtype == np.float32:
        return 2e-5
    return 2e-2  # bf16


def value_tol(value_dtype) -> float:
    """``default_tol`` for the dtype a matrix's values are stored in, torch's
    bf16 included (numpy names bf16 only through ml_dtypes, and
    ``default_tol`` gives its bf16 limit to any dtype but f32 and f64)."""
    vd = as_torch_dtype(value_dtype)
    return default_tol({torch.float64: np.float64,
                        torch.float32: np.float32}.get(vd, np.float16))
