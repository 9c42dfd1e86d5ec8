"""Scipy goldens and the port's tolerances, in one place.

The goldens are the JAX package's own (``sblas.golden`` imports no JAX),
re-exported so that callers of the port name only ``sblas_torch``. The
limits the port is held to are defined here once and imported by the
benchmark, ``chip_smoke.py`` and the tests.
"""

from __future__ import annotations

import numpy as np
import torch
from sblas.golden import (default_tol, rel_err, spmm_golden, spmv_golden,
                          sptrsm_golden, sptrsv_golden)

from .formats import as_torch_dtype

__all__ = ["KERNEL_TOL", "default_tol", "rel_err", "spmm_golden",
           "spmv_golden", "sptrsm_golden", "sptrsv_golden", "value_tol"]

# a CUDA kernel against its plain torch version: the same f32 products,
# summed in another order
KERNEL_TOL = 2e-5


def value_tol(value_dtype) -> float:
    """``default_tol`` for the dtype a matrix's values are stored in, torch's
    bf16 included (numpy names bf16 only through ml_dtypes, and
    ``default_tol`` gives its bf16 limit to any dtype but f32 and f64)."""
    vd = as_torch_dtype(value_dtype)
    return default_tol({torch.float64: np.float64,
                        torch.float32: np.float32}.get(vd, np.float16))
