"""sblas_torch: the PyTorch/CUDA port of sblas, for one NVIDIA H100.

    A = sblas_torch.datasets.emulate("cant")    # a host CSR of the port
    y = sblas_torch.spmv(A, x, alpha=1.0, beta=0.0, y=None)
    Y = sblas_torch.spmm(A, X, k_hint=X.shape[1])
    x = sblas_torch.sptrsv(L, b, lower=True, trans=False)
    X = sblas_torch.sptrsm(L, B)
    x, info = sblas_torch.solvers.cg(A, b, M=sblas_torch.solvers.ichol(A))

The host layer (formats, Matrix Market I/O, dataset generators, scipy
goldens, ELL and block retiling) is the port's own: copies of the JAX
package's modules, which the port never imports.
``sblas_torch.from_reference`` turns a matrix of the JAX package into the
port's. The entry points run on the CUDA card unless the caller passes
``device="cpu"``, and raise where torch sees no card. The operations load
lazily, so ``import sblas_torch`` works on CPU-only torch with no
``nvcc``; the CUDA kernels are built on their first launch
(``sblas_torch.ops.kernels._build``).
"""

from . import (datasets, golden, levels, relabel, reorder, retile,
               retile_bsr, sptrsv_schedule)
from .formats import (COO, CSC, CSR, coo_to_csc, coo_to_csr, csr_transpose,
                      from_reference, to_device, tril, triu)
from .io import read_mtx, read_mtx_coo, write_mtx

__version__ = "0.1.0"

__all__ = [
    "COO", "CSR", "CSC",
    "coo_to_csr", "coo_to_csc", "csr_transpose", "tril", "triu",
    "from_reference", "read_mtx", "read_mtx_coo", "write_mtx",
    "datasets", "golden", "levels", "relabel", "reorder", "retile",
    "retile_bsr", "sptrsv_schedule", "to_device",
    "spmv", "SpmvPlan", "spmm", "SpmmPlan",
    "sptrsv", "SptrsvPlan", "sptrsm", "SptrsmPlan", "solvers",
]

_LAZY = {"spmv": ".ops.spmv", "SpmvPlan": ".ops.spmv",
         "spmm": ".ops.spmm", "SpmmPlan": ".ops.spmm",
         "sptrsv": ".ops.sptrsv", "SptrsvPlan": ".ops.sptrsv",
         "sptrsm": ".ops.sptrsm", "SptrsmPlan": ".ops.sptrsm"}


def __getattr__(name):
    # lazy: the plans pull in the kernel wrappers
    import importlib

    if name == "solvers":
        return importlib.import_module(".solvers", __name__)
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(f"module 'sblas_torch' has no attribute {name!r}")
