"""sblas_torch: the PyTorch/CUDA port of sblas, for one NVIDIA H100.

    A = sblas_torch.datasets.emulate("cant")    # host CSR, shared with sblas
    y = sblas_torch.spmv(A, x, alpha=1.0, beta=0.0, y=None)

The host layer (formats, Matrix Market I/O, dataset generators, scipy
goldens, ELL retiling) is the JAX package's own, reused as it is: those
modules do not import JAX. ``sblas_torch.golden`` re-exports the goldens
beside the port's tolerances. The operations load lazily, so ``import
sblas_torch`` works on CPU-only torch with no ``nvcc``; the CUDA kernels are
built on their first launch (``sblas_torch.ops.kernels._build``).
"""

from sblas import datasets, retile
from sblas.formats import (COO, CSC, CSR, coo_to_csc, coo_to_csr,
                           csr_transpose, tril, triu)
from sblas.io import read_mtx, read_mtx_coo, write_mtx

from . import golden
from .formats import to_device

__version__ = "0.1.0"

__all__ = [
    "COO", "CSR", "CSC",
    "coo_to_csr", "coo_to_csc", "csr_transpose", "tril", "triu",
    "read_mtx", "read_mtx_coo", "write_mtx",
    "datasets", "golden", "retile", "to_device",
    "spmv", "SpmvPlan",
]


def __getattr__(name):
    # lazy: the plans pull in the kernel wrappers
    if name in ("spmv", "SpmvPlan"):
        import importlib

        return getattr(importlib.import_module(".ops.spmv", __name__), name)
    raise AttributeError(f"module 'sblas_torch' has no attribute {name!r}")
