"""The yardstick of a kernel's roofline share: published peaks of one
NVIDIA H100 SXM and the bytes and flops an operation needs, counted from
its operands alone, the same whatever route or kernel runs it.

Bytes: the matrix's values, its int32 column indices and its int32
``indptr`` once; X read once and Y written once (K columns each), Y read
too where beta != 0. A triangular solve: L once, b in and x out, no
scratch of any kernel's own. Flops: a multiply and an add a stored
nonzero and column. The least time is the larger of bytes over
``HBM_BYTES_PER_S`` and flops over the dtype's peak.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, at the full 700 W: HBM3 rate, and FP32 and
# FP64 rates outside the tensor cores (the kernels run on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
FP64_FLOPS = 34e12


def peak_flops(dtype: torch.dtype) -> float:
    """The peak for work done in ``dtype`` (bf16 values are summed in
    f32)."""
    return FP64_FLOPS if dtype == torch.float64 else FP32_FLOPS


def csr_stream_bytes(m: int, nnz: int, val_bytes: int) -> int:
    """One pass over a CSR matrix: each nonzero's value and int32 column,
    and ``indptr``."""
    return nnz * (val_bytes + 4) + (m + 1) * 4


def spmm_bytes(m: int, n: int, nnz: int, k: int, val_bytes: int,
               vec_bytes: int, beta: bool) -> int:
    """``Y = alpha A X + beta Y`` with X of shape ``(n, k)``."""
    ys = 2 if beta else 1
    return csr_stream_bytes(m, nnz, val_bytes) + (n + ys * m) * k * vec_bytes


def sptrsv_bytes(n: int, nnz: int, k: int, val_bytes: int,
                 vec_bytes: int) -> int:
    """``x = L^-1 b`` with ``k`` columns."""
    return csr_stream_bytes(n, nnz, val_bytes) + 2 * n * k * vec_bytes


def flops(nnz: int, k: int) -> int:
    return 2 * nnz * k


def least_seconds(nbytes: int, nflops: int, dtype: torch.dtype) -> float:
    """The larger of the bytes' time at ``HBM_BYTES_PER_S`` and the flops'
    at the dtype's peak."""
    return max(nbytes / HBM_BYTES_PER_S, nflops / peak_flops(dtype))


def share_pct(rec: dict, range_name: str):
    """The least time of the calls inside the ranges named ``range_name``
    over the device time of the operations launched in them, in percent,
    from a run's record (``portbench/metrics/__init__.py``); None where
    the trace holds no such range."""
    tr = rec["trace"]
    device_s = tr["device_s"].get(range_name, 0.0) if tr else 0.0
    least = rec["spans"]["least_s"].get(range_name, 0.0)
    if device_s <= 0.0 or least <= 0.0:
        return None
    return 100.0 * least / device_s
