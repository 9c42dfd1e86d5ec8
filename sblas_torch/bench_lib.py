"""SpMV benchmark on the card: the port of ``sblas/bench_lib.py:bench_spmv``.

The step is the plan's own ``y = alpha A x + beta y`` with ``alpha = 1e-30``,
``beta = 1`` and ``y = x0``: it returns ``x0 + 1e-30 A x``, numerically
``x0``, yet each iteration reads the one before (the JAX package's carry,
``bench_lib.py:32``), and the fused epilogue does it without an extra pass.
Bytes follow the plan's model plus the ``m`` values of ``y`` it reads.

Beside the plan, the same step runs through ``torch.sparse_csr_tensor``
(cuSPARSE) as ``baseline``: a measurement, never a route.
"""

from __future__ import annotations

import numpy as np
import torch

from sblas.formats import CSR

from .formats import as_torch_dtype
from .golden import rel_err, spmv_golden, value_tol
from .ops.spmv import SpmvPlan
from .utils.timing import (BenchRecord, measure_seconds_per_iter,
                           stream_bandwidth)

# keeps the carry numerically equal to x0 while each iteration depends on
# the one before (tiny * y underflows against x0)
EPS = 1e-30


def bench_spmv(a: CSR, *, method: str = "auto", value_dtype=None,
               ratio_pairs: int = 0, device=None,
               baseline: bool = True) -> BenchRecord:
    """One SpMV record on a CUDA device, validated against scipy first.

    ``ratio_pairs=N`` (N > 1) reports the median of N back-to-back (kernel,
    fresh STREAM) ratio pairs, so that a drift of the card's clock cancels;
    otherwise one kernel sample against a STREAM measured once per process.
    """
    m, n = a.shape
    if m != n:
        raise ValueError("bench uses square matrices (carry feedback)")
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("bench_spmv measures on a CUDA device; none here")
    plan = SpmvPlan(a, method, value_dtype=value_dtype, device=dev)
    x0_np = np.random.default_rng(0).standard_normal(n).astype(a.dtype)
    x0 = torch.from_numpy(x0_np).to(dev)
    extra = {"method": plan.method, "route_reason": plan.route_reason,
             "nnz": a.nnz, "m": m, "dtype": str(np.dtype(a.dtype)),
             "device": torch.cuda.get_device_name(dev)}
    vd = as_torch_dtype(a.dtype if value_dtype is None else value_dtype)
    extra["value_dtype"] = str(vd).removeprefix("torch.")
    tol = value_tol(vd)
    err = rel_err(plan(x0).cpu().numpy(), spmv_golden(a, x0_np))
    extra["rel_err"] = err
    if not err < tol:
        raise RuntimeError(f"validation failed: rel_err {err} >= {tol}")

    def step(x, x0):
        return plan(x, EPS, 1.0, x0)

    def kernel_seconds():
        return measure_seconds_per_iter(step, x0, x0)

    nbytes = plan.bytes_per_iter + m * a.data.itemsize   # + y_in (beta != 0)
    if ratio_pairs > 1:
        pairs = []
        for _ in range(ratio_pairs):
            per = kernel_seconds()
            sbw = stream_bandwidth(device=dev, fresh=True)
            pairs.append((nbytes / per / 1e9 / sbw, per, sbw))
        pairs.sort()
        ratio, per, sbw = pairs[len(pairs) // 2]
        extra["protocol"] = f"ratio-median-of-{ratio_pairs}"
        extra["ratio_pairs"] = [{"pct": 100 * r, "us": p * 1e6,
                                 "stream_gbps": s} for r, p, s in pairs]
    else:
        per = kernel_seconds()
        sbw = stream_bandwidth(device=dev)
    extra["stream_gbps"] = sbw
    extra["pct_stream"] = 100.0 * nbytes / per / 1e9 / sbw

    if baseline:
        sp = torch.sparse_csr_tensor(
            torch.from_numpy(a.indptr).to(dev),
            torch.from_numpy(a.indices).to(dev),
            torch.from_numpy(a.data).to(dev), size=(m, n))
        base = measure_seconds_per_iter(
            lambda x, x0: torch.addmv(x0, sp, x, beta=1.0, alpha=EPS),
            x0, x0)
        extra["baseline"] = "cusparse (torch.sparse_csr_tensor addmv)"
        extra["baseline_us"] = base * 1e6
        extra["speedup_vs_baseline"] = base / per
    return BenchRecord(name="spmv", seconds_per_iter=per, flops=2.0 * a.nnz,
                       bytes=nbytes, extra=extra)
