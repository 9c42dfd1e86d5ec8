"""SpMV and SpMM benchmarks on the card: the port of
``sblas/bench_lib.py:bench_spmv`` and ``bench_spmm``.

The step is the plan's own ``Y = alpha A X + beta Y`` with ``alpha = 1e-30``,
``beta = 1`` and ``Y = X0``: it returns ``X0 + 1e-30 A X``, numerically
``X0``, yet each iteration reads the one before (the JAX package's carry,
``bench_lib.py:32``), and the fused epilogue does it without an extra pass.
Bytes follow the plan's model plus the ``Y`` it reads.

Beside the plan, the same step runs through ``torch.sparse_csr_tensor``
(cuSPARSE: ``addmv`` for SpMV, ``addmm`` for SpMM) as ``baseline``: a
measurement, never a route.
"""

from __future__ import annotations

import numpy as np
import torch

from .formats import CSR, as_torch_dtype
from .golden import rel_err, spmm_golden, spmv_golden, value_tol
from .ops.spmm import SpmmPlan
from .ops.spmv import SpmvPlan
from .utils.timing import (FP32_FLOPS, HBM_BYTES_PER_S, BenchRecord,
                           measure_seconds_per_iter, stream_bandwidth)

# keeps the carry numerically equal to x0 while each iteration depends on
# the one before (tiny * y underflows against x0)
EPS = 1e-30


def _cuda(device, what: str) -> torch.device:
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"{what} measures on a CUDA device; none here")
    return dev


def _validate(a: CSR, value_dtype, out, ref, extra: dict) -> None:
    vd = as_torch_dtype(a.dtype if value_dtype is None else value_dtype)
    extra["value_dtype"] = str(vd).removeprefix("torch.")
    tol = value_tol(vd)
    err = rel_err(out.cpu().numpy(), ref)
    extra["rel_err"] = err
    if not err < tol:
        raise RuntimeError(f"validation failed: rel_err {err} >= {tol}")


def _time(step, x0, nbytes: int, dev, ratio_pairs: int,
          extra: dict) -> float:
    """Seconds per iteration of ``step``; fills the STREAM fields of
    ``extra``. ``ratio_pairs=N`` (N > 1) takes the median of N back-to-back
    (kernel, fresh STREAM) ratio pairs, so that a drift of the card's clock
    cancels; otherwise one kernel sample against a STREAM measured once per
    process."""
    if ratio_pairs > 1:
        pairs = []
        for _ in range(ratio_pairs):
            per = measure_seconds_per_iter(step, x0, x0)
            sbw = stream_bandwidth(device=dev, fresh=True)
            pairs.append((nbytes / per / 1e9 / sbw, per, sbw))
        pairs.sort()
        _, per, sbw = pairs[len(pairs) // 2]
        extra["protocol"] = f"ratio-median-of-{ratio_pairs}"
        extra["ratio_pairs"] = [{"pct": 100 * r, "us": p * 1e6,
                                 "stream_gbps": s} for r, p, s in pairs]
    else:
        per = measure_seconds_per_iter(step, x0, x0)
        sbw = stream_bandwidth(device=dev)
    extra["stream_gbps"] = sbw
    extra["pct_stream"] = 100.0 * nbytes / per / 1e9 / sbw
    return per


def _cusparse(a: CSR, dev) -> torch.Tensor:
    return torch.sparse_csr_tensor(
        torch.from_numpy(a.indptr).to(dev), torch.from_numpy(a.indices).to(dev),
        torch.from_numpy(a.data).to(dev), size=a.shape)


def bench_spmv(a: CSR, *, method: str = "auto", value_dtype=None,
               ratio_pairs: int = 0, device=None,
               baseline: bool = True) -> BenchRecord:
    """One SpMV record on a CUDA device, validated against scipy first."""
    m, n = a.shape
    if m != n:
        raise ValueError("bench uses square matrices (carry feedback)")
    dev = _cuda(device, "bench_spmv")
    plan = SpmvPlan(a, method, value_dtype=value_dtype, device=dev)
    x0_np = np.random.default_rng(0).standard_normal(n).astype(a.dtype)
    x0 = torch.from_numpy(x0_np).to(dev)
    extra = {"method": plan.method, "route_reason": plan.route_reason,
             "nnz": a.nnz, "m": m, "dtype": str(np.dtype(a.dtype)),
             "device": torch.cuda.get_device_name(dev)}
    _validate(a, value_dtype, plan(x0), spmv_golden(a, x0_np), extra)
    nbytes = plan.bytes_per_iter + m * a.data.itemsize   # + y_in (beta != 0)
    per = _time(lambda x, x0: plan(x, EPS, 1.0, x0), x0, nbytes, dev,
                ratio_pairs, extra)
    if baseline:
        sp = _cusparse(a, dev)
        base = measure_seconds_per_iter(
            lambda x, x0: torch.addmv(x0, sp, x, beta=1.0, alpha=EPS),
            x0, x0)
        extra["baseline"] = "cusparse (torch.sparse_csr_tensor addmv)"
        extra["baseline_us"] = base * 1e6
        extra["speedup_vs_baseline"] = base / per
    return BenchRecord(name="spmv", seconds_per_iter=per, flops=2.0 * a.nnz,
                       bytes=nbytes, extra=extra)


def bench_spmm(a: CSR, k: int = 8, *, method: str = "auto", value_dtype=None,
               block_rows: int = 128, ratio_pairs: int = 0, device=None,
               baseline: bool = True) -> BenchRecord:
    """One SpMM record (``X`` of ``k`` columns) on a CUDA device, validated
    against scipy first.

    ``flops`` is the useful work, ``2 nnz k``; ``extra["bound_us"]`` the
    least time the card could take for the plan's work: its bytes over the
    card's data-sheet memory rate (``HBM_BYTES_PER_S``), or the flops it
    executes (every stored block entry for the block routes) over its fp32
    rate (``FP32_FLOPS``), whichever is larger.
    """
    m, n = a.shape
    if m != n:
        raise ValueError("bench uses square matrices (carry feedback)")
    dev = _cuda(device, "bench_spmm")
    plan = SpmmPlan(a, method, k_hint=k, value_dtype=value_dtype,
                    block_rows=block_rows, device=dev)
    x0_np = np.random.default_rng(0).standard_normal((n, k)).astype(a.dtype)
    x0 = torch.from_numpy(x0_np).to(dev)
    extra = {"method": plan.method, "route_reason": plan.route_reason,
             "nnz": a.nnz, "m": m, "k": k, "dtype": str(np.dtype(a.dtype)),
             "device": torch.cuda.get_device_name(dev)}
    _validate(a, value_dtype, plan(x0), spmm_golden(a, x0_np), extra)
    nbytes = plan.bytes_per_call(k, with_y=True)
    per = _time(lambda x, x0: plan(x, EPS, 1.0, x0), x0, nbytes, dev,
                ratio_pairs, extra)
    bytes_s = nbytes / HBM_BYTES_PER_S
    flops_s = plan.flops_per_call(k) / FP32_FLOPS
    extra["bound_us"] = max(bytes_s, flops_s) * 1e6
    extra["bound_by"] = "bytes" if bytes_s >= flops_s else "operations"
    if baseline:
        sp = _cusparse(a, dev)
        base = measure_seconds_per_iter(
            lambda x, x0: torch.addmm(x0, sp, x, beta=1.0, alpha=EPS),
            x0, x0)
        extra["baseline"] = "cusparse (torch.sparse_csr_tensor addmm)"
        extra["baseline_us"] = base * 1e6
        extra["speedup_vs_baseline"] = base / per
    return BenchRecord(name=f"spmm_k{k}", seconds_per_iter=per,
                       flops=2.0 * a.nnz * k, bytes=nbytes, extra=extra)
