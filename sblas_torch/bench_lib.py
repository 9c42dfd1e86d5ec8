"""SpMV, SpMM, triangular-solve and solver benchmarks on the card: the port
of ``sblas/bench_lib.py:bench_spmv``, ``bench_spmm``, ``bench_sptrsv`` and
``bench_sptrsm``, and :func:`bench_solver`.

The step is the plan's own ``Y = alpha A X + beta Y`` with ``alpha = 1e-30``,
``beta = 1`` and ``Y = X0``: it returns ``X0 + 1e-30 A X``, numerically
``X0``, yet each iteration reads the one before (the JAX package's carry,
``bench_lib.py:32``), and the fused epilogue does it without an extra pass.
Bytes follow the plan's model plus the ``Y`` it reads.

The solves time ``x <- solve(b0 + 1e-30 x)`` the same way. Their bytes
count each nonzero's value and column, ``indptr``, ``b``, ``x`` and a flag
a row once (``SptrsvPlan.bytes_per_iter``); beside the time they report
levels per second and ns per level: a solve is a chain of dependent levels,
and its time is set by their latency more than by its bytes.

Beside the plan, the same step runs through ``torch.sparse_csr_tensor``
(cuSPARSE: ``addmv`` for SpMV, ``addmm`` for SpMM, ``triangular_solve`` for
the solves) as ``baseline``: a measurement, never a route. Operation bounds
take the card's rate for the type the work is done in (``peak_flops``: fp64
for f64, fp32 otherwise).

Every bench runs on the card unless the caller passes ``device="cpu"``. On
the CPU it validates against scipy as on the card, times the plain
versions on the host clock (``measure_host_seconds``, ``extra["timer"] =
"host"``), and leaves out what only the card has: STREAM, the bound and
the cuSPARSE baseline. ``iters=N`` times between ``N // 5`` and ``N``
iterations (the JAX package's ``iters``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .formats import CSR, as_torch_dtype
from .golden import (rel_err, spmm_golden, spmv_golden, sptrsv_golden,
                     value_tol)
from .ops.kernels import spmm_bsr, spmm_csr, spmv_csr, sptrsv_csr
from .ops.spmm import SpmmPlan
from .ops.spmv import SpmvPlan
from .ops.sptrsm import SptrsmPlan
from .ops.sptrsv import get_plan as sptrsv_plan
from .utils.timing import (HBM_BYTES_PER_S, BenchRecord,
                           measure_eager_seconds, measure_host_seconds,
                           measure_seconds_per_iter, peak_flops,
                           stream_bandwidth)

# keeps the carry numerically equal to x0 while each iteration depends on
# the one before (tiny * y underflows against x0)
EPS = 1e-30
# an exact solve against scipy: the JAX package's limits
# (sblas/bench_lib.py:391)
SOLVE_TOL = {np.dtype(np.float32): 1e-3, np.dtype(np.float64): 1e-10}


def _device(device, what: str) -> torch.device:
    """``cuda`` unless the caller names the CPU; raises where the card it
    asks for is not there."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"{what} measures on a CUDA device; none here")
    return dev


def device_name(dev: torch.device) -> str:
    """The card's name, or ``cpu``."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _measure(dev, step, x0, *args, extra: dict, iters=None,
             lo: int = 5, hi: int = 25, **kw) -> float:
    """Marginal seconds per iteration of ``step``: CUDA graphs on the card,
    the host clock on the CPU (noted in ``extra["timer"]``); between ``lo``
    and ``hi`` iterations, or ``iters // 5`` and ``iters``."""
    if iters is not None:
        lo, hi = max(iters // 5, 1), iters
    if dev.type == "cuda":
        return measure_seconds_per_iter(step, x0, *args, iters_lo=lo,
                                        iters_hi=hi, **kw)
    extra["timer"] = "host"
    return measure_host_seconds(step, x0, *args, iters_lo=lo, iters_hi=hi,
                                **kw)


def _bound(extra: dict, nbytes: float, flops: float, dtype) -> None:
    """The card's least time for the work: its bytes over the data-sheet
    memory rate or its flops over the rate for ``dtype``, the larger."""
    bytes_s = nbytes / HBM_BYTES_PER_S
    flops_s = flops / peak_flops(dtype)
    extra["bound_us"] = max(bytes_s, flops_s) * 1e6
    extra["bound_by"] = "bytes" if bytes_s >= flops_s else "operations"


def _validate(a: CSR, value_dtype, out, ref, extra: dict,
              validate: bool = True) -> None:
    vd = as_torch_dtype(a.dtype if value_dtype is None else value_dtype)
    extra["value_dtype"] = str(vd).removeprefix("torch.")
    if not validate:
        return
    tol = value_tol(vd)
    err = rel_err(out.cpu().numpy(), ref)
    extra["rel_err"] = err
    if not err < tol:
        raise RuntimeError(f"validation failed: rel_err {err} >= {tol}")


def _time(step, x0, nbytes: int, dev, ratio_pairs: int, extra: dict,
          iters=None) -> float:
    """Seconds per iteration of ``step``; on the card fills the STREAM
    fields of ``extra``. ``ratio_pairs=N`` (N > 1) takes the median of N
    back-to-back (kernel, fresh STREAM) ratio pairs, so that a drift of the
    card's clock cancels; otherwise one kernel sample against a STREAM
    measured once per process."""
    if dev.type != "cuda":
        return _measure(dev, step, x0, x0, extra=extra, iters=iters)
    if ratio_pairs > 1:
        pairs = []
        for _ in range(ratio_pairs):
            per = _measure(dev, step, x0, x0, extra=extra, iters=iters)
            sbw = stream_bandwidth(device=dev, fresh=True)
            pairs.append((nbytes / per / 1e9 / sbw, per, sbw))
        pairs.sort()
        _, per, sbw = pairs[len(pairs) // 2]
        extra["protocol"] = f"ratio-median-of-{ratio_pairs}"
        extra["ratio_pairs"] = [{"pct": 100 * r, "us": p * 1e6,
                                 "stream_gbps": s} for r, p, s in pairs]
    else:
        per = _measure(dev, step, x0, x0, extra=extra, iters=iters)
        sbw = stream_bandwidth(device=dev)
    extra["stream_gbps"] = sbw
    extra["pct_stream"] = 100.0 * nbytes / per / 1e9 / sbw
    return per


def _cusparse(a: CSR, dev) -> torch.Tensor:
    return torch.sparse_csr_tensor(
        torch.from_numpy(a.indptr).to(dev), torch.from_numpy(a.indices).to(dev),
        torch.from_numpy(a.data).to(dev), size=a.shape)


def bench_spmv(a: CSR, *, method: str = "auto", value_dtype=None,
               ratio_pairs: int = 0, device=None, baseline: bool = True,
               validate: bool = True, iters: int | None = None
               ) -> BenchRecord:
    """One SpMV record, validated against scipy first. On the card
    ``extra["bound_us"]`` is the plan's bytes (and ``y_in``) over the
    card's data-sheet memory rate, or ``2 nnz`` flops over its rate for the
    matrix's dtype, whichever is larger."""
    m, n = a.shape
    if m != n:
        raise ValueError("bench uses square matrices (carry feedback)")
    dev = _device(device, "bench_spmv")
    plan = SpmvPlan(a, method, value_dtype=value_dtype, device=dev)
    x0_np = np.random.default_rng(0).standard_normal(n).astype(a.dtype)
    x0 = torch.from_numpy(x0_np).to(dev)
    extra = {"method": plan.method, "route_reason": plan.route_reason,
             "nnz": a.nnz, "m": m, "dtype": str(np.dtype(a.dtype)),
             "device": device_name(dev)}
    _validate(a, value_dtype, plan(x0), spmv_golden(a, x0_np), extra,
              validate)
    nbytes = plan.bytes_per_iter + m * a.data.itemsize   # + y_in (beta != 0)
    per = _time(lambda x, x0: plan(x, EPS, 1.0, x0), x0, nbytes, dev,
                ratio_pairs, extra, iters)
    if dev.type == "cuda":
        _bound(extra, nbytes, 2.0 * a.nnz, a.dtype)
    if baseline and dev.type == "cuda":
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
               baseline: bool = True, validate: bool = True,
               iters: int | None = None) -> BenchRecord:
    """One SpMM record (``X`` of ``k`` columns), validated against scipy
    first.

    ``flops`` is the useful work, ``2 nnz k``; ``extra["bound_us"]`` the
    least time the card could take for the plan's work: its bytes over the
    card's data-sheet memory rate (``HBM_BYTES_PER_S``), or the flops it
    executes (every stored block entry for the block routes) over its rate
    for the matrix's dtype (``peak_flops``), whichever is larger (on the
    card only).
    """
    m, n = a.shape
    if m != n:
        raise ValueError("bench uses square matrices (carry feedback)")
    dev = _device(device, "bench_spmm")
    plan = SpmmPlan(a, method, k_hint=k, value_dtype=value_dtype,
                    block_rows=block_rows, device=dev)
    x0_np = np.random.default_rng(0).standard_normal((n, k)).astype(a.dtype)
    x0 = torch.from_numpy(x0_np).to(dev)
    extra = {"method": plan.method, "route_reason": plan.route_reason,
             "nnz": a.nnz, "m": m, "k": k, "dtype": str(np.dtype(a.dtype)),
             "device": device_name(dev)}
    if plan.method == "block":
        extra["block_rows"] = block_rows
    _validate(a, value_dtype, plan(x0), spmm_golden(a, x0_np), extra,
              validate)
    nbytes = plan.bytes_per_call(k, with_y=True)
    per = _time(lambda x, x0: plan(x, EPS, 1.0, x0), x0, nbytes, dev,
                ratio_pairs, extra, iters)
    if dev.type == "cuda":
        _bound(extra, nbytes, plan.flops_per_call(k), a.dtype)
    if baseline and dev.type == "cuda":
        sp = _cusparse(a, dev)
        base = measure_seconds_per_iter(
            lambda x, x0: torch.addmm(x0, sp, x, beta=1.0, alpha=EPS),
            x0, x0)
        extra["baseline"] = "cusparse (torch.sparse_csr_tensor addmm)"
        extra["baseline_us"] = base * 1e6
        extra["speedup_vs_baseline"] = base / per
    return BenchRecord(name=f"spmm_k{k}", seconds_per_iter=per,
                       flops=2.0 * a.nnz * k, bytes=nbytes, extra=extra)


def _cusparse_solve(l: CSR, lower: bool, b0: torch.Tensor, dev,
                    extra: dict) -> None:
    """``torch.triangular_solve`` on a sparse CSR (cuSPARSE SpSV/SpSM on
    the card), timed eagerly with CUDA events: its error, where torch
    refuses the call."""
    sp = _cusparse(l, dev)
    b2 = b0 if b0.dim() == 2 else b0[:, None]
    extra["baseline"] = ("cusparse (torch.triangular_solve on "
                         "torch.sparse_csr_tensor, eager)")
    try:
        base = measure_eager_seconds(
            lambda: torch.triangular_solve(b2, sp, upper=not lower))
    except RuntimeError as e:
        extra["baseline_error"] = str(e).splitlines()[0][:300]
        return
    extra["baseline_us"] = base * 1e6


def _bench_solve(name: str, l: CSR, plan, b0_np: np.ndarray, dev,
                 nbytes: int, k: int, baseline: bool, validate: bool,
                 iters, exact: bool = True) -> BenchRecord:
    b0 = torch.from_numpy(b0_np).to(dev)
    extra = {"method": plan.method, "nnz": l.nnz, "n": l.shape[0],
             "nlevels": plan.nlevels, "dtype": str(np.dtype(l.dtype)),
             "device": device_name(dev)}
    if hasattr(plan, "route_reason"):
        extra["route_reason"] = plan.route_reason
    if validate:
        err = rel_err(plan(b0).cpu().numpy(),
                      sptrsv_golden(l, b0_np, lower=plan.lower,
                                    unit_diagonal=plan.unit_diagonal))
        extra["rel_err"] = err
        tol = SOLVE_TOL[np.dtype(l.dtype)]
        # a truncated Jacobi solve reports how far it got
        if exact and not err < tol:
            raise RuntimeError(f"validation failed: rel_err {err} >= {tol}")
    # a solve takes 0.1-300 ms: a few iterations resolve it
    per = _measure(dev, lambda x, b0: plan(b0 + EPS * x), b0, b0,
                   extra=extra, iters=iters, lo=1, hi=4)
    extra["levels_per_s"] = plan.nlevels / per
    extra["ns_per_level"] = per * 1e9 / max(plan.nlevels, 1)
    if dev.type == "cuda":
        _bound(extra, nbytes, 2.0 * l.nnz * k, l.dtype)
        if baseline:
            _cusparse_solve(l, plan.lower, b0, dev, extra)
    return BenchRecord(name=name, seconds_per_iter=per, flops=2.0 * l.nnz * k,
                       bytes=nbytes, extra=extra)


def bench_sptrsv(l: CSR, *, lower: bool = True, method: str = "auto",
                 device=None, baseline: bool = True, validate: bool = True,
                 iters: int | None = None, sweeps: int | None = None,
                 tile_rows: int = 0,
                 compare_reference: bool = False) -> BenchRecord:
    """One SpTRSV record, validated against scipy first (``SOLVE_TOL``;
    ``jacobi`` with fewer than ``nlevels - 1`` ``sweeps`` reports its
    ``rel_err`` unchecked). On the card ``extra["bound_us"]``: the plan's
    bytes over the card's data-sheet memory rate, or ``2 nnz`` flops over
    its rate for the factor's dtype, whichever is larger. The plan comes
    from the plan cache, so that ``sptrsv`` and :func:`bench_sptrsm` of the
    same matrix share its analysis. ``compare_reference`` also times the
    plain level-set solve (``sptrsv_csr_reference``: a gather, an
    ``index_add_`` and a scale a level) as ``reference_us``, the JAX
    package's naive wavefront baseline."""
    dev = _device(device, "bench_sptrsv")
    # the caller's device and options only where it gave them: then the
    # plan is the one sptrsv(l, b) builds and caches
    kw = {} if device is None else {"device": dev}
    if sweeps is not None:
        kw["sweeps"] = sweeps
    if tile_rows:
        kw["tile_rows"] = tile_rows
    plan = sptrsv_plan(l, lower=lower, method=method, **kw)
    b0 = np.random.default_rng(0).standard_normal(l.shape[0]).astype(l.dtype)
    exact = method != "jacobi" or plan.sweeps >= plan.nlevels - 1
    rec = _bench_solve("sptrsv", l, plan, b0, dev, plan.bytes_per_iter, 1,
                       baseline, validate, iters, exact)
    if method == "jacobi":
        rec.extra["sweeps"] = plan.sweeps
    if plan.method == "tiles":
        rec.extra["tile_rows"] = plan.tile_rows
    if compare_reference:
        op = plan._op if plan.method == "syncfree" else sptrsv_csr.prepare(
            l, dev, lower=lower)
        bt = torch.from_numpy(b0).to(dev)
        ref = _measure(dev, lambda x, b: sptrsv_csr.sptrsv_csr_reference(
            op, b + EPS * x), bt, bt, extra=rec.extra, lo=1, hi=2,
            repeats=1)
        rec.extra["reference"] = "plain level-set solve (sptrsv_csr_reference)"
        rec.extra["reference_us"] = ref * 1e6
        rec.extra["speedup_vs_reference"] = ref / rec.seconds_per_iter
    return rec


def bench_sptrsm(l: CSR, k: int = 8, *, lower: bool = True,
                 method: str = "auto", device=None, baseline: bool = True,
                 validate: bool = True,
                 iters: int | None = None) -> BenchRecord:
    """One SpTRSM record (``B`` of ``k`` columns), validated against scipy
    first; the bound as :func:`bench_sptrsv`'s."""
    dev = _device(device, "bench_sptrsm")
    plan = SptrsmPlan(l, lower=lower, method=method,
                      **({} if device is None else {"device": dev}))
    b0 = np.random.default_rng(0).standard_normal(
        (l.shape[0], k)).astype(l.dtype)
    rec = _bench_solve(f"sptrsm_k{k}", l, plan, b0, dev,
                       plan.bytes_per_iter(k), k, baseline, validate, iters)
    rec.extra["k"] = k
    return rec


# each kernel build's launch count: (wrapper module, counter). A wrapper
# adds one where it launches its kernel on the card, and nowhere else
COUNTERS = {"spmv_csr": (spmv_csr, "LAUNCHES"),
            "spmv_csr_f64": (spmv_csr, "LAUNCHES_F64"),
            "spmm_bsr": (spmm_bsr, "LAUNCHES"),
            "spmm_csr": (spmm_csr, "LAUNCHES"),
            "spmm_csr_f64": (spmm_csr, "LAUNCHES_F64"),
            "spmm_csr_rows": (spmm_csr, "LAUNCHES_ROWS"),
            "spmm_csr_cols": (spmm_csr, "LAUNCHES_COLS"),
            "spmm_csr_cols_f64": (spmm_csr, "LAUNCHES_COLS_F64"),
            "sptrsv_csr": (sptrsv_csr, "LAUNCHES"),
            "sptrsv_csr_f64": (sptrsv_csr, "LAUNCHES_F64")}


def launch_counts() -> dict:
    """Every kernel build's launches so far, by name."""
    return {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}


def _launches() -> tuple[int, int]:
    """Launches so far of the SpMV kernels (csr and nnz-balanced) and of
    the solve kernel, every build."""
    return (spmv_csr.LAUNCHES + spmv_csr.LAUNCHES_F64 + spmm_csr.LAUNCHES
            + spmm_csr.LAUNCHES_F64,
            sptrsv_csr.LAUNCHES + sptrsv_csr.LAUNCHES_F64)


def bench_solver(solver, a: CSR, b: np.ndarray, *, M=None, device=None,
                 **kw) -> dict:
    """One solve ``solver(plan, b, M=M, **kw)`` (``solver`` is
    :func:`~sblas_torch.solvers.cg`, ``bicgstab`` or ``gmres``; ``plan`` the
    SpMV ``auto`` plan of ``a``; ``M`` built on the same device), and what
    it cost.

    Returns its ``iterations`` and reported ``rel_residual``, the true
    relative residual ``||b - A x|| / ||b||`` through scipy in f64, the wall
    time (host clock, ended by a synchronize) and ms per iteration, and the
    share of that wall time the kernels account for: the SpMV plan's
    graph-timed call and, for a :class:`~sblas_torch.solvers.TriangularPair`
    ``M`` of solve plans, each solve's graph-timed call, times the launches
    the solve made (counted by the kernels' wrappers). The rest of each
    iteration is the vector operations, the host's Python and its reads.
    On the CPU (``device="cpu"``) the kernels run their plain versions and
    count no launch: the split is left out.
    """
    from .solvers import TriangularPair

    dev = _device(device, "bench_solver")
    card = dev.type == "cuda"
    plan = SpmvPlan(a, "auto", device=dev)
    b0 = torch.from_numpy(np.asarray(b, dtype=a.dtype)).to(dev)
    spmv_us = 1e6 * measure_seconds_per_iter(
        lambda x, x0: plan(x, EPS, 1.0, x0), b0, b0) if card else None
    solve_us = {}
    if card and isinstance(M, TriangularPair):
        # a solve of a 1M-row natural-order factor takes ~0.25 s on the
        # H100: one marginal sample of one against two solves resolves it
        for side, sp in (("fwd", M.fwd), ("bwd", M.bwd)):
            solve_us[side] = 1e6 * measure_seconds_per_iter(
                lambda x, y0, sp=sp: sp(y0 + EPS * x), b0, b0,
                iters_lo=1, iters_hi=2, repeats=1)
            solve_us[side + "_nlevels"] = sp.nlevels
    if card:
        torch.cuda.synchronize(dev)
    before = _launches()
    t0 = time.perf_counter()
    x, info = solver(plan, b0, M=M, **kw)
    if card:
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    spmv_n, solve_n = (after - pre for after, pre in zip(_launches(), before))
    b64 = np.asarray(b, dtype=np.float64)
    true = float(np.linalg.norm(
        b64 - a.to_scipy().astype(np.float64) @ x.cpu().numpy()
        .astype(np.float64)) / max(np.linalg.norm(b64), 1e-30))
    it = max(info["iterations"], 1)
    row = {"iterations": info["iterations"],
           "rel_residual": info["rel_residual"],
           "true_rel_residual": true, "wall_s": wall,
           "ms_per_iter": wall * 1e3 / it, "method": plan.method,
           "route_reason": plan.route_reason,
           "dtype": str(np.dtype(a.dtype)), "n": a.shape[0], "nnz": a.nnz,
           "device": device_name(dev)}
    if not card:
        row["timer"] = "host"
        return row
    ms = {"spmv": spmv_n * spmv_us / 1e3 / it}
    if solve_us:
        # each application of M is one forward and one backward solve
        ms["fwd_solve"] = solve_n / 2 * solve_us["fwd"] / 1e3 / it
        ms["bwd_solve"] = solve_n / 2 * solve_us["bwd"] / 1e3 / it
    kernel_ms = sum(ms.values())
    ms["rest"] = wall * 1e3 / it - kernel_ms
    return {**row, "ms_per_iter_split": ms,
            "kernel_share": kernel_ms * it / (wall * 1e3),
            "spmv_us": spmv_us, "spmv_launches": spmv_n,
            "solve_us": solve_us, "solve_launches": solve_n}
