"""nnz-balanced CSR SpMM kernel wrapper: the port of the JAX package's four
scattered-matrix kernels (``spmv_pseg.py:37``, ``spmm_pseg.py:134``,
``spmm_pseg.py:350``, ``spmm_pallas.py:30``), one kernel here, with an f64
build.

:func:`prepare` checks a matrix uploaded by
:func:`sblas_torch.formats.to_device` once and adds the launch's partition:
the merge-path start of each warp's share (:func:`merge_path`), the shares
whose first row began in an earlier one (:func:`fixup_units`) with the
share where that row began (:func:`fixup_starts`), all uploaded with the
operand, and the lanes per row. :func:`spmm_csr` then computes ``Y_out =
alpha * A @ X + beta * Y`` for row-major ``X (n, K)`` and ``Y (m, K)``,
any K (K = 1 is SpMV): f32 for f32 or bf16 values, f64 for f64 values. On
CUDA tensors it launches the hand-written kernels of
``sblas_torch/csrc/spmm_csr.cu`` (see the note there: at K = 1 the merge
SpMV; at K > 1 the rows kernel at small K, :func:`rows_kernel`, else
the columns kernel); on CPU tensors it runs :func:`spmm_csr_reference`,
the plain torch version of the same function. There is no fallback from
one to the other. :func:`spmm_csr_emulate` runs the kernels' own
partition on the CPU (at K = 1 and in the rows kernel the lanes' runs of
the merged path and their segmented scan, in the columns kernel its steps
and slots, each in the kernel's order), and the carry fix-up, so that the
tests can hold that part to the plain version.

Each call that launches counts once, under the kernel it launched (its
fix-up launch included), so that a run can show its main path went
through each: ``LAUNCHES`` and ``LAUNCHES_F64`` the merge SpMV at K = 1 of
the f32/bf16 and the f64 build, ``LAUNCHES_ROWS`` and
``LAUNCHES_ROWS_F64`` the rows kernel, ``LAUNCHES_COLS`` and
``LAUNCHES_COLS_F64`` the columns kernel of each build.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ... import trace
from ._build import entry
from .spmv_csr import vector_dtype

LAUNCHES = 0
LAUNCHES_F64 = 0
LAUNCHES_ROWS = 0
LAUNCHES_ROWS_F64 = 0
LAUNCHES_COLS = 0
LAUNCHES_COLS_F64 = 0

# merged-path items (row ends + nonzeros) a warp takes: the rows kernel
# and the columns kernel at K > 1, and K = 1: the fastest share sizes on
# the H100 (benchmarks/run_suite.py's unit_sweep; PERF.md)
UNIT = 512
UNIT_COLS = 512
UNIT_SPMV = 256
# lanes a warp's share is split over at K = 1, the carries one fix-up
# thread adds alone, and the partial sums a lane of a fix-up warp keeps
# (csrc/spmm_csr.cu)
WARP = 32
SHORT_FIX = 8
FIX_BATCH = 8
# the rows kernel's range by the rule (rows_kernel): the largest K in
# f32/bf16 and in f64, and in f64 the largest mean row length
ROWS_MAX_K = 16
ROWS_MAX_K_F64 = 4
ROWS_MEAN_F64 = 40


def _argtypes(scalar) -> list:
    return [ctypes.c_int] * 7 + [              # m n k rows units unit nfix
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # indptr..values
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # part fix fix_lo
        ctypes.c_void_p, ctypes.c_void_p,                    # x, y_in
        scalar, scalar,                                      # alpha, beta
        ctypes.c_void_p, ctypes.c_void_p,                    # y_out, carry
        ctypes.c_void_p]                                     # stream


# value dtype -> (C symbol, its argument types: alpha and beta in the
# vectors' type, so that an f64 call keeps every bit of them)
_SYMBOLS = {torch.float32: ("sblas_spmm_csr_f32", _argtypes(ctypes.c_float)),
            torch.bfloat16: ("sblas_spmm_csr_bf16",
                             _argtypes(ctypes.c_float)),
            torch.float64: ("sblas_spmm_csr_f64",
                            _argtypes(ctypes.c_double))}


def merge_path(indptr: np.ndarray, unit: int = UNIT) -> np.ndarray:
    """``(units + 1, 2)`` int32: the (row, nonzero) where each share of
    ``unit`` merged-path items starts, then the end ``(m, nnz)``.

    The path merges the row ends with the nonzeros: row ``r`` ends at item
    ``indptr[r + 1] + r``. A share starting at item ``d`` starts at row
    ``r`` = the number of row ends before ``d``, and nonzero ``d - r``."""
    indptr = np.asarray(indptr, dtype=np.int64)
    m, nnz = len(indptr) - 1, int(indptr[-1])
    total = m + nnz
    units = max(-(-total // unit), 1)
    d = np.minimum(np.arange(units + 1, dtype=np.int64) * unit, total)
    ends = indptr[1:] + np.arange(m, dtype=np.int64)
    r = np.searchsorted(ends, d, side="left")
    return np.stack([r, d - r], axis=1).astype(np.int32)


def fixup_units(indptr: np.ndarray, part: np.ndarray) -> np.ndarray:
    """The shares that end a row begun in an earlier share (int32): their
    first row is written raw and completed by the fix-up launch."""
    r0, j0, r1 = part[:-1, 0], part[:-1, 1], part[1:, 0]
    cut = (r0 < r1) & (np.asarray(indptr)[r0] < j0)
    return np.flatnonzero(cut).astype(np.int32)


def fixup_starts(indptr: np.ndarray, part: np.ndarray,
                 fix: np.ndarray) -> np.ndarray:
    """For each share of ``fix``, the share where its first row began
    (int32): the fix-up adds the carries of that share through the one
    before ``fix``. Row ``r``'s first nonzero is merged-path item
    ``indptr[r] + r``."""
    r = part[fix, 0].astype(np.int64)
    first = np.asarray(indptr, dtype=np.int64)[r] + r
    starts = part[:, 0].astype(np.int64) + part[:, 1]
    return (np.searchsorted(starts, first, side="right") - 1).astype(
        np.int32)


def spread_long(fix: np.ndarray, fix_lo: np.ndarray) -> tuple:
    """``fix`` and ``fix_lo`` reordered so that each cut row of more than
    ``SHORT_FIX`` carries, which a whole fix-up warp sums, takes the first
    lane of a warp of its own; the others keep their order, and entries of
    -1 (no row) pad the list where the rows of few carries do not fill
    those warps. The order of the list changes no sum."""
    long_ = np.flatnonzero(fix - fix_lo > SHORT_FIX)
    short = np.flatnonzero(fix - fix_lo <= SHORT_FIX)
    n = max(len(fix), WARP * len(long_))
    slots = np.arange(len(long_)) * WARP
    free = np.ones(n, dtype=bool)
    free[slots] = False
    order = np.full(n, -1, dtype=np.int64)
    order[slots] = long_
    order[np.flatnonzero(free)[:len(short)]] = short
    pad = order < 0
    out_fix = np.where(pad, -1, fix[np.maximum(order, 0)])
    out_lo = np.where(pad, -1, fix_lo[np.maximum(order, 0)])
    return out_fix.astype(np.int32), out_lo.astype(np.int32)


def _shares(host_indptr: np.ndarray, unit: int, dev) -> dict:
    """One partition of the merged path: ``unit``, ``part``, ``fix`` and
    ``fix_lo`` (:func:`spread_long`) on ``dev``."""
    part = merge_path(host_indptr, unit)
    fix = fixup_units(host_indptr, part)
    fix, fix_lo = spread_long(fix, fixup_starts(host_indptr, part, fix))
    return {"unit": unit, "part": torch.from_numpy(part).to(dev),
            "fix": torch.from_numpy(fix).to(dev),
            "fix_lo": torch.from_numpy(fix_lo).to(dev)}


def prepare(t: dict, unit: int | None = None) -> dict:
    """The operand :func:`spmm_csr` takes: ``t`` checked, plus three
    partitions (on ``t``'s device): ``"unit"``, ``"part"``, ``"fix"`` and
    ``"fix_lo"`` for the rows kernel at K > 1, and the same under
    ``"cols"`` for the columns kernel and under ``"spmv"`` for K = 1.
    Shares of ``UNIT``, ``UNIT_COLS`` and ``UNIT_SPMV`` items, or all of
    ``unit``."""
    m, _ = t["shape"]
    indptr, indices, data = t["indptr"], t["indices"], t["data"]
    dev = indptr.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"spmm_csr runs on cuda or cpu tensors, not {dev}")
    for name, ten in (("indptr", indptr), ("indices", indices),
                      ("data", data)):
        if ten.device != dev:
            raise ValueError(f"{name} is on {ten.device}, indptr on {dev}")
        if not ten.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if indptr.dtype != torch.int32 or indices.dtype != torch.int32:
        raise TypeError("indptr and indices must be int32")
    if data.dtype not in _SYMBOLS:
        raise TypeError(f"spmm_csr takes f32, bf16 or f64 values, got "
                        f"{data.dtype}")
    if indptr.shape != (m + 1,) or indices.shape != data.shape:
        raise ValueError("indptr/indices/data do not match the matrix shape")
    if unit is not None and unit < 1:
        raise ValueError(f"unit must be >= 1, got {unit}")
    with trace.span("sblas.spmm_csr.partitions", "build"):
        host = indptr.cpu().numpy()
        parts = {u: _shares(host, u, dev)
                 for u in {unit or UNIT, unit or UNIT_COLS, unit or UNIT_SPMV}}
    return {**t, **parts[unit or UNIT], "cols": parts[unit or UNIT_COLS],
            "spmv": parts[unit or UNIT_SPMV]}


def rows_kernel(op: dict, k: int) -> bool:
    """Does a launch with ``k > 1`` columns take the rows kernel (lanes on
    runs of the merged path) rather than the columns kernel? An operand
    may name the kernel (``"design": "rows"`` or ``"cols"``), as
    ``chip_smoke.py`` does to time both; else :func:`rule_takes_rows`,
    where the H100 timed the rows kernel the faster (``chip_smoke.py``
    phases ``graph_timing`` and ``k_switch``; NVIDIA H100 80GB HBM3, 700
    W; PERF.md), rows against columns kernel in us:

    - f32 and bf16 values: up to ``ROWS_MAX_K`` = 16 columns. K = 8 / 16:
      uk-2002@0.05 194.7 / 355.3 against 275.4 / 441.7, twitter7@0.02
      287.0 / 534.0 against 407.1 / 698.9. At K = 32 the columns kernel:
      801.6 against 753.8, 1,258.9 against 1,243.0.
    - f64 values: up to ``ROWS_MAX_K_F64`` = 4 columns where rows hold at
      most ``ROWS_MEAN_F64`` = 40 nonzeros on average. K = 2 / 4, by the
      mean row: uk-2002@0.05 (15.6) 144.1 / 187.4 against 196.4 / 229.7,
      twitter7@0.02 (34.2) 224.5 / 303.3 against 252.0 / 331.3; pwtk
      (48.4) 89.9 / 121.9 against 84.4 / 109.8, cant (58.2) 37.9 / 47.8
      against 35.7 / 45.0, powerlaw-1M-102M (101.2) 723.0 / 968.7
      against 690.7 / 1,007.5 (within 5% either way). 40 lies in the
      untimed gap between 34.2 and 48.4. At K = 8 the columns kernel on
      the four timed there (uk-2002 314.3 against 309.7, twitter7 527.0
      against 461.2, pwtk 226.8 against 163.6, cant 87.8 against
      65.1)."""
    design = op.get("design")
    if design is not None:
        return design == "rows"
    return rule_takes_rows(op["data"].dtype == torch.float64, k,
                           op["shape"][0], op["indices"].numel())


def rule_takes_rows(f64: bool, k: int, m: int, nnz: int) -> bool:
    """The rule of :func:`rows_kernel` for ``k > 1`` columns of a matrix
    of ``m`` rows and ``nnz`` nonzeros, f64 values or not (f32, bf16); the
    SpMM rule prices the merge route's X gather by it."""
    if f64:
        return 1 < k <= ROWS_MAX_K_F64 and nnz <= ROWS_MEAN_F64 * m
    return 1 < k <= ROWS_MAX_K


def shares(op: dict, k: int) -> dict:
    """The partition a launch with ``k`` columns takes."""
    if k == 1:
        return op["spmv"]
    return op if rows_kernel(op, k) else op["cols"]


def _check_dense(name: str, v: torch.Tensor, rows: int, k: int | None,
                 dev: torch.device, dtype: torch.dtype) -> None:
    if v.dtype != dtype or v.dim() != 2 or v.shape[0] != rows \
            or (k is not None and v.shape[1] != k):
        want = f"({rows}, {'K' if k is None else k})"
        short = "f64" if dtype == torch.float64 else "f32"
        raise ValueError(f"{name} must be {short} of shape {want}, got "
                         f"{v.dtype} {tuple(v.shape)}")
    if v.device != dev:
        raise ValueError(f"{name} is on {v.device}, the matrix on {dev}")
    if not v.is_contiguous():
        raise ValueError(f"{name} must be contiguous (row-major)")


def spmm_csr(op: dict, x: torch.Tensor, alpha: float = 1.0, beta: float = 0.0,
             y: torch.Tensor | None = None) -> torch.Tensor:
    """``alpha * A @ X + beta * Y`` (``Y`` None: ``alpha * A @ X``) for the
    operand ``op`` of :func:`prepare`, ``X (n, K)`` f32 (f64 for f64
    values), any K >= 0.

    The kernel launches on the current stream of the tensors' device, which
    must be the current device.
    """
    global LAUNCHES, LAUNCHES_F64, LAUNCHES_ROWS, LAUNCHES_ROWS_F64, \
        LAUNCHES_COLS, LAUNCHES_COLS_F64
    m, n = op["shape"]
    dev = op["indptr"].device
    vt = vector_dtype(op["data"].dtype)
    _check_dense("X", x, n, None, dev, vt)
    k = x.shape[1]
    if y is None:
        if beta != 0.0:
            raise ValueError("beta != 0 requires Y")
    else:
        _check_dense("Y", y, m, k, dev, vt)
    if dev.type == "cpu":
        return spmm_csr_reference(op, x, alpha, beta, y)
    out = torch.empty((m, k), dtype=vt, device=dev)
    if m == 0 or k == 0:
        return out
    sh = shares(op, k)
    units = sh["part"].shape[0] - 1
    nfix = sh["fix"].numel()
    carry = torch.empty((units, k), dtype=vt, device=dev)
    fn, err = entry(*_SYMBOLS[op["data"].dtype])
    rows = k > 1 and rows_kernel(op, k)
    rc = fn(m, n, k, int(rows), units, sh["unit"], nfix,
            op["indptr"].data_ptr(), op["indices"].data_ptr(),
            op["data"].data_ptr(), sh["part"].data_ptr(),
            sh["fix"].data_ptr(), sh["fix_lo"].data_ptr(), x.data_ptr(),
            None if y is None else y.data_ptr(), alpha, beta, out.data_ptr(),
            carry.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spmm_csr launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")
    f64 = vt == torch.float64
    if k == 1:
        if f64:
            LAUNCHES_F64 += 1
        else:
            LAUNCHES += 1
    elif rows:
        if f64:
            LAUNCHES_ROWS_F64 += 1
        else:
            LAUNCHES_ROWS += 1
    elif f64:
        LAUNCHES_COLS_F64 += 1
    else:
        LAUNCHES_COLS += 1
    return out


def _products(t: dict, x: torch.Tensor, dtype: torch.dtype):
    """Per-nonzero rows and products ``data * X[indices]`` in ``dtype``."""
    m, _ = t["shape"]
    indptr = t["indptr"]
    rows = torch.repeat_interleave(
        torch.arange(m, device=indptr.device), indptr.diff().long(),
        output_size=t["indices"].numel())
    return rows, t["data"].to(dtype)[:, None] * x[t["indices"].long()].to(
        dtype)


def _epilogue(out, alpha, beta, y):
    out = alpha * out
    return out if y is None else out + beta * y


def spmm_csr_reference(t: dict, x: torch.Tensor, alpha: float = 1.0,
                       beta: float = 0.0,
                       y: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version of the kernel: products ``data * X[indices]``,
    summed per row with ``index_add_``, then the same epilogue, all in f64
    (the products of f32 values are exact there) and rounded to X's dtype
    once (f32, or f64 for the f64 build). A row of a web graph holds 10^5
    nonzeros and more; summed in f32 one after the other, as ``index_add_``
    does, it is off from the exact sum by more than the kernel's tree of
    partial sums is (1.3e-5 of max |Y| on uk-2002 at 5%, against scipy), so
    the plain version sums in f64."""
    m, _ = t["shape"]
    rows, prods = _products(t, x, torch.float64)
    out = torch.zeros((m, x.shape[1]), dtype=torch.float64, device=x.device)
    out.index_add_(0, rows, prods)
    return _epilogue(out, alpha, beta,
                     None if y is None else y.double()).to(x.dtype)


def _emulate_lanes(op: dict, sh: dict, x: torch.Tensor, dt,
                   fused: bool) -> tuple:
    """Each share's 32 lanes walk their runs of ``ceil(unit / 32)``
    merged-path items as ``spmv_merge_kernel`` (K = 1) and
    ``spmm_rows_kernel`` (K > 1) do, all runs a step at a time: a nonzero
    adds ``value * X[col, :]`` to the run's sums of K columns, a row end
    closes the row; the rows open at the runs' ends meet in the segmented
    scan over the lanes (Hillis-Steele, keyed by the open row, as the
    shuffles add), which completes the row each lane closed first. The
    product is rounded to ``dt`` and then added (K = 1: staged products),
    or with ``fused`` one multiply-add (the rows kernel; the product and
    the sum formed in f64 and rounded once for f32, twice in f64). Returns
    the raw row sums, the mask of rows written raw, and each share's
    carry."""
    m, _ = op["shape"]
    k = x.shape[1]
    part = sh["part"].cpu().numpy().astype(np.int64)
    indptr = op["indptr"].cpu().numpy().astype(np.int64)
    cols = op["indices"].cpu().numpy().astype(np.int64)
    vt = torch.float64 if dt is np.float64 else torch.float32
    vals = op["data"].cpu().to(vt).numpy()
    xs = x.cpu().numpy()
    ipt = -(-sh["unit"] // WARP)
    units = len(part) - 1
    # each run's items d0 .. d1 on the whole merged path; ri row ends and
    # ni nonzeros come before its next item
    start, end = part[:-1].sum(1), part[1:].sum(1)
    d0 = np.minimum(start[:, None] + np.arange(WARP) * ipt,
                    end[:, None]).ravel()
    d1 = np.minimum(d0 + ipt, np.repeat(end, WARP))
    ri = np.searchsorted(indptr[1:] + np.arange(m), d0, side="left")
    ni = d0 - ri
    ri0 = ri.copy()
    acc = np.zeros((len(d0), k), dtype=dt)
    first = np.zeros_like(acc)
    closed = np.zeros(len(d0), dtype=bool)
    out = np.zeros((m, k), dtype=dt)
    for t in range(ipt):
        act = d0 + t < d1
        ends = act & (ri < m)
        ends[ends] = indptr[ri[ends] + 1] <= ni[ends]
        done = ends & closed            # began in this run: complete
        out[ri[done]] = acc[done]
        opened = ends & ~closed         # the run's first: to the scan
        first[opened] = acc[opened]
        closed |= ends
        acc[ends] = 0
        ri += ends
        nz = act & ~ends
        j = ni[nz]
        if fused:
            acc[nz] = (vals[j, None].astype(np.float64) * xs[cols[j]]
                       + acc[nz]).astype(dt)
        else:
            acc[nz] = acc[nz] + (vals[j, None] * xs[cols[j]]).astype(dt)
        ni += nz
    v = acc.reshape(units, WARP, k)
    key = ri.reshape(units, WARP)
    off = 1
    while off < WARP:
        upd = np.zeros_like(key, dtype=bool)
        upd[:, off:] = key[:, :-off] == key[:, off:]
        vo = np.zeros_like(v)
        vo[:, off:] = v[:, :-off]
        v = np.where(upd[..., None], vo + v, v)
        off *= 2
    # each lane's first row: the scanned part of the run before it, plus
    # its own
    before = np.zeros_like(v)
    before[:, 1:] = v[:, :-1]
    out[ri0[closed]] = (before.reshape(-1, k) + first)[closed]
    r0, r1 = part[:-1, 0], part[1:, 0]
    first_cut = (r0 < r1) & (indptr[r0] < part[:-1, 1])
    raw = np.zeros(m, dtype=bool)
    raw[r0[first_cut]] = True
    carry = np.where((r1 < m)[:, None], v[:, WARP - 1], 0).astype(dt)
    return out, raw, carry


def slot_lanes(k: int) -> tuple:
    """``(W, CPL)`` of a launch with ``k > 1`` columns: the lanes a slot
    (the power of two that holds K, 2 to 32) and the columns a lane (1, or
    2 or 4 beyond 32), as ``launch_cols`` in ``csrc/spmm_csr.cu`` picks
    them."""
    for w in (2, 4, 8, 16, 32):
        if k <= w:
            return w, 1
    return WARP, 2 if k <= 64 else 4


def _emulate_steps(op: dict, x: torch.Tensor, dt) -> tuple:
    """K > 1: each share's warp walks its nonzeros ``32 / W`` at a time, as
    ``spmm_merge_kernel`` does. Slot ``g`` of a step takes the step's
    ``g``-th nonzero, so inside a share a row's nonzeros at offsets ``i``
    (from the share's first nonzero) with ``i % (32 / W) == g`` add up in
    slot ``g`` in order (one fused multiply-add each; here the product and
    the sum are formed in f64 and rounded once for f32, and rounded twice in
    f64), and the row's slots meet in the kernel's shuffle tree. Returns
    the raw row sums, the mask of rows written raw, and each share's
    carry."""
    m, _ = op["shape"]
    k = x.shape[1]
    part = shares(op, k)["part"].cpu().numpy().astype(np.int64)
    indptr = op["indptr"].cpu().numpy().astype(np.int64)
    cols = op["indices"].cpu().numpy().astype(np.int64)
    vt = torch.float64 if dt is np.float64 else torch.float32
    vals = op["data"].cpu().to(vt).numpy()
    xs = x.cpu().numpy()
    slots = WARP // slot_lanes(k)[0]
    units = len(part) - 1
    nnz = len(cols)
    j = np.arange(nnz)
    u = np.searchsorted(part[:, 1], j, side="right") - 1
    j0 = part[u, 1]
    row = np.repeat(np.arange(m), np.diff(indptr))
    # a (share, row) segment; its slots; each nonzero's turn in its slot
    new = np.ones(nnz, dtype=bool)
    new[1:] = (u[1:] != u[:-1]) | (row[1:] != row[:-1])
    seg = np.cumsum(new) - 1
    nseg = int(seg[-1]) + 1 if nnz else 0
    rel = j - j0
    start = np.maximum(indptr[row], j0) - j0
    slot = rel % slots
    turn = (rel - start - (slot - start) % slots) // slots
    acc = np.zeros((nseg, slots, k), dtype=dt)
    order = np.argsort(turn, kind="stable")
    bounds = np.searchsorted(turn[order], np.arange(turn.max(initial=-1) + 2))
    for t in range(len(bounds) - 1):
        sel = order[bounds[t]:bounds[t + 1]]
        a = acc[seg[sel], slot[sel]].astype(np.float64)
        prod = vals[sel, None].astype(np.float64) * xs[cols[sel]]
        acc[seg[sel], slot[sel]] = (a + prod).astype(dt)
    while acc.shape[1] > 1:                 # the shuffle tree over slots
        acc = acc[:, 0::2] + acc[:, 1::2]
    sums = acc[:, 0]
    out = np.zeros((m, k), dtype=dt)
    carry = np.zeros((units, k), dtype=dt)
    firsts = np.flatnonzero(new)
    su, sr = u[firsts], row[firsts]
    cut = sr == part[su + 1, 0]             # the row the share ends inside
    carry[su[cut]] = sums[cut]
    out[sr[~cut]] = sums[~cut]
    raw = np.zeros(m, dtype=bool)
    r0, r1 = part[:-1, 0], part[1:, 0]
    first_cut = (r0 < r1) & (indptr[r0] < part[:-1, 1])
    raw[r0[first_cut]] = True
    return out, raw, carry


def spmm_csr_emulate(op: dict, x: torch.Tensor, alpha: float = 1.0,
                     beta: float = 0.0,
                     y: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's partition on the CPU. At K = 1 and in the rows kernel,
    each share's 32 lanes walk their runs of the merged path and meet in
    the segmented scan (:func:`_emulate_lanes`); in the columns kernel each
    share's slots take its nonzeros in steps (:func:`_emulate_steps`).
    Either way the row a share ends inside goes to its carry, and a row it
    begins inside stays raw until the fix-up adds the carries of the shares
    from ``fix_lo`` to it as ``spmm_csr_fixup`` does: up to ``SHORT_FIX``
    in order; more, lane ``l`` of 32 takes every 32nd into ``FIX_BATCH``
    sums in turn, a tree adds those, and a tree adds the lanes."""
    k = x.shape[1]
    sh = shares(op, k)
    part = sh["part"].cpu().tolist()
    vt = x.dtype
    dt = np.float64 if vt == torch.float64 else np.float32
    if k == 1 or rows_kernel(op, k):
        parts = _emulate_lanes(op, sh, x, dt, fused=k > 1)
    else:
        parts = _emulate_steps(op, x, dt)
    out, raw, carry = map(torch.from_numpy, parts)
    yc = None if y is None else y.cpu()
    done = _epilogue(out, alpha, beta, yc)
    for b, lo in zip(sh["fix"].tolist(), sh["fix_lo"].tolist()):
        if b < 0:
            continue
        r, _ = part[b]
        if b - lo <= SHORT_FIX:
            s = torch.zeros(k, dtype=vt)
            for i in range(lo, b):
                s += carry[i]
        else:
            lanes = torch.zeros((FIX_BATCH, WARP, k), dtype=vt)
            for i in range(lo, b):
                lanes[(i - lo) // WARP % FIX_BATCH, (i - lo) % WARP] += \
                    carry[i]
            w = FIX_BATCH // 2
            while w:
                lanes[:w] += lanes[w:2 * w]
                w //= 2
            lanes = lanes[0]
            off = WARP // 2
            while off:
                lanes[:off] += lanes[off:2 * off]
                off //= 2
            s = lanes[0]
        done[r] = _epilogue(out[r] + s, alpha, beta,
                            None if yc is None else yc[r])
        raw[r] = False
    if raw.any():
        raise RuntimeError("rows written raw that no fix-up completes: "
                           f"{torch.flatnonzero(raw).tolist()[:8]}")
    return done.to(x.device)
