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
CUDA tensors it launches the hand-written kernel of
``sblas_torch/csrc/spmm_csr.cu`` (see the note there); on CPU tensors it
runs :func:`spmm_csr_reference`, the plain torch version of the same
function. There is no fallback from one to the other.
:func:`spmm_csr_emulate` runs the kernel's own partition on the CPU (at K
= 1 the lanes' runs of the merged path and their segmented scan), and its
carry fix-up, so that the tests can hold that part to the plain version.

``LAUNCHES`` counts calls that launched the f32/bf16 build (its fix-up
launch included), ``LAUNCHES_F64`` those of the f64 build, so that a run
can show its main path went through it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import entry
from .spmv_csr import group_size, vector_dtype

LAUNCHES = 0
LAUNCHES_F64 = 0

# merged-path items (row ends + nonzeros) a warp takes at K > 1 and at
# K = 1: the fastest share sizes of chip_smoke.py's unit_sweep on the H100
# (PERF.md)
UNIT = 1024
UNIT_SPMV = 256
# lanes a warp's share is split over at K = 1, the carries one fix-up
# thread adds alone, and the partial sums a lane of a fix-up warp keeps
# (csrc/spmm_csr.cu)
WARP = 32
SHORT_FIX = 8
FIX_BATCH = 8


def _argtypes(scalar) -> list:
    return [ctypes.c_int] * 7 + [                      # m n k G units unit nfix
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
    """The operand :func:`spmm_csr` takes: ``t`` checked, plus ``"group"``
    (lanes per row at K > 1,
    :func:`~sblas_torch.ops.kernels.spmv_csr.group_size`) and two
    partitions (on ``t``'s device): ``"unit"``, ``"part"``, ``"fix"`` and
    ``"fix_lo"`` for K > 1, and the same under ``"spmv"`` for K = 1. Shares
    of ``UNIT`` and ``UNIT_SPMV`` items, or both of ``unit``."""
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
    host = indptr.cpu().numpy()
    wide = _shares(host, unit or UNIT, dev)
    narrow = wide if unit else _shares(host, UNIT_SPMV, dev)
    return {**t, "group": group_size(m, indices.numel()), **wide,
            "spmv": narrow}


def shares(op: dict, k: int) -> dict:
    """The partition a launch with ``k`` columns takes."""
    return op["spmv"] if k == 1 else op


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
    global LAUNCHES, LAUNCHES_F64
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
    rc = fn(m, n, k, op["group"], units, sh["unit"], nfix,
            op["indptr"].data_ptr(), op["indices"].data_ptr(),
            op["data"].data_ptr(), sh["part"].data_ptr(),
            sh["fix"].data_ptr(), sh["fix_lo"].data_ptr(), x.data_ptr(),
            None if y is None else y.data_ptr(), alpha, beta, out.data_ptr(),
            carry.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spmm_csr launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")
    if vt == torch.float64:
        LAUNCHES_F64 += 1
    else:
        LAUNCHES += 1
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


def _emulate_runs(op: dict, prods: np.ndarray, dt) -> tuple:
    """K = 1: each share's lanes walk their runs of the merged path as
    ``spmv_merge_kernel`` does. Returns the raw row sums (the epilogue not
    applied), a mask of the rows a share began inside (written raw), and
    each share's carry."""
    m, _ = op["shape"]
    sh = op["spmv"]
    part = sh["part"].cpu().numpy().astype(np.int64)
    indptr = op["indptr"].cpu().numpy().astype(np.int64)
    unit = sh["unit"]
    ipt = -(-unit // WARP)
    sums = np.zeros(m, dtype=dt)
    raw = np.zeros(m, dtype=bool)
    carry = np.zeros(len(part) - 1, dtype=dt)
    for u in range(len(part) - 1):
        (r0, j0), (r1, j1) = part[u], part[u + 1]
        rows, nnz = r1 - r0, j1 - j0
        total = rows + nnz
        ends = indptr[r0 + 1:r1 + 1]
        first_cut = indptr[r0] < j0
        keys, vals, firsts = [], [], []
        for lane in range(WARP):
            d0 = min(lane * ipt, total)
            d1 = min(d0 + ipt, total)
            # the merge-path search along diagonal d0
            lo, hi = max(d0 - nnz, 0), min(d0, rows)
            while lo < hi:
                mid = (lo + hi) // 2
                if ends[mid] <= j0 + d0 - mid - 1:
                    lo = mid + 1
                else:
                    hi = mid
            ri, ni, ri0 = lo, d0 - lo, lo
            run, first = dt(0), None
            for _ in range(d0, d1):
                if ri < rows and ends[ri] <= j0 + ni:
                    if first is None:
                        first = run
                    else:
                        sums[r0 + ri] = run
                    run = dt(0)
                    ri += 1
                else:
                    run = dt(run + prods[j0 + ni])
                    ni += 1
            keys.append(ri)
            vals.append(run)
            firsts.append((ri0, first))
        # the segmented scan over the lanes (Hillis-Steele, keyed by the
        # open row), as the shuffles add
        off = 1
        while off < WARP:
            vals = [dt(vals[i - off] + vals[i]) if i >= off and
                    keys[i - off] == keys[i] else vals[i]
                    for i in range(WARP)]
            off *= 2
        for lane, (ri0, first) in enumerate(firsts):
            if first is not None:
                s = dt(vals[lane - 1] + first) if lane else first
                sums[r0 + ri0] = s
                raw[r0 + ri0] = ri0 == 0 and first_cut
        if r1 < m:
            carry[u] = vals[WARP - 1]
    return sums, raw, carry


def spmm_csr_emulate(op: dict, x: torch.Tensor, alpha: float = 1.0,
                     beta: float = 0.0,
                     y: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's partition on the CPU. At K = 1, each share's 32 lanes
    walk their runs of the merged path and meet in the segmented scan
    (:func:`_emulate_runs`); at K > 1 each share sums the rows it ends.
    Either way the row a share ends inside goes to its carry, and a row it
    begins inside stays raw until the fix-up adds the carries of the shares
    from ``fix_lo`` to it as ``spmm_csr_fixup`` does: up to ``SHORT_FIX``
    in order; more, lane ``l`` of 32 takes every 32nd into ``FIX_BATCH``
    sums in turn, a tree adds those, and a tree adds the lanes."""
    m, _ = op["shape"]
    k = x.shape[1]
    sh = shares(op, k)
    part = sh["part"].cpu().tolist()
    indptr = op["indptr"].cpu().tolist()
    vt = x.dtype
    _, prods = _products(op, x, vt)
    prods = prods.cpu()
    if k == 1:
        dt = np.float64 if vt == torch.float64 else np.float32
        sums, raw_np, carry_np = _emulate_runs(op, prods[:, 0].numpy(), dt)
        out = torch.from_numpy(sums)[:, None]
        raw = torch.from_numpy(raw_np)
        carry = torch.from_numpy(carry_np)[:, None]
    else:
        carry = torch.zeros((len(part) - 1, k), dtype=vt)
        out = torch.zeros((m, k), dtype=vt)
        raw = torch.zeros(m, dtype=torch.bool)
        for u, ((r0, j0), (r1, j1)) in enumerate(zip(part, part[1:])):
            first_cut = indptr[r0] < j0
            for r in range(r0, r1 + (1 if r1 < m else 0)):
                s = prods[max(indptr[r], j0):min(indptr[r + 1], j1)].sum(0)
                if r == r1:
                    carry[u] = s
                else:
                    out[r] = s
                    raw[r] = r == r0 and first_cut
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
