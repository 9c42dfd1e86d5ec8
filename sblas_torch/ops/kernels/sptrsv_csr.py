"""Sync-free triangular-solve kernel wrapper: the port of the JAX package's
two wavefront kernels (``sblas/ops/kernels/sptrsv_pallas.py:_kernel`` and
``:_kernel_m``), one kernel here, and in its f64 build of the f64-class
solves of ``sblas/ops/kernels/sptrsv_ds.py`` (f32 wavefront solves refined
through double-single residual SpMVs), which it computes in f64 directly.

:func:`prepare` checks a host triangular CSR once (square, f32 or f64
values, a full nonzero diagonal unless ``unit_diagonal``), computes its
dependency levels (:func:`sblas_torch.levels.level_schedule`) and uploads
the matrix with ``inv_diag`` in the values' dtype, and with the kernel's
ticket order ``perm`` (:func:`ticket_order`: level by level, small levels
grouped). :func:`sptrsv_csr` then
computes ``x = op(L)^{-1} b`` for ``b`` of the values' dtype, of shape
``(n,)`` or row-major ``(n, K)``. On CUDA tensors it
launches the hand-written kernel of ``sblas_torch/csrc/sptrsv_csr.cu`` (see
the note there); on CPU tensors it runs :func:`sptrsv_csr_reference`, the
plain torch version, level by level. There is no fallback from one to the
other. :func:`sptrsv_csr_emulate` runs the kernel's own order of work on
the CPU (rows in ticket order, ``perm``, each row summed lane by lane then
by the shuffle tree), for tests on tiny matrices.

The kernel's flags (one int a row, and the ticket) are scratch that each
call takes from torch's caching allocator and the kernel clears on the
launch's stream: two solves on two streams never share them, and a solve
can be captured in a CUDA graph.

``LAUNCHES`` counts launches of the f32 build, ``LAUNCHES_F64`` those of
the f64 build, so that a run can show which build its main path went
through. While a ``torch.profiler`` records, one launch in
``trace.COUNT_EVERY`` takes the kernel's counting variant, which adds each
row's cycles by step into the buffer of
:func:`sblas_torch.trace.solve_counts_buffer` (same bits; see the note in
the source); every other launch takes the plain kernel.
"""

from __future__ import annotations

import ctypes
from fractions import Fraction

import numpy as np
import torch

from ... import trace
from ...formats import CSR, cast, check_uploadable, to_device, upload
from ...levels import level_schedule
from ...sptrsv_schedule import diagonal
from ._build import entry

LAUNCHES = 0
LAUNCHES_F64 = 0

_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_int,          # n k lower
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # indptr..values
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # inv_diag perm b
             ctypes.c_void_p, ctypes.c_void_p,                   # x flags
             ctypes.c_void_p, ctypes.c_void_p]                   # counts stream
# value dtype -> (C symbol, its argument types: pointers and ints only, the
# same for both builds)
_SYMBOLS = {torch.float32: ("sblas_sptrsv_csr_f32", _ARGTYPES),
            torch.float64: ("sblas_sptrsv_csr_f64", _ARGTYPES)}
WARP = 32       # lanes a row takes (csrc/sptrsv_csr.cu)
# rows a group of consecutive small levels may hold in the ticket order:
# about a quarter of the ~8,400 warps an H100 holds resident, so that
# several groups are in flight together (the fastest of 512-4,096 on the
# factors chip_smoke.py solves; PERF.md)
GROUP_ROWS = 2048


@trace.span("sblas.ticket_order", "levels")
def ticket_order(levels: np.ndarray, lower: bool,
                 group_rows: int = GROUP_ROWS) -> np.ndarray:
    """The kernel's ticket order (int32 rows): the levels in turn, with
    consecutive levels of few rows merged into groups of about
    ``group_rows`` rows, and the rows of a group by row index (descending
    for upper). A level of more than ``group_rows`` rows is a group of its
    own. Every dependency of a row comes before it: it lies on a lower
    level, so in the same group or an earlier one, and in the same group
    at a lower row (a higher one for upper). ``group_rows = 0`` gives the
    plain level order (each level a group)."""
    levels = np.asarray(levels, dtype=np.int64)
    n = len(levels)
    sizes = np.bincount(levels)
    if group_rows > 0 and len(sizes):
        # a new group where the rows before a level cross a multiple of
        # group_rows, and at and after each level larger than group_rows
        before = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        big = sizes > group_rows
        new = np.ones(len(sizes), dtype=bool)
        new[1:] = (before[1:] // group_rows != before[:-1] // group_rows) \
            | big[1:] | big[:-1]
        group = np.cumsum(new)[levels]
    else:
        group = levels
    rows = np.arange(n, dtype=np.int64)
    return np.lexsort((rows if lower else -rows, group)).astype(np.int32)


def prepare(l: CSR, device, *, lower: bool = True,
            unit_diagonal: bool = False) -> dict:
    """The operand :func:`sptrsv_csr` takes: ``l`` checked and uploaded to
    ``device`` (``to_device``'s ``shape``/``indptr``/``indices``/``data``),
    plus ``inv_diag`` (f32, 1 for ``unit_diagonal``), ``lower``, and the
    host ``levels``/``nlevels`` the plain version walks, and the ticket
    order ``perm`` (int32 on ``device``, :func:`ticket_order`: every row's
    dependencies come before it). Raises
    ``ValueError`` for a matrix that is not square or not f32 or f64, or a
    missing or zero diagonal entry."""
    n, n2 = l.shape
    if n != n2:
        raise ValueError(f"sptrsv needs a square matrix, got {l.shape}")
    if check_uploadable(l) not in _SYMBOLS:
        raise ValueError(f"the sync-free kernel takes f32 or f64 values, got "
                         f"{l.dtype}; use method='tiles'")
    if l.nnz and int(l.indices.max()) >= n:
        # a column past the last row would send the kernel's wait to a
        # flag no row ever sets
        raise ValueError(f"column index {int(l.indices.max())} >= n = {n}")
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"sptrsv_csr runs on cuda or cpu, not {device}")
    inv_diag = cast(1.0 / diagonal(l, unit_diagonal), l.dtype)
    levels, nlevels = level_schedule(l.indptr, l.indices, n, lower=lower)
    perm = ticket_order(levels, lower)
    return {**to_device(l, device), "inv_diag": upload(inv_diag, device),
            "lower": bool(lower), "levels": levels, "nlevels": nlevels,
            "perm": upload(perm, device)}


def row_order(op: dict) -> dict:
    """``op`` with the tickets in row order (``0..n-1`` lower, ``n-1..0``
    upper: every dependency still comes first): the order the kernel took
    before level order, for timing the two side by side."""
    n, _ = op["shape"]
    perm = torch.arange(n, dtype=torch.int32, device=op["indptr"].device)
    return {**op, "perm": perm if op["lower"] else perm.flip(0)}



def _as_2d(op: dict, b: torch.Tensor) -> torch.Tensor:
    n, _ = op["shape"]
    dev = op["indptr"].device
    dt = op["data"].dtype
    if b.dtype != dt or b.dim() not in (1, 2) or b.shape[0] != n:
        short = "f64" if dt == torch.float64 else "f32"
        raise ValueError(f"b must be {short} of shape ({n},) or ({n}, K), "
                         f"got {b.dtype} {tuple(b.shape)}")
    if b.device != dev:
        raise ValueError(f"b is on {b.device}, the matrix on {dev}")
    if not b.is_contiguous():
        raise ValueError("b must be contiguous (row-major)")
    return b.view(n, 1) if b.dim() == 1 else b


def sptrsv_csr(op: dict, b: torch.Tensor) -> torch.Tensor:
    """``x = op(L)^{-1} b`` for the operand ``op`` of :func:`prepare`, ``b``
    of the values' dtype and shape ``(n,)`` or ``(n, K)``; ``x`` has ``b``'s
    shape.

    The kernel solves rows in the order ``op["perm"]``, which must list
    every row after its dependencies (:func:`row_order` gives the order
    of rows by index).

    The kernel launches on the current stream of the tensors' device, which
    must be the current device."""
    global LAUNCHES, LAUNCHES_F64
    n, _ = op["shape"]
    b2 = _as_2d(op, b)
    dev = b2.device
    if dev.type == "cpu":
        return sptrsv_csr_reference(op, b)
    k = b2.shape[1]
    out = torch.empty_like(b2)
    if n == 0 or k == 0:
        return out.view(b.shape)
    flags = torch.empty(n + 1, dtype=torch.int32, device=dev)
    counts = trace.solve_counts_buffer(dev, n)
    fn, err = entry(*_SYMBOLS[b2.dtype])
    rc = fn(n, k, int(op["lower"]), op["indptr"].data_ptr(),
            op["indices"].data_ptr(), op["data"].data_ptr(),
            op["inv_diag"].data_ptr(), op["perm"].data_ptr(), b2.data_ptr(),
            out.data_ptr(), flags.data_ptr(),
            None if counts is None else counts.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sptrsv_csr launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")
    if b2.dtype == torch.float64:
        LAUNCHES_F64 += 1
    else:
        LAUNCHES += 1
    return out.view(b.shape)


def _plain_operand(op: dict) -> dict:
    """The plain version's walk, built once per operand on its device: rows
    and strict-side entries grouped by level, with the host boundaries of
    each level (so that a solve makes no host round trip, and can be
    captured in a CUDA graph)."""
    if "_plain" not in op:
        n, _ = op["shape"]
        dev = op["indptr"].device
        levels = op["levels"]
        lv = torch.from_numpy(levels.astype(np.int64)).to(dev)
        rows = torch.repeat_interleave(
            torch.arange(n, device=dev), op["indptr"].diff().long(),
            output_size=op["indices"].numel())
        cols = op["indices"].long()
        strict = cols < rows if op["lower"] else cols > rows
        rows, cols, vals = rows[strict], cols[strict], op["data"][strict]
        ent_lv = lv[rows]
        order = torch.argsort(ent_lv, stable=True)
        nlev = op["nlevels"]
        row_ptr = np.concatenate([[0], np.cumsum(
            np.bincount(levels, minlength=nlev))]).tolist()
        ent_ptr = [0, *torch.bincount(ent_lv, minlength=nlev).cumsum(0)
                   .tolist()] if nlev else [0]
        op["_plain"] = {
            "rows_by_level": torch.argsort(lv, stable=True),
            "row_ptr": row_ptr, "ent_ptr": ent_ptr,
            "rows": rows[order], "cols": cols[order],
            "vals": vals[order].double()}
    return op["_plain"]


def sptrsv_csr_reference(op: dict, b: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel: level by level, one gather of
    ``x``, one ``index_add_`` of the products and one scale per level. Each
    row's sum is taken in f64 and ``x`` is rounded to the values' dtype once
    per row, as the kernel stores it (no rounding in f64)."""
    n, _ = op["shape"]
    b2 = _as_2d(op, b)
    w = _plain_operand(op)
    k = b2.shape[1]
    x = torch.zeros((n, k), dtype=b2.dtype, device=b2.device)
    acc = torch.zeros((n, k), dtype=torch.float64, device=b2.device)
    inv = op["inv_diag"]
    rp, ep = w["row_ptr"], w["ent_ptr"]
    for lvl in range(op["nlevels"]):
        e0, e1 = ep[lvl], ep[lvl + 1]
        if e1 > e0:
            acc.index_add_(0, w["rows"][e0:e1], w["vals"][e0:e1, None]
                           * x[w["cols"][e0:e1]].double())
        rs = w["rows_by_level"][rp[lvl]:rp[lvl + 1]]
        x[rs] = ((b2[rs].double() - acc[rs])
                 * inv[rs, None].double()).to(x.dtype)
    return x.view(b.shape)


def _fma(a, b, c, dtype):
    """``a * b + c`` rounded once to ``dtype``: exact in rationals for f64
    (``int / int`` in Python rounds correctly), through f64 for f32 (which
    can differ from one rounding in rare ties)."""
    if dtype == np.float64:
        return float(Fraction(float(a)) * Fraction(float(b))
                     + Fraction(float(c)))
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def sptrsv_csr_emulate(op: dict, b: torch.Tensor) -> torch.Tensor:
    """The kernel's order of work on the CPU, for tiny matrices: rows in
    ticket order (``op["perm"]``); lane ``l`` of 32 sums
    the row's ``l``-th, ``l+32``-th, ... entry (forward for lower, backward
    for upper) with fused multiply-adds in the values' dtype (:func:`_fma`);
    a shuffle tree adds the 32 sums (lane ``i`` takes lane ``i + off`` for
    off = 16 .. 1); then ``x = (b - sum) * inv_diag``."""
    n, _ = op["shape"]
    b2 = _as_2d(op, b).cpu().numpy()
    k = b2.shape[1]
    dt = b2.dtype
    indptr = op["indptr"].cpu().numpy()
    indices = op["indices"].cpu().numpy()
    data = op["data"].cpu().numpy()
    inv = op["inv_diag"].cpu().numpy()
    lower = op["lower"]
    x = np.zeros((n, k), dtype=dt)
    for row in op["perm"].cpu().tolist():
        ents = np.arange(indptr[row], indptr[row + 1])
        if not lower:
            ents = ents[::-1]
        acc = np.zeros((WARP, k), dtype=dt)
        for lane in range(WARP):
            for j in ents[lane::WARP]:
                c = indices[j]
                if (c < row) if lower else (c > row):
                    for p in range(k):
                        acc[lane, p] = _fma(data[j], x[c, p], acc[lane, p],
                                            dt)
        off = WARP // 2
        while off:
            acc[:off] = acc[:off] + acc[off:2 * off]
            off //= 2
        x[row] = (b2[row] - acc[0]) * inv[row]
    return torch.from_numpy(x).view(b.shape).to(b.device)
