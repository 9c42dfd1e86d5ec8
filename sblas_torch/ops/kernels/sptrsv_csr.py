"""Sync-free triangular-solve kernel wrapper: the port of the JAX package's
two wavefront kernels (``sblas/ops/kernels/sptrsv_pallas.py:_kernel`` and
``:_kernel_m``), one kernel here.

:func:`prepare` checks a host triangular CSR once (square, f32 values, a
full nonzero diagonal unless ``unit_diagonal``), computes its dependency
levels (:func:`sblas_torch.levels.level_schedule`) and uploads the matrix
with ``inv_diag``. :func:`sptrsv_csr` then computes ``x = op(L)^{-1} b``
for f32 ``b`` of shape ``(n,)`` or row-major ``(n, K)``. On CUDA tensors it
launches the hand-written kernel of ``sblas_torch/csrc/sptrsv_csr.cu`` (see
the note there); on CPU tensors it runs :func:`sptrsv_csr_reference`, the
plain torch version, level by level. There is no fallback from one to the
other. :func:`sptrsv_csr_emulate` runs the kernel's own order of work on
the CPU (rows in ticket order, each row summed lane by lane then by the
shuffle tree), for tests on tiny matrices.

The kernel's flags (one int a row, and the ticket) are scratch that each
call takes from torch's caching allocator and the kernel clears on the
launch's stream: two solves on two streams never share them, and a solve
can be captured in a CUDA graph.

``LAUNCHES`` counts kernel launches, so that a run can show its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...formats import CSR, check_uploadable, to_device, upload
from ...levels import level_schedule
from ...sptrsv_schedule import diagonal
from ._build import entry

LAUNCHES = 0

_SYMBOL = "sblas_sptrsv_csr_f32"
_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_int,          # n k lower
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # indptr..values
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # inv_diag b x
             ctypes.c_void_p, ctypes.c_void_p]                   # flags stream
WARP = 32       # lanes a row takes (csrc/sptrsv_csr.cu)


def prepare(l: CSR, device, *, lower: bool = True,
            unit_diagonal: bool = False) -> dict:
    """The operand :func:`sptrsv_csr` takes: ``l`` checked and uploaded to
    ``device`` (``to_device``'s ``shape``/``indptr``/``indices``/``data``),
    plus ``inv_diag`` (f32, 1 for ``unit_diagonal``), ``lower``, and the
    host ``levels``/``nlevels`` the plain version walks. Raises
    ``ValueError`` for a matrix that is not square or not f32, or a missing
    or zero diagonal entry."""
    n, n2 = l.shape
    if n != n2:
        raise ValueError(f"sptrsv needs a square matrix, got {l.shape}")
    if check_uploadable(l) != torch.float32:
        raise ValueError(f"the sync-free kernel takes f32 values, got "
                         f"{l.dtype}; use method='tiles'")
    if l.nnz and int(l.indices.max()) >= n:
        # a column past the last row would send the kernel's wait to a
        # flag no row ever sets
        raise ValueError(f"column index {int(l.indices.max())} >= n = {n}")
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"sptrsv_csr runs on cuda or cpu, not {device}")
    inv_diag = (1.0 / diagonal(l, unit_diagonal)).astype(np.float32)
    levels, nlevels = level_schedule(l.indptr, l.indices, n, lower=lower)
    return {**to_device(l, device), "inv_diag": upload(inv_diag, device),
            "lower": bool(lower), "levels": levels, "nlevels": nlevels}


def _as_2d(op: dict, b: torch.Tensor) -> torch.Tensor:
    n, _ = op["shape"]
    dev = op["indptr"].device
    if b.dtype != torch.float32 or b.dim() not in (1, 2) or b.shape[0] != n:
        raise ValueError(f"b must be f32 of shape ({n},) or ({n}, K), got "
                         f"{b.dtype} {tuple(b.shape)}")
    if b.device != dev:
        raise ValueError(f"b is on {b.device}, the matrix on {dev}")
    if not b.is_contiguous():
        raise ValueError("b must be contiguous (row-major)")
    return b.view(n, 1) if b.dim() == 1 else b


def sptrsv_csr(op: dict, b: torch.Tensor) -> torch.Tensor:
    """``x = op(L)^{-1} b`` for the operand ``op`` of :func:`prepare`, f32
    ``b`` of shape ``(n,)`` or ``(n, K)``; ``x`` has ``b``'s shape.

    The kernel launches on the current stream of the tensors' device, which
    must be the current device."""
    global LAUNCHES
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
    fn, err = entry(_SYMBOL, _ARGTYPES)
    rc = fn(n, k, int(op["lower"]), op["indptr"].data_ptr(),
            op["indices"].data_ptr(), op["data"].data_ptr(),
            op["inv_diag"].data_ptr(), b2.data_ptr(), out.data_ptr(),
            flags.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sptrsv_csr launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")
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
    row's sum is taken in f64 and ``x`` is rounded to f32 once per row, as
    the kernel stores it."""
    n, _ = op["shape"]
    b2 = _as_2d(op, b)
    w = _plain_operand(op)
    k = b2.shape[1]
    x = torch.zeros((n, k), dtype=torch.float32, device=b2.device)
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
                 * inv[rs, None].double()).float()
    return x.view(b.shape)


def sptrsv_csr_emulate(op: dict, b: torch.Tensor) -> torch.Tensor:
    """The kernel's order of work on the CPU, for tiny matrices: rows in
    ticket order (``0..n-1`` lower, ``n-1..0`` upper); lane ``l`` of 32 sums
    the row's ``l``-th, ``l+32``-th, ... entry (forward for lower, backward
    for upper) with f32 fused multiply-adds; a shuffle tree adds the 32
    sums (lane ``i`` takes lane ``i + off`` for off = 16 .. 1); then
    ``x = (b - sum) * inv_diag`` in f32. The fused multiply-add is taken in
    f64 and rounded to f32, which can differ from one rounding in rare
    ties."""
    n, _ = op["shape"]
    b2 = _as_2d(op, b).cpu().numpy()
    k = b2.shape[1]
    indptr = op["indptr"].cpu().numpy()
    indices = op["indices"].cpu().numpy()
    data = op["data"].cpu().numpy()
    inv = op["inv_diag"].cpu().numpy()
    lower = op["lower"]
    x = np.zeros((n, k), dtype=np.float32)
    for t in range(n):
        row = t if lower else n - 1 - t
        ents = np.arange(indptr[row], indptr[row + 1])
        if not lower:
            ents = ents[::-1]
        acc = np.zeros((WARP, k), dtype=np.float32)
        for lane in range(WARP):
            for j in ents[lane::WARP]:
                c = indices[j]
                if (c < row) if lower else (c > row):
                    acc[lane] = (np.float64(data[j]) * x[c].astype(np.float64)
                                 + acc[lane]).astype(np.float32)
        off = WARP // 2
        while off:
            acc[:off] = acc[:off] + acc[off:2 * off]
            off //= 2
        x[row] = (b2[row] - acc[0]) * inv[row]
    return torch.from_numpy(x).view(b.shape).to(b.device)
