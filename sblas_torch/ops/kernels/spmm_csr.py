"""nnz-balanced CSR SpMM kernel wrapper: the port of the JAX package's four
scattered-matrix kernels (``spmv_pseg.py:37``, ``spmm_pseg.py:134``,
``spmm_pseg.py:350``, ``spmm_pallas.py:30``), one kernel here.

:func:`prepare` checks a matrix uploaded by
:func:`sblas_torch.formats.to_device` once and adds the launch's partition:
the merge-path start of each warp's share (:func:`merge_path`), the shares
whose first row began in an earlier one (:func:`fixup_units`), both
uploaded with the operand, and the lanes per row. :func:`spmm_csr` then
computes ``Y_out = alpha * A @ X + beta * Y`` for f32 row-major ``X (n, K)``
and ``Y (m, K)``, any K (K = 1 is SpMV). On CUDA tensors it launches the
hand-written kernel of ``sblas_torch/csrc/spmm_csr.cu`` (see the note
there); on CPU tensors it runs :func:`spmm_csr_reference`, the plain torch
version of the same function. There is no fallback from one to the other.
:func:`spmm_csr_emulate` runs the kernel's own partition and carry fix-up
on the CPU, so that the tests can hold that part to the plain version.

``LAUNCHES`` counts calls that launched the kernel (its fix-up launch
included), so that a run can show its main path went through it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import entry
from .spmv_csr import group_size

LAUNCHES = 0

# merged-path items (row ends + nonzeros) a warp takes
UNIT = 1024
_SYMBOLS = {torch.float32: "sblas_spmm_csr_f32",
            torch.bfloat16: "sblas_spmm_csr_bf16"}
_ARGTYPES = [ctypes.c_int] * 6 + [                            # m n k G units nfix
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,         # indptr..values
    ctypes.c_void_p, ctypes.c_void_p,                          # part, fix
    ctypes.c_void_p, ctypes.c_void_p,                          # x, y_in
    ctypes.c_float, ctypes.c_float,                            # alpha, beta
    ctypes.c_void_p, ctypes.c_void_p,                          # y_out, carry
    ctypes.c_void_p]                                           # stream


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


def prepare(t: dict, unit: int = UNIT) -> dict:
    """The operand :func:`spmm_csr` takes: ``t`` checked, plus ``"group"``
    (lanes per row, :func:`~sblas_torch.ops.kernels.spmv_csr.group_size`),
    ``"unit"``, ``"part"`` and ``"fix"`` (on ``t``'s device)."""
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
        raise TypeError(f"spmm_csr takes f32 or bf16 values, got {data.dtype}")
    if indptr.shape != (m + 1,) or indices.shape != data.shape:
        raise ValueError("indptr/indices/data do not match the matrix shape")
    if unit < 1:
        raise ValueError(f"unit must be >= 1, got {unit}")
    host = indptr.cpu().numpy()
    part = merge_path(host, unit)
    return {**t, "group": group_size(m, indices.numel()), "unit": unit,
            "part": torch.from_numpy(part).to(dev),
            "fix": torch.from_numpy(fixup_units(host, part)).to(dev)}


def _check_dense(name: str, v: torch.Tensor, rows: int, k: int | None,
                 dev: torch.device) -> None:
    if v.dtype != torch.float32 or v.dim() != 2 or v.shape[0] != rows \
            or (k is not None and v.shape[1] != k):
        want = f"({rows}, {'K' if k is None else k})"
        raise ValueError(f"{name} must be f32 of shape {want}, got "
                         f"{v.dtype} {tuple(v.shape)}")
    if v.device != dev:
        raise ValueError(f"{name} is on {v.device}, the matrix on {dev}")
    if not v.is_contiguous():
        raise ValueError(f"{name} must be contiguous (row-major)")


def spmm_csr(op: dict, x: torch.Tensor, alpha: float = 1.0, beta: float = 0.0,
             y: torch.Tensor | None = None) -> torch.Tensor:
    """``alpha * A @ X + beta * Y`` (``Y`` None: ``alpha * A @ X``) for the
    operand ``op`` of :func:`prepare`, f32 ``X (n, K)``, any K >= 0.

    The kernel launches on the current stream of the tensors' device, which
    must be the current device.
    """
    global LAUNCHES
    m, n = op["shape"]
    dev = op["indptr"].device
    _check_dense("X", x, n, None, dev)
    k = x.shape[1]
    if y is None:
        if beta != 0.0:
            raise ValueError("beta != 0 requires Y")
    else:
        _check_dense("Y", y, m, k, dev)
    if dev.type == "cpu":
        return spmm_csr_reference(op, x, alpha, beta, y)
    out = torch.empty((m, k), dtype=torch.float32, device=dev)
    if m == 0 or k == 0:
        return out
    units = op["part"].shape[0] - 1
    nfix = op["fix"].numel()
    carry = torch.empty((units, k), dtype=torch.float32, device=dev)
    fn, err = entry(_SYMBOLS[op["data"].dtype], _ARGTYPES)
    rc = fn(m, n, k, op["group"], units, nfix, op["indptr"].data_ptr(),
            op["indices"].data_ptr(), op["data"].data_ptr(),
            op["part"].data_ptr(), op["fix"].data_ptr(), x.data_ptr(),
            None if y is None else y.data_ptr(), alpha, beta, out.data_ptr(),
            carry.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spmm_csr launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")
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
    (the products of f32 values are exact there) and rounded to f32 once.
    A row of a web graph holds 10^5 nonzeros and more; summed in f32 one
    after the other, as ``index_add_`` does, it is off from the exact sum by
    more than the kernel's tree of partial sums is (1.3e-5 of max |Y| on
    uk-2002 at 5%, against scipy), so the plain version sums in f64."""
    m, _ = t["shape"]
    rows, prods = _products(t, x, torch.float64)
    out = torch.zeros((m, x.shape[1]), dtype=torch.float64, device=x.device)
    out.index_add_(0, rows, prods)
    return _epilogue(out, alpha, beta,
                     None if y is None else y.double()).float()


def spmm_csr_emulate(op: dict, x: torch.Tensor, alpha: float = 1.0,
                     beta: float = 0.0,
                     y: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's partition on the CPU: each share of ``op["part"]`` sums
    the rows it ends; the row it ends inside goes to its carry; a row it
    begins inside stays raw until the fix-up adds the carries of the shares
    before it, nearest first, as ``spmm_csr_fixup`` does."""
    m, _ = op["shape"]
    k = x.shape[1]
    part = op["part"].cpu().tolist()
    indptr = op["indptr"].cpu().tolist()
    _, prods = _products(op, x, torch.float32)
    prods = prods.cpu()
    carry = torch.zeros((len(part) - 1, k), dtype=torch.float32)
    out = torch.zeros((m, k), dtype=torch.float32)
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
    done = _epilogue(out, alpha, beta, None if y is None else y.cpu())
    for b in op["fix"].tolist():
        r, _ = part[b]
        s = out[r].clone()
        while True:
            b -= 1
            s += carry[b]
            if part[b][0] != r or part[b][1] <= indptr[r]:
                break
        done[r] = _epilogue(s, alpha, beta, None if y is None else y[r].cpu())
        raw[r] = False
    if raw.any():
        raise RuntimeError("rows written raw that no fix-up completes: "
                           f"{torch.flatnonzero(raw).tolist()[:8]}")
    return done.to(x.device)
