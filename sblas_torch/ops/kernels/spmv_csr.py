"""CSR SpMV kernel wrapper: the port of ``sblas/ops/kernels/spmv_pallas.py``
and, in its f64 build, of ``sblas/ops/kernels/spmv_wsell_ds.py``.

:func:`prepare` checks a matrix uploaded by
:func:`sblas_torch.formats.to_device` once (f32, bf16 or f64 values, int32
indices, one device) and adds the launch's lanes per row, ``"group"``.
:func:`spmv_csr` then computes ``y_out = alpha * A @ x + beta * y`` for
``x``/``y`` of the operand's vector dtype (:func:`vector_dtype`: f32 for f32
and bf16 values, f64 for f64 values), checking only those. On CUDA tensors
it launches the hand-written kernel of ``sblas_torch/csrc/spmv_csr.cu`` (see
the note there); on CPU tensors it runs :func:`spmv_csr_reference`, the
plain torch version of the same function. There is no fallback from one to
the other.

``LAUNCHES`` counts launches of the f32 and bf16 builds, ``LAUNCHES_F64``
those of the f64 build, so that a run can show which build its main path
went through.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import entry

LAUNCHES = 0
LAUNCHES_F64 = 0

GROUPS = (2, 4, 8, 16, 32)


def _argtypes(scalar) -> list:
    """The C entry point's argument types; ``scalar`` is alpha's and beta's
    (a ``c_float`` for the f64 build would round alpha = 1/3 to f32)."""
    return [ctypes.c_int, ctypes.c_int,                        # m, G
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # CSR arrays
            ctypes.c_void_p, ctypes.c_void_p,                   # x, y_in
            scalar, scalar,                                     # alpha, beta
            ctypes.c_void_p, ctypes.c_void_p]                   # y_out, stream


# value dtype -> (C symbol, its argument types)
_SYMBOLS = {
    torch.float32: ("sblas_spmv_csr_f32", _argtypes(ctypes.c_float)),
    torch.bfloat16: ("sblas_spmv_csr_bf16", _argtypes(ctypes.c_float)),
    torch.float64: ("sblas_spmv_csr_f64", _argtypes(ctypes.c_double))}

MAX_GROUP = 8
# the f64 build streams 12 B a nonzero, and on the FEM band's 110 nonzeros a
# row G = 16 was its fastest width (cap 16), where f32 and bf16 are fastest
# at 8 on both FEM matrices (cap 8)
MAX_GROUP_F64 = 16


def group_size(m: int, nnz: int, value_dtype=torch.float32) -> int:
    """Lanes per row: the power of two from 2 up to the cap at or above an
    eighth of the mean row length, so that each lane takes 4 to 8 of a
    row's nonzeros until the cap: ``MAX_GROUP`` for f32 and bf16 values,
    ``MAX_GROUP_F64`` for f64. ``chip_smoke.py``'s ``group_sweep`` timed
    every width on an H100 (PERF.md): in f32 G = 8 was fastest at 58
    nnz/row (cant) and at 110 (fem-band-1M-112M); in f64 G = 16 at 110
    (491.7 µs against 549.8 at G = 8), G = 4 and 8 within 4% at 58."""
    cap = MAX_GROUP_F64 if value_dtype == torch.float64 else MAX_GROUP
    mean = nnz / max(m, 1)
    g = 2
    while g < cap and 8 * g < mean:
        g *= 2
    return g


def vector_dtype(value_dtype: torch.dtype) -> torch.dtype:
    """The dtype of ``x``, ``y``, ``alpha``, ``beta`` and the sums for
    values of ``value_dtype``: f64 for f64 values, f32 otherwise."""
    return torch.float64 if value_dtype == torch.float64 else torch.float32


def prepare(t: dict) -> dict:
    """The operand :func:`spmv_csr` takes: ``t`` checked, plus ``"group"``
    from :func:`group_size`. ``{**op, "group": g}`` launches with another
    of ``GROUPS``."""
    m, _ = t["shape"]
    indptr, indices, data = t["indptr"], t["indices"], t["data"]
    dev = indptr.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"csr kernel runs on cuda or cpu tensors, not {dev}")
    for name, ten in (("indptr", indptr), ("indices", indices),
                      ("data", data)):
        if ten.device != dev:
            raise ValueError(f"{name} is on {ten.device}, indptr on {dev}")
        if not ten.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if indptr.dtype != torch.int32 or indices.dtype != torch.int32:
        raise TypeError("indptr and indices must be int32")
    if data.dtype not in _SYMBOLS:
        raise TypeError(f"csr kernel takes f32, bf16 or f64 values, got "
                        f"{data.dtype}")
    if indptr.shape != (m + 1,) or indices.shape != data.shape:
        raise ValueError("indptr/indices/data do not match the matrix shape")
    return {**t, "group": group_size(m, indices.numel(), data.dtype)}


_SHORT = {torch.float32: "f32", torch.float64: "f64"}


def _check_vector(name: str, v: torch.Tensor, size: int, dev: torch.device,
                  dtype: torch.dtype) -> None:
    if v.dtype != dtype or v.shape != (size,):
        raise ValueError(f"{name} must be {_SHORT[dtype]} of shape ({size},), "
                         f"got {v.dtype} {tuple(v.shape)}")
    if v.device != dev:
        raise ValueError(f"{name} is on {v.device}, the matrix on {dev}")
    if not v.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def spmv_csr(op: dict, x: torch.Tensor, alpha: float = 1.0, beta: float = 0.0,
             y: torch.Tensor | None = None) -> torch.Tensor:
    """``alpha * A @ x + beta * y`` (``y`` None: ``alpha * A @ x``) for the
    operand ``op`` of :func:`prepare`.

    The kernel launches on the current stream of the tensors' device, which
    must be the current device: a stream of another device fails the launch.
    """
    global LAUNCHES, LAUNCHES_F64
    m, n = op["shape"]
    dev = op["indptr"].device
    vt = vector_dtype(op["data"].dtype)
    _check_vector("x", x, n, dev, vt)
    if y is None:
        if beta != 0.0:
            raise ValueError("beta != 0 requires y")
    else:
        _check_vector("y", y, m, dev, vt)
    if dev.type == "cpu":
        return spmv_csr_reference(op, x, alpha, beta, y)
    out = torch.empty(m, dtype=vt, device=dev)
    if m == 0:
        return out
    fn, err = entry(*_SYMBOLS[op["data"].dtype])
    rc = fn(m, op["group"], op["indptr"].data_ptr(), op["indices"].data_ptr(),
            op["data"].data_ptr(), x.data_ptr(),
            None if y is None else y.data_ptr(), alpha, beta,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spmv_csr launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")
    if vt == torch.float64:
        LAUNCHES_F64 += 1
    else:
        LAUNCHES += 1
    return out


def spmv_csr_reference(t: dict, x: torch.Tensor, alpha: float = 1.0,
                       beta: float = 0.0,
                       y: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version of the kernel: products ``data * x[indices]``
    in the vector dtype (f32, or f64 for f64 values), summed per row with
    ``index_add_``, then the same epilogue."""
    m, _ = t["shape"]
    indptr = t["indptr"]
    vt = vector_dtype(t["data"].dtype)
    rows = torch.repeat_interleave(
        torch.arange(m, device=indptr.device), indptr.diff().long(),
        output_size=t["indices"].numel())
    prods = t["data"].to(vt) * x[t["indices"]]
    out = torch.zeros(m, dtype=vt, device=x.device)
    out.index_add_(0, rows, prods)
    out = alpha * out
    if y is not None:
        out = out + beta * y
    return out
