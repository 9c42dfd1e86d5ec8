"""CSR SpMV kernel wrapper: the port of ``sblas/ops/kernels/spmv_pallas.py``.

:func:`prepare` checks a matrix uploaded by
:func:`sblas_torch.formats.to_device` once (f32 or bf16 values, int32
indices, one device) and adds the launch's lanes per row, ``"group"``.
:func:`spmv_csr` then computes ``y_out = alpha * A @ x + beta * y`` for f32
``x``/``y``, checking only those. On CUDA tensors it launches the
hand-written kernel of ``sblas_torch/csrc/spmv_csr.cu`` (see the note there);
on CPU tensors it runs :func:`spmv_csr_reference`, the plain torch version
of the same function. There is no fallback from one to the other.

``LAUNCHES`` counts kernel launches, so that a run can show its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import entry

LAUNCHES = 0

GROUPS = (2, 4, 8, 16, 32)
_SYMBOLS = {torch.float32: "sblas_spmv_csr_f32",
            torch.bfloat16: "sblas_spmv_csr_bf16"}
_ARGTYPES = [ctypes.c_int, ctypes.c_int,                        # m, G
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # indptr..values
             ctypes.c_void_p, ctypes.c_void_p,                   # x, y_in
             ctypes.c_float, ctypes.c_float,                     # alpha, beta
             ctypes.c_void_p, ctypes.c_void_p]                   # y_out, stream

MAX_GROUP = 8


def group_size(m: int, nnz: int) -> int:
    """Lanes per row: the power of two in 2..8 at or above an eighth of the
    mean row length, so that each lane takes 4 to 8 of a row's nonzeros
    until the cap. ``chip_smoke.py``'s ``group_sweep`` timed every width
    on an H100 (PERF.md): G = 8 was fastest at 58 nnz/row (cant) and at
    110 (fem-band-1M-112M), and G = 16 and 32 slower at both."""
    mean = nnz / max(m, 1)
    g = 2
    while g < MAX_GROUP and 8 * g < mean:
        g *= 2
    return g


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
        raise TypeError(f"csr kernel takes f32 or bf16 values, got {data.dtype}")
    if indptr.shape != (m + 1,) or indices.shape != data.shape:
        raise ValueError("indptr/indices/data do not match the matrix shape")
    return {**t, "group": group_size(m, indices.numel())}


def _check_vector(name: str, v: torch.Tensor, size: int,
                  dev: torch.device) -> None:
    if v.dtype != torch.float32 or v.shape != (size,):
        raise ValueError(f"{name} must be f32 of shape ({size},), got "
                         f"{v.dtype} {tuple(v.shape)}")
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
    global LAUNCHES
    m, n = op["shape"]
    dev = op["indptr"].device
    _check_vector("x", x, n, dev)
    if y is None:
        if beta != 0.0:
            raise ValueError("beta != 0 requires y")
    else:
        _check_vector("y", y, m, dev)
    if dev.type == "cpu":
        return spmv_csr_reference(op, x, alpha, beta, y)
    out = torch.empty(m, dtype=torch.float32, device=dev)
    if m == 0:
        return out
    fn, err = entry(_SYMBOLS[op["data"].dtype], _ARGTYPES)
    rc = fn(m, op["group"], op["indptr"].data_ptr(), op["indices"].data_ptr(),
            op["data"].data_ptr(), x.data_ptr(),
            None if y is None else y.data_ptr(), alpha, beta,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spmv_csr launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")
    LAUNCHES += 1
    return out


def spmv_csr_reference(t: dict, x: torch.Tensor, alpha: float = 1.0,
                       beta: float = 0.0,
                       y: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version of the kernel: products ``data * x[indices]``
    in f32, summed per row with ``index_add_``, then the same epilogue."""
    m, _ = t["shape"]
    indptr = t["indptr"]
    rows = torch.repeat_interleave(
        torch.arange(m, device=indptr.device), indptr.diff().long(),
        output_size=t["indices"].numel())
    prods = t["data"].float() * x[t["indices"]]
    out = torch.zeros(m, dtype=torch.float32, device=x.device)
    out.index_add_(0, rows, prods)
    out = alpha * out
    if y is not None:
        out = out + beta * y
    return out
