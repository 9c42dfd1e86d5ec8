"""Dense-block SpMM kernel wrapper: the port of
``sblas/ops/kernels/spmm_bsr_pallas.py`` (its three kernels are one here).

:func:`bsr_to_device` uploads a :class:`~sblas_torch.retile_bsr.BsrBlocks`
as the operand the kernel reads: ``bptr``/``bcol`` int32 and the blocks
transposed, ``(nblocks, bc, br)``, in the value dtype. :func:`prepare`
checks that operand once. :func:`spmm_bsr` then computes
``Y_out = alpha * A @ X + beta * Y`` for f32 row-major ``X (n, K)`` and
``Y (m, K)``, checking only those. On CUDA tensors it launches the
hand-written kernel of ``sblas_torch/csrc/spmm_bsr.cu`` (see the note there);
on CPU tensors it runs :func:`spmm_bsr_reference`, the plain torch version
of the same function. There is no fallback from one to the other.

``LAUNCHES`` counts kernel launches, so that a run can show its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ...formats import upload
from ...retile_bsr import BsrBlocks
from ._build import entry

LAUNCHES = 0

BLOCK_ROWS = (64, 128)
BLOCK_COLS = 128
_SYMBOLS = {torch.float32: "sblas_spmm_bsr_f32",
            torch.bfloat16: "sblas_spmm_bsr_bf16"}
_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # m n k br
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # bptr bcol blocks
             ctypes.c_void_p, ctypes.c_void_p,                   # x, y_in
             ctypes.c_float, ctypes.c_float,                     # alpha, beta
             ctypes.c_void_p, ctypes.c_void_p]                   # y_out, stream


def bsr_to_device(bsr: BsrBlocks, device, value_dtype=None) -> dict:
    """``{"shape", "br", "bptr", "bcol", "blocks_t"}`` on ``device``:
    ``blocks_t`` is :meth:`BsrBlocks.blocks_t` in ``value_dtype`` (default:
    the blocks' own), rounded to nearest even for bf16."""
    device = torch.device(device)
    blocks_t = upload(bsr.blocks_t(), device)
    if value_dtype is not None:
        blocks_t = blocks_t.to(value_dtype)
    return {"shape": (bsr.m, bsr.n), "br": bsr.br,
            "bptr": upload(bsr.bptr, device), "bcol": upload(bsr.bcol, device),
            "blocks_t": blocks_t}


def prepare(t: dict) -> dict:
    """The operand :func:`spmm_bsr` takes: ``t`` checked once (one device,
    int32 pointers, f32 or bf16 blocks of ``(bc, br)``, ``bptr`` of
    ``ceil(m / br) + 1`` entries)."""
    m, _ = t["shape"]
    br, bptr, bcol, blocks = t["br"], t["bptr"], t["bcol"], t["blocks_t"]
    dev = bptr.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"block kernel runs on cuda or cpu tensors, not {dev}")
    for name, ten in (("bptr", bptr), ("bcol", bcol), ("blocks_t", blocks)):
        if ten.device != dev:
            raise ValueError(f"{name} is on {ten.device}, bptr on {dev}")
        if not ten.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bptr.dtype != torch.int32 or bcol.dtype != torch.int32:
        raise TypeError("bptr and bcol must be int32")
    if blocks.dtype not in _SYMBOLS:
        raise TypeError(f"block kernel takes f32 or bf16 values, got "
                        f"{blocks.dtype}")
    if br not in BLOCK_ROWS:
        raise ValueError(f"block rows must be one of {BLOCK_ROWS}, got {br}")
    nb = bcol.numel()
    if (bptr.shape != (-(-max(m, 1) // br) + 1,)
            or blocks.shape != (nb, BLOCK_COLS, br)):
        raise ValueError("bptr/bcol/blocks_t do not match the matrix shape")
    return dict(t)


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


def spmm_bsr(op: dict, x: torch.Tensor, alpha: float = 1.0, beta: float = 0.0,
             y: torch.Tensor | None = None) -> torch.Tensor:
    """``alpha * A @ X + beta * Y`` (``Y`` None: ``alpha * A @ X``) for the
    operand ``op`` of :func:`prepare`, f32 ``X (n, K)``, any K >= 0.

    The kernel launches on the current stream of the tensors' device, which
    must be the current device.
    """
    global LAUNCHES
    m, n = op["shape"]
    dev = op["bptr"].device
    _check_dense("X", x, n, None, dev)
    k = x.shape[1]
    if y is None:
        if beta != 0.0:
            raise ValueError("beta != 0 requires Y")
    else:
        _check_dense("Y", y, m, k, dev)
    if dev.type == "cpu":
        return spmm_bsr_reference(op, x, alpha, beta, y)
    out = torch.empty((m, k), dtype=torch.float32, device=dev)
    if m == 0 or k == 0:
        return out
    fn, err = entry(_SYMBOLS[op["blocks_t"].dtype], _ARGTYPES)
    rc = fn(m, n, k, op["br"], op["bptr"].data_ptr(), op["bcol"].data_ptr(),
            op["blocks_t"].data_ptr(), x.data_ptr(),
            None if y is None else y.data_ptr(), alpha, beta, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spmm_bsr launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")
    LAUNCHES += 1
    return out


def spmm_bsr_reference(t: dict, x: torch.Tensor, alpha: float = 1.0,
                       beta: float = 0.0,
                       y: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version of the kernel: the X panels gathered by ``bcol``,
    one ``torch.bmm`` over the blocks, ``index_add_`` over the block-rows,
    then the same epilogue. Sums in f32 (f64 for f64 blocks)."""
    m, n = t["shape"]
    br, bptr, bcol = t["br"], t["bptr"], t["bcol"]
    k = x.shape[1]
    acc = torch.float64 if t["blocks_t"].dtype == torch.float64 \
        else torch.float32
    num_brows = bptr.numel() - 1
    num_bcols = -(-max(n, 1) // BLOCK_COLS)
    xp = torch.zeros((num_bcols * BLOCK_COLS, k), dtype=acc, device=x.device)
    xp[:n] = x
    panels = xp.view(num_bcols, BLOCK_COLS, k)[bcol.long()]
    blocks = t["blocks_t"].to(acc).transpose(1, 2)          # (nb, br, bc)
    brow = torch.repeat_interleave(
        torch.arange(num_brows, device=x.device), bptr.diff().long(),
        output_size=bcol.numel())
    out = torch.zeros((num_brows, br, k), dtype=acc, device=x.device)
    out.index_add_(0, brow, torch.bmm(blocks, panels))
    out = alpha * out.view(num_brows * br, k)[:m]
    if y is not None:
        out = out + beta * y
    return out
