"""SpTRSV: solve op(L) x = b for a triangular CSR L, the port of
``sblas/ops/sptrsv.py``.

Routes (``method=``, or ``'auto'``):

- ``'syncfree'`` — the hand-written CUDA sync-free kernel
                   (``kernels/sptrsv_csr.py``): natural row order, one warp a
                   row, each row waiting on its own dependencies through a
                   flag in device memory. No level schedule at solve time.
- ``'pallas'``   — the ``'syncfree'`` plan (``method == 'syncfree'``): the
                   JAX package's level-set wavefront computes the same solve.
- ``'pallas_ds'`` — the ``'syncfree'`` plan of an f64 matrix (the f64 build
                   of the kernel). The JAX package's f64-class solve is an
                   f32 wavefront refined twice through double-single
                   residual SpMVs, because Mosaic has no f64; the card solves
                   in f64 directly, so no refinement is left to port. An f32
                   matrix raises ``ValueError``, as in the JAX package.
- ``'tiles'``    — plain torch, the counterpart of the JAX package's
                   ``_solve_tiles``: a serial scan over the level tiles of
                   :func:`~sblas_torch.sptrsv_schedule.build_level_schedule`,
                   any value dtype.
- ``'jacobi'``   — through :func:`sptrsv` only: the Jacobi-sweep plan of
                   :mod:`sblas_torch.ops.sptrsv_iter`.

``'auto'`` picks ``'syncfree'`` for f32 and f64 (the kernel's two builds)
and ``'tiles'`` for any other dtype, on every device: on CPU tensors the
kernel's wrapper runs its plain torch version. A missing or zero diagonal
raises ``ValueError`` when the plan is built. The route is fixed then: a
kernel launch that fails raises, and no other route is tried.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats import as_torch_dtype, upload
from ..sptrsv_schedule import build_level_schedule, validate_schedule
from ..trace import span
from ..utils.backend import default_device
from .kernels import sptrsv_csr
from .spmv import _PLAN_CACHE

ROUTES = ("syncfree", "pallas", "tiles")
# every route of the JAX package has its counterpart here
NOT_PORTED = ()


def syncfree_bytes(n: int, nnz: int, k: int = 1, val_bytes: int = 4) -> int:
    """Bytes one sync-free solve of ``k`` columns moves: each nonzero's value
    (``val_bytes``: 4 in f32, 8 in f64) and int32 column once, ``indptr``,
    ``b`` in and ``x`` out (``k`` columns of the values' dtype), and a flag
    a row."""
    return (nnz * (val_bytes + 4) + (n + 1) * 4 + 2 * n * val_bytes * k
            + n * 4)


def solve_tiles(arrs: dict, b: torch.Tensor, n: int, tile_rows: int,
                num_tiles: int) -> torch.Tensor:
    """The tile scan for ``b`` of shape ``(n, K)``: each tile solves
    ``tile_rows`` rows of one level. The ``x`` buffer holds the solution in
    rows ``0..n-1``, a constant zero in row ``n`` (the gather target of
    padded columns) and a dump in row ``n + 1`` (the target of pad slots)."""
    k = b.shape[1]
    x = torch.zeros((n + 2, k), dtype=b.dtype, device=b.device)
    b_pad = torch.cat([b, torch.zeros((2, k), dtype=b.dtype,
                                      device=b.device)])
    slot_row, col, val, inv_diag = (arrs["slot_row"], arrs["col"],
                                    arrs["val"], arrs["inv_diag"])
    for t in range(num_tiles):
        s = slice(t * tile_rows, (t + 1) * tile_rows)
        rows = slot_row[s]
        acc = torch.einsum("rw,rwk->rk", val[s], x[col[s]])
        # pad slots carry slot_row == n: their write goes to the dump
        safe = torch.where(rows == n, n + 1, rows)
        x[safe] = (b_pad[rows] - acc) * inv_diag[s, None]
    return x[:n]


class SptrsvPlan:
    """Analysis-phase product for one triangular matrix: the route, the
    device-resident operand and the dependency levels."""

    @span("sblas.SptrsvPlan", "build")
    def __init__(self, l, *, lower: bool = True,
                 unit_diagonal: bool = False, tile_rows: int = 0,
                 method: str = "auto", validate: bool = False, device=None):
        from .common import as_csr

        l = as_csr(l)
        if l.shape[0] != l.shape[1]:
            raise ValueError(f"sptrsv needs a square matrix, got {l.shape}")
        self.shape = l.shape
        self.nnz = l.nnz
        self.dtype = as_torch_dtype(l.dtype)
        self.lower = lower
        self.unit_diagonal = unit_diagonal
        self.device = torch.device(device) if device is not None \
            else default_device()
        if method == "auto":
            kernel = l.dtype in (np.float32, np.float64)
            method = "syncfree" if kernel else "tiles"
            self.route_reason = (
                f"auto: {l.dtype} values -> {method} "
                + (f"(the sync-free kernel's {l.dtype} build)" if kernel
                   else "(the kernel takes f32 or f64 values)"))
        elif method == "pallas_ds":
            if l.dtype != np.float64:
                raise ValueError(f"pallas_ds is the f64 path, got {l.dtype}; "
                                 "use method='syncfree' for f32")
            method = "syncfree"
            self.route_reason = (
                "method='pallas_ds' requested: the 'syncfree' plan's f64 "
                "build (the JAX package refines f32 solves through "
                "double-single SpMVs because Mosaic has no f64; the card "
                "solves in f64)")
        elif method == "pallas":
            method = "syncfree"
            self.route_reason = (
                "method='pallas' requested: the 'syncfree' plan (the JAX "
                "package's level-set wavefront computes the same solve)")
        elif method in ROUTES:
            self.route_reason = f"method={method!r} requested"
        else:
            raise ValueError(f"unknown sptrsv method {method!r}")
        self.method = method
        n = l.shape[0]
        if method == "syncfree":
            # checked once here (square, f32 or f64, the diagonal), with the
            # levels
            self._op = sptrsv_csr.prepare(l, self.device, lower=lower,
                                          unit_diagonal=unit_diagonal)
            self.nlevels = self._op["nlevels"]
            self.bytes_per_iter = syncfree_bytes(n, l.nnz,
                                                 val_bytes=l.data.itemsize)
            return
        sched = build_level_schedule(l, lower=lower,
                                     unit_diagonal=unit_diagonal,
                                     tile_rows=tile_rows)
        if validate:
            validate_schedule(sched)
        self.nlevels = sched.nlevels
        self.tile_rows = sched.tile_rows
        self.num_tiles = sched.num_tiles
        self.padding_ratio = sched.padded_slots / max(n, 1)
        self._arrs = {"slot_row": upload(sched.slot_row, self.device).long(),
                      "col": upload(sched.col, self.device).long(),
                      "val": upload(sched.val, self.device),
                      "inv_diag": upload(sched.inv_diag, self.device)}
        # the schedule stream and the x/b traffic, as the JAX package counts
        es = l.data.itemsize
        self.bytes_per_iter = (sched.col.size * (4 + es)
                               + sched.padded_slots * (4 + es) + n * 2 * es)

    def __repr__(self):
        n = self.shape[0]
        return (f"SptrsvPlan({n}x{n}, nnz={self.nnz}, method={self.method!r}, "
                f"nlevels={self.nlevels}, lower={self.lower}, "
                f"device={self.device})")

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """``x = op(L)^{-1} b`` for ``b`` of shape ``(n,)`` or ``(n, K)`` on
        the plan's device, in the plan's dtype (the shared body of
        :class:`SptrsvPlan` and :class:`~sblas_torch.ops.sptrsm.SptrsmPlan`)."""
        if self.method == "syncfree":
            # the kernel's wrapper checks b
            return sptrsv_csr.sptrsv_csr(self._op, b.contiguous())
        n = self.shape[0]
        x = solve_tiles(self._arrs, b.view(n, 1) if b.dim() == 1 else b, n,
                        self.tile_rows, self.num_tiles)
        return x.view(b.shape)

    def __call__(self, b):
        n = self.shape[0]
        b = torch.as_tensor(b, dtype=self.dtype, device=self.device)
        if b.shape != (n,):
            raise ValueError(f"b must have shape ({n},), got {tuple(b.shape)}")
        return self.solve(b)


def get_plan(l, *, lower: bool = True, unit_diagonal: bool = False,
             method: str = "auto", **kw):
    """The cached plan of the CSR ``l`` (the JAX package's cache key)."""
    plans = _PLAN_CACHE.setdefault(l, {})
    key = ("sptrsv", lower, unit_diagonal, method, tuple(sorted(kw.items())))
    if key not in plans:
        if method == "jacobi":
            from .sptrsv_iter import SptrsvJacobiPlan

            plans[key] = SptrsvJacobiPlan(
                l, lower=lower, unit_diagonal=unit_diagonal, **kw)
        else:
            plans[key] = SptrsvPlan(l, lower=lower,
                                    unit_diagonal=unit_diagonal,
                                    method=method, **kw)
    return plans[key]


def sptrsv(l, b, *, lower: bool = True, unit_diagonal: bool = False,
           trans: bool = False, method: str = "auto", **kw):
    """Solve op(L) x = b, op = L^T if trans else L.

    ``lower`` describes the *stored* matrix ``l`` (CSR or CSC); with
    ``trans=True`` the solved operator's triangularity flips (the classic
    Cholesky backsolve L^T x = b given lower L). Plans are cached per
    derived matrix. ``kw`` goes to the plan: ``device=``, ``tile_rows=``,
    ``validate=``; for ``'jacobi'`` ``sweeps=``, ``spmv_method=`` and the
    SpMV plan's keywords.
    """
    from .common import as_csr

    l = as_csr(l, trans)
    if trans:
        lower = not lower
    return get_plan(l, lower=lower, unit_diagonal=unit_diagonal,
                    method=method, **kw)(b)
