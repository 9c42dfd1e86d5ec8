"""SpMM: Y = alpha * op(A) @ X + beta * Y, the port of ``sblas/ops/spmm.py``.

``X`` is dense and row-major, ``(n, K)``; ``Y`` is ``(m, K)``.

Routes (``method=``, or ``'auto'``):

- ``'block'``       — the hand-written CUDA dense-block kernel
                      (``kernels/spmm_bsr.py``) over ``block_rows x 128``
                      blocks: the counterpart of the JAX package's
                      ``'bsr_pallas_t'`` at ``block_rows=128`` (the default)
                      and of its ``'bsr_pallas'`` at ``block_rows=64``.
- ``'merge'``       — the hand-written CUDA nnz-balanced (merge-path) CSR
                      kernel (``kernels/spmm_csr.py``), all K columns in one
                      call, in the matrix's own order; its f64 build takes
                      f64 matrices.
- ``'pallas'``      — the ``'merge'`` plan (``method == 'merge'``): the JAX
                      package's w-SELL ``'pallas'`` is this function in
                      natural order.
- ``'pseg'``        — the same kernel on the hub-relabeled matrix
                      ``A[rowperm][:, colperm]``
                      (:func:`~sblas_torch.relabel.hub_relabel`), the
                      counterpart of the JAX package's ``'pseg'``, by name
                      only. ``colperm``, ``rowperm`` and
                      :meth:`SpmmPlan.apply_permuted` give the
                      permuted-space interface; the drop-in call permutes X
                      and Y around the kernel in torch, and skips that where
                      the relabeling is the identity. On the H100 the
                      relabeled order made the kernel no faster (PERF.md).
- ``'spmv_passes'`` — K launches of the port's SpMV ``auto`` plan, one per
                      column of X, as in the JAX package; on an f64 matrix
                      the csr kernel's f64 build.
- ``'pallas_ds'``   — the ``'spmv_passes'`` plan of an f64 matrix: the JAX
                      package's ds SpMM is K double-single SpMV passes, and
                      SpMV's ``'pallas_ds'`` is the csr kernel's f64 build
                      here. An f32 matrix raises ``ValueError``.
- ``'ell'``, ``'bucket'``, ``'bsr'`` — plain torch ports of the JAX
                      package's XLA routes of the same names, any value dtype.

The ``block``, ``merge`` and ``pseg`` kernels take f32 matrices, values
f32 or bf16 (``value_dtype=``); ``merge`` and ``pseg`` also f64 matrices
(the kernel's f64 build). On CPU tensors the wrappers run the kernels'
plain torch versions.

``'auto'`` for f32 matrices (values f32 or bf16), on every device, is a
bytes rule over three prices at ``k_hint`` (default 8) columns
(:meth:`SpmmPlan.prices`), each with X in and Y out: ``'block'`` streams its
blocks (:func:`bsr_stats` at ``block_rows x 128``, in the value dtype, with
their index arrays) once; ``'merge'`` streams the CSR matrix once and
gathers ``K`` floats of X a nonzero, of which the share ``X_GATHER`` costs
device-memory bytes (the rest hits in L2; the constant from H100 timings,
PERF.md); ``'spmv_passes'`` streams the CSR matrix K times. The cheapest
wins; ``'block'`` only where, on CUDA, its blocks fit in half of the free
device memory. For f64 it prices ``'merge'`` against ``'spmv_passes'``
the same way at 8-byte values and vectors (the block kernel has no f64
build), and for other dtypes (complex) it is the JAX package's XLA
heuristic. The route is fixed when the plan
is built: a kernel launch that fails raises, and no other route is tried.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats import CSR, as_torch_dtype, check_uploadable, to_device, upload
from ..retile import to_bucket_ell, to_ell
from ..retile_bsr import bsr_stats, pack_bsr
from ..utils.backend import default_device
from .kernels import spmm_csr
from .kernels.spmm_bsr import (BLOCK_COLS, BLOCK_ROWS, bsr_to_device, prepare,
                               spmm_bsr, spmm_bsr_reference)
from .spmv import (_PLAN_CACHE, SpmvPlan, csr_bytes_per_iter,
                   csr_stream_bytes)
from .spmv import xla_heuristic as spmv_xla_heuristic

ROUTES = ("block", "merge", "pallas", "pseg", "spmv_passes", "ell",
          "bucket", "bsr")
# every route of the JAX package has its counterpart here
NOT_PORTED = ()
K_HINT = 8
# what one byte of the X rows the nnz-balanced kernel gathers (K floats a
# nonzero) costs, in streamed bytes. Its time on the FEM matrices, less its
# stream, X and Y at the STREAM rate, paid 0.84-1.89 of the gathered bytes
# (H100, chip_smoke.py's x_gather_fit, PERF.md). At K = 8 any value in
# 0.97-1.12 sends cant to it (faster than the block route there) and
# consph and pdb1HYS to the block route (faster there): 1.0
X_GATHER = 1.0
# rows x width x K elements of X one ELL chunk gathers at most
_ELL_CHUNK = 1 << 22


def block_stream_bytes(nblocks: int, num_brows: int, br: int,
                       val_bytes: int) -> int:
    """Bytes of the block route's matrix stream: the blocks, ``bcol`` and
    ``bptr``."""
    return nblocks * (br * BLOCK_COLS * val_bytes + 4) + (num_brows + 1) * 4


def xla_heuristic(a: CSR) -> tuple[str, str]:
    """The JAX package's XLA pick (``SpmmPlan._xla_heuristic``), with the
    reason: ``bsr`` for dense enough blocks, else SpMV's ELL-or-bucket
    pick."""
    st = bsr_stats(a)
    if st["density"] > 0.15 and st["bytes"] < 4 << 30:
        return "bsr", f"block density {st['density']:.3f} > 0.15"
    return spmv_xla_heuristic(a)


class SpmmPlan:
    """Device-resident SpMM executor for one CSR matrix."""

    def __init__(self, a, method: str = "auto", *, block_rows: int = 128,
                 k_hint: int | None = None, value_dtype=None,
                 max_width: int = 2048, device=None):
        from .common import as_csr, relabeled

        a = as_csr(a)
        self.shape = a.shape
        self.nnz = a.nnz
        self.dtype = as_torch_dtype(a.dtype)
        self.device = torch.device(device) if device is not None \
            else default_device()
        self.k_hint = k_hint or K_HINT
        self.block_rows = block_rows
        if method == "auto":
            method, self.route_reason = self._pick(a, value_dtype)
        elif method == "pallas_ds":
            if a.dtype != np.float64:
                raise ValueError(f"pallas_ds is the f64 path, got {a.dtype}; "
                                 "use method='spmv_passes' for f32")
            method = "spmv_passes"
            self.route_reason = (
                "method='pallas_ds' requested: 'spmv_passes' over the csr "
                "kernel's f64 build (the JAX package's ds SpMM is K "
                "double-single SpMV passes)")
        elif method == "pallas":
            method = "merge"
            self.route_reason = (
                "method='pallas' requested: the 'merge' plan (the JAX "
                "package's w-SELL route computes the same product in "
                "natural order)")
        elif method in ROUTES:
            self.route_reason = f"method={method!r} requested"
        else:
            hint = " (the dense-block kernel route is 'block')" \
                if method.startswith("bsr_pallas") else ""
            raise ValueError(f"unknown spmm method {method!r}{hint}")
        self.method = method
        m, n = a.shape
        self._perms = None      # pseg: (colperm, rowperm), int64 on the device

        if method == "block":
            if a.dtype != np.float32:
                raise ValueError(f"block kernel takes f32 matrices, got "
                                 f"{a.dtype}; use bsr/ell/bucket")
            vd = check_uploadable(a, value_dtype or torch.float32)
            if vd not in (torch.float32, torch.bfloat16):
                raise ValueError(f"value_dtype must be f32 or bf16, got {vd}")
            if block_rows not in BLOCK_ROWS:
                raise ValueError(f"block_rows must be one of {BLOCK_ROWS}, "
                                 f"got {block_rows}")
            bsr = pack_bsr(a, br=block_rows, bc=BLOCK_COLS)
            # checked once here; the call checks only X and Y
            self._op = prepare(bsr_to_device(bsr, self.device, vd))
            self.nblocks, self.density = bsr.nblocks, bsr.density
            self._stream = block_stream_bytes(bsr.nblocks, bsr.num_brows,
                                              block_rows, vd.itemsize)
        elif method in ("merge", "pseg"):
            if a.dtype not in (np.float32, np.float64):
                raise ValueError(f"the {method} kernel takes f32 or f64 "
                                 f"matrices, got {a.dtype}; use ell/bucket")
            vd = check_uploadable(a, value_dtype)
            allowed = (torch.float64,) if a.dtype == np.float64 else (
                torch.float32, torch.bfloat16)
            if vd not in allowed:
                raise ValueError(f"value_dtype must be one of {allowed} for "
                                 f"a {a.dtype} matrix, got {vd}")
            ap = a
            if method == "pseg":
                ap, self.colperm, self.rowperm = relabeled(a)
                if ap is not a:     # hub_relabel returns `a` for no hubs
                    self._perms = (self._up(self.colperm),
                                   self._up(self.rowperm))
            # checked once here, with the launch's partition
            self._op = spmm_csr.prepare(to_device(ap, self.device, vd))
            self._stream = csr_stream_bytes(m, a.nnz, vd.itemsize)
        elif method == "spmv_passes":
            self._spmv = SpmvPlan(a, "auto", value_dtype=value_dtype,
                                  max_width=max_width, device=self.device)
            # each pass streams the SpMV plan's schedule, less its x and y
            es = self.dtype.itemsize
            self._pass = self._spmv.bytes_per_iter - (
                (m + n) * es if self._spmv.method in ("csr", "merge") else 0)
        elif method == "ell":
            ell = to_ell(a)
            self._val, self._col = self._up(ell.val), self._up(ell.col)
            self.fill = ell.fill
            self._stream = ell.col.size * (a.data.itemsize + 4)
        elif method == "bucket":
            be = to_bucket_ell(a, max_width=max_width)
            self._buckets = [(self._up(b.val), self._up(b.col))
                             for b in be.buckets]
            self._perm = self._up(be.perm).long()
            self.fill = be.fill
            self._stream = sum(
                b.col.size for b in be.buckets) * (a.data.itemsize + 4)
        else:  # bsr: the JAX package's XLA block route, 128 x 128 blocks
            bsr = pack_bsr(a)
            self._op = bsr_to_device(bsr, self.device)
            self.nblocks, self.density = bsr.nblocks, bsr.density
            self._stream = block_stream_bytes(bsr.nblocks, bsr.num_brows,
                                              bsr.br, a.data.itemsize)

    @staticmethod
    def prices(a: CSR, k: int, block_rows: int = 128, val_bytes: int = 4,
               vec_bytes: int = 4) -> dict:
        """Bytes each route moves for ``k`` columns by the rule's model, X
        in and Y out included (``vec_bytes`` an entry: 4 in f32, 8 in
        f64): ``{"block", "merge", "spmv_passes"}``, and the block stream
        alone as ``"block_stream"``."""
        m, n = a.shape
        br = block_rows
        st = bsr_stats(a, br=br, bc=BLOCK_COLS)
        stream = block_stream_bytes(st["nblocks"], -(-max(m, 1) // br), br,
                                    val_bytes)
        xy = (n + m) * k * vec_bytes
        return {"block": stream + xy, "block_stream": stream,
                "density": st["density"],
                "merge": csr_stream_bytes(m, a.nnz, val_bytes)
                + int(X_GATHER * a.nnz * k * vec_bytes) + xy,
                "spmv_passes": k * csr_bytes_per_iter(m, n, a.nnz,
                                                      val_bytes, vec_bytes)}

    def _pick(self, a: CSR, value_dtype) -> tuple[str, str]:
        if a.dtype == np.float64:
            p = self.prices(a, self.k_hint, self.block_rows, 8, 8)
            routes = ("merge", "spmv_passes")
            method = min(routes, key=lambda r: p[r])
            ref, why = xla_heuristic(a)
            return method, (
                f"auto: float64 values, k_hint={self.k_hint}: " + ", ".join(
                    f"{r} {p[r] / 1e6:.1f} MB" for r in routes)
                + f" -> {method} (the kernels' f64 builds; the block kernel "
                f"has none; the JAX package's auto runs its XLA {ref!r} "
                f"route: {why})")
        if a.dtype != np.float32:
            method, why = xla_heuristic(a)
            return method, f"auto: {a.dtype} -> {method} ({why})"
        vb = check_uploadable(a, value_dtype or torch.float32).itemsize
        p = self.prices(a, self.k_hint, self.block_rows, vb)
        routes = ("block", "merge", "spmv_passes")
        rule = (f"k_hint={self.k_hint}: " + ", ".join(
            f"{r} {p[r] / 1e6:.1f} MB" for r in routes)
            + f" (block density {p['density']:.3f})")
        method = min(routes, key=lambda r: p[r])
        if method == "block" and self.device.type == "cuda":
            free = torch.cuda.mem_get_info(self.device)[0]
            if p["block_stream"] > free // 2:
                method = min(routes[1:], key=lambda r: p[r])
                return method, (
                    f"auto: {rule}, but the blocks exceed half of the "
                    f"{free / 1e6:.0f} MB free -> {method}")
        return method, f"auto: {rule} -> {method}"

    def _up(self, arr: np.ndarray) -> torch.Tensor:
        return upload(arr, self.device)

    @property
    def bytes_per_iter_nx(self) -> int:
        """The plan's matrix stream for one call at ``k_hint`` columns, X and
        Y left out (the JAX package's name)."""
        if self.method == "spmv_passes":
            return self.k_hint * self._pass
        return self._stream

    def bytes_per_call(self, k: int, with_y: bool = False) -> int:
        """Bytes one call with ``k`` columns moves by the plan's model: the
        matrix stream (once per column for ``spmv_passes``), X in, Y out, and
        Y in when ``with_y``; for a relabeled ``pseg`` plan also the
        permutations around the kernel (X, Y in and Y out each read and
        written once more, with an int64 index a row)."""
        m, n = self.shape
        es = self.dtype.itemsize
        stream = k * self._pass if self.method == "spmv_passes" \
            else self._stream
        rows = n + m * (2 if with_y else 1)
        perms = 0 if self._perms is None else rows * (2 * k * es + 8)
        return stream + rows * k * es + perms

    def flops_per_call(self, k: int) -> int:
        """Multiply-adds times 2 that one call executes: every stored block
        entry for the block routes, every nonzero otherwise."""
        if self.method in ("block", "bsr"):
            return 2 * self.nblocks * self._op["br"] * BLOCK_COLS * k
        return 2 * self.nnz * k

    def __repr__(self):
        m, n = self.shape
        return (f"SpmmPlan({m}x{n}, nnz={self.nnz}, method={self.method!r}, "
                f"device={self.device}, "
                f"~{self.bytes_per_iter_nx / 1e6:.1f} MB/iter at "
                f"k={self.k_hint})")

    def apply_permuted(self, x_perm, alpha: float = 1.0, beta: float = 0.0,
                       y_perm=None):
        """``pseg``: ``alpha * A_perm @ X_perm + beta * Y_perm`` in the
        hub-relabeled space (``X_perm = X[colperm]``, result row ``i`` is row
        ``rowperm[i]`` of A): no permutation around the kernel, the path for
        iterative callers."""
        if self.method != "pseg":
            raise ValueError(f"method {self.method!r} has no permuted space")
        x_perm = torch.as_tensor(x_perm, dtype=self.dtype,
                                 device=self.device).contiguous()
        if y_perm is not None:
            y_perm = torch.as_tensor(y_perm, dtype=self.dtype,
                                     device=self.device).contiguous()
        return spmm_csr.spmm_csr(self._op, x_perm, alpha, beta, y_perm)

    def __call__(self, x, alpha: float = 1.0, beta: float = 0.0, y=None):
        m, n = self.shape
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        if x.dim() != 2 or x.shape[0] != n:
            raise ValueError(f"X must have shape ({n}, k), got "
                             f"{tuple(x.shape)}")
        k = x.shape[1]
        if y is None:
            if beta != 0.0:
                raise ValueError("beta != 0 requires Y")
        else:
            y = torch.as_tensor(y, dtype=self.dtype, device=self.device)
            if y.shape != (m, k):
                raise ValueError(f"Y must have shape ({m}, {k}), got "
                                 f"{tuple(y.shape)}")
        if self.method == "block":
            return spmm_bsr(self._op, x.contiguous(), alpha, beta,
                            None if y is None else y.contiguous())
        if self.method in ("merge", "pseg"):
            if self._perms is None:
                return spmm_csr.spmm_csr(
                    self._op, x.contiguous(), alpha, beta,
                    None if y is None else y.contiguous())
            cols, rows = self._perms
            out = spmm_csr.spmm_csr(
                self._op, x.index_select(0, cols), alpha, beta,
                None if y is None else y.index_select(0, rows))
            return torch.empty_like(out).index_copy_(0, rows, out)
        if self.method == "bsr":
            return spmm_bsr_reference(self._op, x, alpha, beta, y)
        if self.method == "spmv_passes":
            xt = x.t().contiguous()          # each column of X contiguous
            yt = None if y is None else y.t().contiguous()
            cols = [self._spmv(xt[j], alpha, beta,
                               None if yt is None else yt[j])
                    for j in range(k)]
            if not cols:
                return torch.zeros((m, 0), dtype=self.dtype,
                                   device=self.device)
            return torch.stack(cols, dim=1)
        if self.method == "ell":
            out = self._ell(self._val, self._col, x)[:m]
        else:  # bucket
            flat = torch.cat([self._ell(val, col, x)
                              for val, col in self._buckets])
            out = torch.zeros((m + 1, k), dtype=flat.dtype,
                              device=self.device)
            out = out.index_add_(0, self._perm, flat)[:m]
        out = alpha * out
        if y is not None:
            out = out + beta * y
        return out

    @staticmethod
    def _ell(val: torch.Tensor, col: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
        """ELLPACK product, in row chunks that bound the gathered X."""
        rows, width = val.shape
        step = max(1, _ELL_CHUNK // max(width * x.shape[1], 1))
        parts = [torch.einsum("rw,rwk->rk", val[r:r + step],
                              x[col[r:r + step].long()])
                 for r in range(0, rows, step)]
        if not parts:
            return torch.zeros((0, x.shape[1]), dtype=x.dtype,
                               device=x.device)
        return torch.cat(parts)


def _get_plan(a: CSR, method: str, **kw) -> SpmmPlan:
    plans = _PLAN_CACHE.setdefault(a, {})
    key = ("spmm", method, tuple(sorted(kw.items())))
    if key not in plans:
        plans[key] = SpmmPlan(a, method, **kw)
    return plans[key]


def spmm(a, x, alpha: float = 1.0, beta: float = 0.0, y=None,
         *, trans: bool = False, method: str = "auto", **kw):
    """Y_out = alpha * op(A) @ X + beta * Y, op = A^T if trans else A.

    ``a`` may be CSR or CSC; plans are cached per derived matrix and per
    keyword set. ``kw`` goes to :class:`SpmmPlan` (``k_hint=``,
    ``block_rows=``, ``value_dtype=``, ``device=``, ``max_width=``).
    """
    from .common import as_csr

    return _get_plan(as_csr(a, trans), method, **kw)(x, alpha, beta, y)
