"""SpMM: Y = alpha * op(A) @ X + beta * Y, the port of ``sblas/ops/spmm.py``.

``X`` is dense and row-major, ``(n, K)``; ``Y`` is ``(m, K)``.

Routes (``method=``, or ``'auto'``):

- ``'block'``       — the hand-written CUDA dense-block kernel
                      (``kernels/spmm_bsr.py``) over ``block_rows x 128``
                      blocks: the counterpart of the JAX package's
                      ``'bsr_pallas_t'`` at ``block_rows=128`` (the default)
                      and of its ``'bsr_pallas'`` at ``block_rows=64``. f32
                      matrices, values f32 or bf16 (``value_dtype=``). On
                      CPU tensors its wrapper runs the kernel's plain torch
                      version.
- ``'spmv_passes'`` — K launches of the port's SpMV plan (the ``csr``
                      kernel for f32), one per column of X, as in the JAX
                      package.
- ``'ell'``, ``'bucket'``, ``'bsr'`` — plain torch ports of the JAX
                      package's XLA routes of the same names, any value dtype.

``'pallas'``, ``'pseg'`` and ``'pallas_ds'`` raise ``NotImplementedError``
until their kernels are ported.

``'auto'`` for f32 matrices (values f32 or bf16), on every device, is a
bytes rule: ``'block'`` when the block stream (:func:`bsr_stats` at
``block_rows x 128``, in the value dtype, with its index arrays) is at most
``k_hint`` (default 8) times the bytes of one ``csr`` SpMV
(:func:`~sblas_torch.ops.spmv.csr_bytes_per_iter`), and, on CUDA, fits in
half of the free device memory; ``'spmv_passes'`` otherwise. For f64 it is
the JAX package's XLA heuristic, so that both packages pick the same route.
The route is fixed when the plan is built: a kernel launch that fails
raises, and no other route is tried.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats import CSR, as_torch_dtype, check_uploadable, upload
from ..retile import to_bucket_ell, to_ell
from ..retile_bsr import bsr_stats, pack_bsr
from ..utils.backend import default_device
from .kernels.spmm_bsr import (BLOCK_COLS, BLOCK_ROWS, bsr_to_device, prepare,
                               spmm_bsr, spmm_bsr_reference)
from .spmv import _PLAN_CACHE, SpmvPlan, csr_bytes_per_iter
from .spmv import xla_heuristic as spmv_xla_heuristic

ROUTES = ("block", "spmv_passes", "ell", "bucket", "bsr")
NOT_PORTED = ("pallas", "pseg", "pallas_ds")
K_HINT = 8
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
        from .common import as_csr

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
        elif method in NOT_PORTED:
            raise NotImplementedError(
                f"spmm method {method!r} is not ported to sblas_torch yet")
        elif method in ROUTES:
            self.route_reason = f"method={method!r} requested"
        else:
            hint = " (the dense-block kernel route is 'block')" \
                if method.startswith("bsr_pallas") else ""
            raise ValueError(f"unknown spmm method {method!r}{hint}")
        self.method = method
        m, n = a.shape

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
        elif method == "spmv_passes":
            self._spmv = SpmvPlan(a, "auto", value_dtype=value_dtype,
                                  max_width=max_width, device=self.device)
            # each pass streams the SpMV plan's schedule, less its x and y
            es = self.dtype.itemsize
            self._pass = self._spmv.bytes_per_iter - (
                (m + n) * es if self._spmv.method == "csr" else 0)
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

    def _pick(self, a: CSR, value_dtype) -> tuple[str, str]:
        if a.dtype != np.float32:
            method, why = xla_heuristic(a)
            return method, f"auto: {a.dtype} -> {method} ({why})"
        vb = check_uploadable(a, value_dtype or torch.float32).itemsize
        m, n = a.shape
        br = self.block_rows
        st = bsr_stats(a, br=br, bc=BLOCK_COLS)
        block = block_stream_bytes(st["nblocks"], -(-max(m, 1) // br), br, vb)
        passes = self.k_hint * csr_bytes_per_iter(m, n, a.nnz, vb)
        rule = (f"block stream {block / 1e6:.1f} MB (density "
                f"{st['density']:.3f}) vs k_hint={self.k_hint} csr passes "
                f"{passes / 1e6:.1f} MB")
        if block > passes:
            return "spmv_passes", f"auto: {rule} -> spmv_passes"
        if self.device.type == "cuda":
            free = torch.cuda.mem_get_info(self.device)[0]
            if block > free // 2:
                return "spmv_passes", (
                    f"auto: {rule}, but the blocks exceed half of the "
                    f"{free / 1e6:.0f} MB free -> spmv_passes")
        return "block", f"auto: {rule} -> block"

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
        Y in when ``with_y``."""
        m, n = self.shape
        stream = k * self._pass if self.method == "spmv_passes" \
            else self._stream
        return stream + (n + m * (2 if with_y else 1)) * k * \
            self.dtype.itemsize

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
