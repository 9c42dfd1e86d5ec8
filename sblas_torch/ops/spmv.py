"""SpMV: y = alpha * op(A) @ x + beta * y, the port of ``sblas/ops/spmv.py``.

Routes (``method=``, or ``'auto'``):

- ``'csr'``    — the hand-written CUDA kernel over plain CSR
                 (``kernels/spmv_csr.py``), the counterpart of the JAX
                 package's ``'pallas'`` route. f32 matrices, values f32 or
                 bf16 (``value_dtype=``). On CPU tensors its wrapper runs the
                 kernel's plain torch version.
- ``'coo'``, ``'ell'``, ``'bucket'`` — plain torch ports of the JAX
                 package's XLA routes of the same names, any value dtype.

``'auto'`` picks ``'csr'`` for f32 matrices on every device, and for other
dtypes (f64) the JAX package's ELL/bucket heuristic. The JAX package's
``'pseg'``, ``'pseg_big'``, ``'rcm'``, ``'bsr'`` and ``'pallas_ds'`` are not
ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ..formats import CSR, as_torch_dtype, to_device, upload
from ..retile import to_bucket_ell, to_ell
from ..utils.backend import default_device
from .kernels.spmv_csr import prepare, spmv_csr

# plan cache, keyed weakly on the matrix: a plan (and its device tensors)
# dies with the CSR it was built for
_PLAN_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

ROUTES = ("csr", "coo", "ell", "bucket")
NOT_PORTED = ("pseg", "pseg_big", "rcm", "bsr", "pallas_ds")


def csr_bytes_per_iter(m: int, n: int, nnz: int, val_bytes: int) -> int:
    """Bytes one ``csr`` SpMV moves: each nonzero's value and int32 column
    index, ``indptr``, ``x`` in and ``y`` out (f32)."""
    return nnz * (val_bytes + 4) + (m + 1) * 4 + n * 4 + m * 4


def xla_heuristic(a: CSR) -> tuple[str, str]:
    """The JAX package's ELL-or-bucket pick (``SpmvPlan._xla_heuristic``),
    with the reason."""
    deg = a.row_lengths
    mx = int(deg.max(initial=0))
    mean = float(deg.mean()) if a.shape[0] else 0.0
    if mx <= 4 * max(mean, 1.0):
        return "ell", f"max row {mx} <= 4 x mean {mean:.1f}"
    return "bucket", f"max row {mx} > 4 x mean {mean:.1f}"


class SpmvPlan:
    """Device-resident SpMV executor for one CSR matrix."""

    def __init__(self, a, method: str = "auto", *, max_width: int = 2048,
                 value_dtype=None, device=None):
        from .common import as_csr

        a = as_csr(a)
        self.shape = a.shape
        self.nnz = a.nnz
        self.dtype = as_torch_dtype(a.dtype)
        self.device = torch.device(device) if device is not None \
            else default_device()
        if method == "auto":
            if a.dtype == np.float32:
                method = "csr"
                self.route_reason = "auto: f32 values -> csr kernel"
            else:
                method, why = xla_heuristic(a)
                self.route_reason = f"auto: {a.dtype} -> {method} ({why})"
        elif method in NOT_PORTED:
            raise NotImplementedError(
                f"spmv method {method!r} is not ported to sblas_torch yet")
        elif method in ROUTES:
            self.route_reason = f"method={method!r} requested"
        else:
            raise ValueError(f"unknown spmv method {method!r}")
        self.method = method
        m, n = a.shape
        val_bytes = a.data.itemsize

        if method == "csr":
            if a.dtype != np.float32:
                raise ValueError(
                    f"csr kernel takes f32 matrices, got {a.dtype}; use "
                    "ell/bucket")
            vd = as_torch_dtype(value_dtype or torch.float32)
            if vd not in (torch.float32, torch.bfloat16):
                raise ValueError(f"value_dtype must be f32 or bf16, got {vd}")
            # checked once here, with the launch's lanes per row
            self._op = prepare(to_device(a, self.device, vd))
            self.bytes_per_iter = csr_bytes_per_iter(m, n, a.nnz,
                                                     vd.itemsize)
        elif method == "coo":
            self._vals = self._up(a.data)
            self._cols = self._up(a.indices)
            self._rows = self._up(a.row_ids())
            self.bytes_per_iter = a.nnz * (val_bytes + 8)
        elif method == "ell":
            ell = to_ell(a)
            self._val, self._col = self._up(ell.val), self._up(ell.col)
            self.fill = ell.fill
            self.bytes_per_iter = ell.col.size * (val_bytes + 4)
        else:  # bucket
            be = to_bucket_ell(a, max_width=max_width)
            self._buckets = [(self._up(b.val), self._up(b.col))
                             for b in be.buckets]
            self._perm = self._up(be.perm)
            self.fill = be.fill
            self.bytes_per_iter = sum(
                b.col.size for b in be.buckets) * (val_bytes + 4)

    def _up(self, arr: np.ndarray) -> torch.Tensor:
        return upload(arr, self.device)

    def __repr__(self):
        m, n = self.shape
        fill = getattr(self, "fill", None)
        fs = f", fill={fill:.2f}" if fill is not None else ""
        return (f"SpmvPlan({m}x{n}, nnz={self.nnz}, method={self.method!r}"
                f"{fs}, device={self.device}, "
                f"~{self.bytes_per_iter / 1e6:.1f} MB/iter)")

    def __call__(self, x, alpha: float = 1.0, beta: float = 0.0, y=None):
        m, n = self.shape
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        if y is not None:
            y = torch.as_tensor(y, dtype=self.dtype, device=self.device)
        if self.method == "csr":
            # the kernel's wrapper checks x and y
            return spmv_csr(self._op, x.contiguous(), alpha, beta,
                            None if y is None else y.contiguous())
        if x.shape != (n,):
            raise ValueError(f"x must have shape ({n},), got {tuple(x.shape)}")
        if beta != 0.0 and y is None:
            raise ValueError("beta != 0 requires y")
        if y is not None and y.shape != (m,):
            raise ValueError(f"y must have shape ({m},), got {tuple(y.shape)}")
        if self.method == "coo":
            out = torch.zeros(m, dtype=self.dtype, device=self.device)
            out.index_add_(0, self._rows, self._vals * x[self._cols])
        elif self.method == "ell":
            out = (self._val * x[self._col]).sum(dim=1)[:m]
        else:  # bucket
            flat = torch.cat([(val * x[col]).sum(dim=1)
                              for val, col in self._buckets])
            out = torch.zeros(m + 1, dtype=flat.dtype, device=self.device)
            out = out.index_add_(0, self._perm, flat)[:m]
        out = alpha * out
        if y is not None:
            out = out + beta * y
        return out


def _get_plan(a: CSR, method: str, **kw) -> SpmvPlan:
    plans = _PLAN_CACHE.setdefault(a, {})
    key = ("spmv", method, tuple(sorted(kw.items())))
    if key not in plans:
        plans[key] = SpmvPlan(a, method, **kw)
    return plans[key]


def spmv(a, x, alpha: float = 1.0, beta: float = 0.0, y=None,
         *, trans: bool = False, method: str = "auto", **kw):
    """y_out = alpha * op(A) @ x + beta * y, op = A^T if trans else A.

    ``a`` may be CSR or CSC; plans are cached per derived matrix. ``kw``
    goes to :class:`SpmvPlan` (``value_dtype=``, ``device=``,
    ``max_width=``).
    """
    from .common import as_csr

    return _get_plan(as_csr(a, trans), method, **kw)(x, alpha, beta, y)
