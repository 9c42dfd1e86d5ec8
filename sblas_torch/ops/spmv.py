"""SpMV: y = alpha * op(A) @ x + beta * y, the port of ``sblas/ops/spmv.py``.

Routes (``method=``, or ``'auto'``):

- ``'csr'``      — the hand-written CUDA csr-vector kernel
                   (``kernels/spmv_csr.py``), the counterpart of the JAX
                   package's ``'pallas'`` route: G lanes a row. Its f64
                   build takes f64 matrices.
- ``'pallas_ds'`` — the ``'csr'`` plan of an f64 matrix. The JAX package's
                   double-single planes (``spmv_wsell_ds.py``) exist because
                   Mosaic has no f64; Hopper has native FP64, so the f64
                   build computes the same product in IEEE f64, at least as
                   accurate as the ds error model (~max_deg * 2^-48). The
                   JAX package's ds limits (w-SELL fill below 0.2, x tables
                   above 12 MB) are VMEM limits and are not copied: any f64
                   matrix takes it. An f32 matrix raises ``ValueError``, as
                   in the JAX package.
- ``'bsr'``      — the SpMM ``'bsr'`` plan (plain torch over 128 x 128
                   blocks, the JAX package's XLA block route) at K = 1.
- ``'merge'``    — the hand-written CUDA nnz-balanced (merge-path) kernel
                   (``kernels/spmm_csr.py``), through the SpMM ``'merge'``
                   plan at K = 1. It splits long rows across warps, so
                   power-law graphs keep the card busy. Its f64 build
                   takes f64 matrices.
- ``'pseg'``     — the SpMM ``'pseg'`` plan at K = 1: the same kernel on the
                   hub-relabeled matrix ``A[rowperm][:, colperm]``, the
                   counterpart of the JAX package's ``'pseg'``, by name
                   only. ``colperm``, ``rowperm`` and :meth:`apply_permuted`
                   give the permuted-space interface.
- ``'pseg_big'`` — the same plan as ``'pseg'`` (``method == 'pseg'``).
- ``'rcm'``      — the ``csr`` kernel on ``P A P^T`` from
                   :func:`~sblas_torch.reorder.rcm`, with the same
                   permuted-space interface.
- ``'coo'``, ``'ell'``, ``'bucket'`` — plain torch ports of the JAX
                   package's XLA routes of the same names, any value dtype.

The ``csr``, ``rcm``, ``merge`` and ``pseg`` kernels take f32 matrices,
values f32 or bf16 (``value_dtype=``), and f64 matrices (f64 values, ``x``
and ``y``: the kernels' f64 builds). On CPU tensors the wrappers run the
kernels' plain torch versions.

``'auto'`` for f32 and f64 matrices picks between ``'csr'`` and
``'merge'`` by the longest row: the csr kernel walks a row of L nonzeros in
L / G serial steps of its lane group, and when that walk would outlast both
the nnz-balanced kernel's time for one share and the whole CSR stream at
the card's rate, ``'merge'`` (:func:`f32_rule`, at the dtype's value and
vector bytes; its constants from H100 timings, PERF.md). It never picks
``'pseg'`` or ``'rcm'``. For other dtypes (complex) it is the JAX package's
ELL/bucket heuristic.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ..formats import CSR, as_torch_dtype, to_device, upload
from ..reorder import rcm
from ..retile import to_bucket_ell, to_ell
from ..utils.backend import default_device
from .kernels import spmm_csr, spmv_csr

# plan cache, keyed weakly on the matrix: a plan (and its device tensors)
# dies with the CSR it was built for
_PLAN_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

ROUTES = ("csr", "merge", "pseg", "pseg_big", "rcm", "coo", "ell", "bucket",
          "bsr")
# every route of the JAX package has its counterpart here
NOT_PORTED = ()

# the csr kernel's time for one serial step of a lane group (its time on a
# graph over the longest row's steps: 116 ns on uk-2002 at 5%, 152 on
# twitter7 at 2%), the nnz-balanced kernel's time at K = 1 for one wave of
# shares of spmm_csr.UNIT_SPMV items (a launch on a 300-row band, the
# unit_sweep's one_wave_us), and the card's STREAM triad rate (3037-3042
# GB/s): H100 timings of chip_smoke.py (PERF.md)
CSR_STEP_NS = 116.0
MERGE_SHARE_NS = 5680.0
STREAM_GBPS = 3040.0


def csr_stream_bytes(m: int, nnz: int, val_bytes: int) -> int:
    """Bytes of one pass over the CSR matrix: each nonzero's value and
    int32 column index, and ``indptr``."""
    return nnz * (val_bytes + 4) + (m + 1) * 4


def csr_bytes_per_iter(m: int, n: int, nnz: int, val_bytes: int,
                       vec_bytes: int = 4) -> int:
    """Bytes one ``csr`` SpMV moves: the CSR stream, ``x`` in and ``y`` out
    (``vec_bytes`` each entry: 4 in f32, 8 in f64)."""
    return csr_stream_bytes(m, nnz, val_bytes) + (n + m) * vec_bytes


def f32_rule(a: CSR, val_bytes: int = 4,
             vec_bytes: int = 4) -> tuple[str, str]:
    """``'csr'`` or ``'merge'`` for an f32 or f64 matrix (``val_bytes``,
    ``vec_bytes``: 4 and 4 in f32, 8 and 8 in f64), with the reason.

    The csr kernel walks its longest row in ``longest / G`` serial steps of
    one lane group; the nnz-balanced kernel takes no less than
    ``MERGE_SHARE_NS``, its time for one wave of shares. ``'merge'`` when
    the first walk, at ``CSR_STEP_NS`` a step, outlasts both that and the
    CSR stream at ``STREAM_GBPS``."""
    m, n = a.shape
    longest = int(a.row_lengths.max(initial=0))
    g = spmv_csr.group_size(
        m, a.nnz, torch.float64 if vec_bytes == 8 else torch.float32)
    walk_us = longest / g * CSR_STEP_NS / 1e3
    share_us = MERGE_SHARE_NS / 1e3
    stream_us = csr_bytes_per_iter(m, n, a.nnz, val_bytes,
                                   vec_bytes) / STREAM_GBPS / 1e3
    method = "merge" if walk_us > max(share_us, stream_us) else "csr"
    return method, (f"longest row {longest} / G={g} lanes walks "
                    f"{walk_us:.1f} us {'>' if method == 'merge' else '<='} "
                    f"max(a wave of shares {share_us:.1f} us, the CSR stream "
                    f"{stream_us:.1f} us) -> {method}")


def f64_reason(a: CSR) -> tuple[str, str]:
    """``auto``'s route for an f64 matrix and why: the rule of
    :func:`f32_rule` at 8-byte values and vectors, on the kernels' f64
    builds, and what the JAX package runs instead."""
    method, why = f32_rule(a, 8, 8)
    ref, _ = xla_heuristic(a)
    return method, (f"auto: float64 values, {why} (the {method} kernel's "
                    f"f64 build; the JAX package's auto runs its XLA "
                    f"{ref!r} route)")


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
                vb = as_torch_dtype(value_dtype or torch.float32).itemsize
                method, why = f32_rule(a, vb)
                self.route_reason = f"auto: f32 values, {why}"
            elif a.dtype == np.float64:
                method, self.route_reason = f64_reason(a)
            else:
                method, why = xla_heuristic(a)
                self.route_reason = f"auto: {a.dtype} -> {method} ({why})"
        elif method == "pallas_ds":
            if a.dtype != np.float64:
                raise ValueError(f"pallas_ds is the f64 path, got {a.dtype}; "
                                 "use method='csr' for f32")
            method = "csr"
            self.route_reason = (
                "method='pallas_ds' requested: the 'csr' plan's f64 build "
                "(the JAX package's double-single planes exist because "
                "Mosaic has no f64; the card computes in IEEE f64)")
        elif method == "pallas":
            method = "csr"
            self.route_reason = (
                "method='pallas' requested: the 'csr' plan (the JAX "
                "package's w-SELL kernel computes the same product)")
        elif method == "pseg_big":
            method = "pseg"
            self.route_reason = (
                "method='pseg_big' requested: the 'pseg' plan (the JAX "
                "package needed a second executor only for TPU memory "
                "ceilings; the card's kernel has none)")
        elif method in ROUTES:
            self.route_reason = f"method={method!r} requested"
        else:
            raise ValueError(f"unknown spmv method {method!r}")
        self.method = method
        m, n = a.shape
        val_bytes = a.data.itemsize

        if method in ("csr", "merge", "pseg", "rcm") and \
                a.dtype == np.float64:
            vd = as_torch_dtype(value_dtype or torch.float64)
            if vd != torch.float64:
                raise ValueError(f"value_dtype must be f64 for an f64 "
                                 f"matrix, got {vd}")
        elif method in ("csr", "merge", "pseg", "rcm"):
            if a.dtype != np.float32:
                raise ValueError(
                    f"the {method} kernel takes f32 or f64 matrices, got "
                    f"{a.dtype}; use ell/bucket")
            vd = as_torch_dtype(value_dtype or torch.float32)
            if vd not in (torch.float32, torch.bfloat16):
                raise ValueError(f"value_dtype must be f32 or bf16, got {vd}")
        if method == "bsr":
            from .spmm import SpmmPlan

            self._mm = SpmmPlan(a, "bsr", k_hint=1, device=self.device)
            self.fill = self._mm.density
            self.bytes_per_iter = self._mm.bytes_per_call(1)
        elif method in ("merge", "pseg"):
            # the SpMM plan at K = 1 (spmm imports this module): the
            # relabeling lives in one place
            from .spmm import SpmmPlan

            self._mm = SpmmPlan(a, method, value_dtype=vd,
                                device=self.device)
            if method == "pseg":
                self.colperm, self.rowperm = self._mm.colperm, \
                    self._mm.rowperm
            self.bytes_per_iter = self._mm.bytes_per_call(1)
        elif method in ("csr", "rcm"):
            ap = a
            if method == "rcm":
                # x[perm] in, y[perm] in, y_perm[inv] out
                ap, perm = rcm(a)
                self.colperm = self.rowperm = perm
                inv = np.empty_like(perm)
                inv[perm] = np.arange(m)
                self._rcm = self._up(perm), self._up(inv)
            # checked once here, with the launch's lanes per row
            self._op = spmv_csr.prepare(to_device(ap, self.device, vd))
            self.bytes_per_iter = csr_bytes_per_iter(
                m, n, a.nnz, vd.itemsize, self.dtype.itemsize)
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
            self._row_slot, self._split_rows, self._split_slots = map(
                self._up, bucket_slots(be.perm, self.shape[0]))
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

    def apply_permuted(self, x_perm, alpha: float = 1.0, beta: float = 0.0,
                       y_perm=None):
        """``pseg``/``rcm``: ``alpha * A_perm @ x_perm + beta * y_perm`` in
        the plan's permuted space (``x_perm = x[colperm]``, result row ``i``
        is row ``rowperm[i]`` of A): no permutation around the kernel, the
        path for iterative callers."""
        if self.method not in ("pseg", "rcm"):
            raise ValueError(f"method {self.method!r} has no permuted space")
        x_perm = torch.as_tensor(x_perm, dtype=self.dtype,
                                 device=self.device).contiguous()
        if y_perm is not None:
            y_perm = torch.as_tensor(y_perm, dtype=self.dtype,
                                     device=self.device).contiguous()
        if self.method == "pseg":
            return self._mm.apply_permuted(
                x_perm.view(-1, 1), alpha, beta,
                None if y_perm is None else y_perm.view(-1, 1)).view(-1)
        return spmv_csr.spmv_csr(self._op, x_perm, alpha, beta, y_perm)

    def __call__(self, x, alpha: float = 1.0, beta: float = 0.0, y=None):
        m, n = self.shape
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        if y is not None:
            y = torch.as_tensor(y, dtype=self.dtype, device=self.device)
        if self.method == "csr":
            # the kernel's wrapper checks x and y
            return spmv_csr.spmv_csr(self._op, x.contiguous(), alpha, beta,
                                     None if y is None else y.contiguous())
        if x.shape != (n,):
            raise ValueError(f"x must have shape ({n},), got {tuple(x.shape)}")
        if beta != 0.0 and y is None:
            raise ValueError("beta != 0 requires y")
        if y is not None and y.shape != (m,):
            raise ValueError(f"y must have shape ({m},), got {tuple(y.shape)}")
        if self.method in ("merge", "pseg", "bsr"):
            return self._mm(x.reshape(-1, 1), alpha, beta,
                            None if y is None else y.reshape(-1, 1)).view(-1)
        if self.method == "rcm":
            perm, inv = self._rcm
            out = spmv_csr.spmv_csr(
                self._op, x.index_select(0, perm), alpha, beta,
                None if y is None else y.index_select(0, perm))
            return out.index_select(0, inv)
        if self.method == "coo":
            out = torch.zeros(m, dtype=self.dtype, device=self.device)
            out.index_add_(0, self._rows, self._vals * x[self._cols])
        elif self.method == "ell":
            out = (self._val * x[self._col]).sum(dim=1)[:m]
        else:  # bucket: gathers, no atomics (see bucket_slots)
            parts = [(val * x[col]).sum(dim=1) for val, col in self._buckets]
            flat = torch.cat(parts + [parts[0].new_zeros(1)])
            out = flat[self._row_slot]
            if self._split_rows.numel():
                out[self._split_rows] = flat[self._split_slots].sum(dim=1)
        out = alpha * out
        if y is not None:
            out = out + beta * y
        return out


def bucket_slots(perm: np.ndarray, m: int):
    """The bucket route's sum of its slots into rows, as gathers: the slot
    of each row that has one (``len(perm)``, a zero appended to the slots'
    sums, for a row split into several), the rows split across slots
    (longer than ``max_width``) and their slots, one row of a table each,
    padded with the zero. A split row's partial sums then add in one fixed
    order on any device, where a scatter-add on the card adds them in the
    order its atomics land, and PageRank's power iteration never settles
    to its fixed point."""
    zero = len(perm)
    slots = np.flatnonzero(perm < m)                # the rest are padding
    rows = perm[slots].astype(np.int64)
    order = np.argsort(rows, kind="stable")
    rows, slots = rows[order], slots[order]
    count = np.bincount(rows, minlength=m)
    row_slot = np.full(m, zero, np.int64)
    one = count[rows] == 1
    row_slot[rows[one]] = slots[one]
    split = np.flatnonzero(count > 1)
    rows, slots = rows[~one], slots[~one]
    rank = np.arange(rows.size) - np.searchsorted(rows, rows)
    table = np.full((split.size, int(count.max(initial=1))), zero, np.int64)
    table[np.searchsorted(split, rows), rank] = slots
    return row_slot, split, table


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
