"""Krylov solvers on the port's plans: the port of ``sblas/solvers.py``.

    x, info = sblas_torch.solvers.cg(A, b, tol=1e-8)
    x, info = sblas_torch.solvers.cg(A, b, M=sblas_torch.solvers.ichol(A))
    x, info = sblas_torch.solvers.gmres(A, b, restart=30,
                                        M=sblas_torch.solvers.ilu(A))

``cg`` (SPD), ``bicgstab`` and restarted ``gmres`` (general square A) take a
CSR, a CSC, an :class:`~sblas_torch.ops.spmv.SpmvPlan` or any plan with its
protocol (``shape``, ``dtype``, ``device``, ``plan(x, alpha, beta, y)``: the
distributed plans of :mod:`sblas_torch.parallel`), cast ``b`` and
``x0`` to the plan's dtype (f32 or f64) and return ``(x, {"iterations",
"rel_residual"})`` with ``x`` on the plan's device. Each is a plain Python
loop over device tensors: the matrix products go through the plan (``auto``:
the csr kernel, in f32 or its f64 build), and each iteration makes one host
read, the convergence test that the JAX package's ``lax.while_loop``
condition makes on the device (GMRES: one read of the new Hessenberg column
an Arnoldi step, whose rotations run on the host in the plan's dtype).

A preconditioner ``M`` is a callable ``M(r) -> z`` on the plan's device:
:func:`jacobi` (diagonal scaling), :func:`ichol` (IC(0), ``M = L L^T``) and
:func:`ilu` (ILU(0), ``M = L U``). The two factorizations run on the host in
f64 in the port's own C++ (:mod:`sblas_torch.native`; a failed build raises)
and are applied as two triangular solves through
:class:`~sblas_torch.ops.sptrsv.SptrsvPlan` ``auto``: the sync-free kernel,
in f32 or f64. (The JAX package applies them through its ``tiles`` route
only because that one composes under ``jit``.) ``trsv_sweeps=k`` applies
them as ``k`` Jacobi sweeps instead
(:class:`~sblas_torch.ops.sptrsv_iter.SptrsvJacobiPlan`). Everything runs on
the card unless the caller passes ``device="cpu"``.

The semantics are the JAX package's: GMRES counts matvecs in steps of
``restart`` and neutralises zero pivots before its triangular solve;
BiCGSTAB's shadow residual is ``r0``; IC(0) and ILU(0) retry with a doubling
diagonal shift on breakdown.
"""

from __future__ import annotations

import numpy as np
import torch

from .formats import (CSR, cast, csr_transpose, has_full_diagonal, tril,
                      triu, upload)
from .ops.common import as_csr
from .ops.spmv import SpmvPlan
from .ops.sptrsv import SptrsvPlan
from .ops.sptrsv_iter import SptrsvJacobiPlan
from .trace import span
from .utils.backend import default_device

__all__ = ["bicgstab", "cg", "gmres", "ichol", "ilu", "jacobi",
           "TriangularPair"]


class TriangularPair:
    """``M(r) = bwd(fwd(r))``: a factored preconditioner applied as two
    triangular solves (``fwd`` and ``bwd`` are the solve plans, kept for
    callers that time them)."""

    def __init__(self, fwd, bwd):
        self.fwd, self.bwd = fwd, bwd

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return self.bwd(self.fwd(r))


def _device(device) -> torch.device:
    return torch.device(device) if device is not None else default_device()


@span("sblas.solvers.jacobi", "build")
def jacobi(a, *, device=None):
    """Diagonal (Jacobi) preconditioner: ``z = r / diag(A)`` (a missing
    diagonal entry counts as 1)."""
    a = as_csr(a)
    coo = a.tocoo()
    with span("sblas.solvers.jacobi.diagonal", "build"):
        d = np.ones(a.shape[0], dtype=a.dtype)
        m = coo.row == coo.col
        d[coo.row[m]] = coo.data[m]
    inv = upload(cast(1.0 / d, a.dtype), _device(device))

    def apply(r: torch.Tensor) -> torch.Tensor:
        return inv * r

    return apply


@span("sblas.solvers.factor", "factor")
def _shifted(factor, indptr, indices, base: np.ndarray, diag_mask,
             shift: float, max_shift_tries: int, name: str) -> np.ndarray:
    """The values ``factor`` leaves in place on ``base`` (f64), retried on
    breakdown with the diagonal scaled by ``1 + shift``, the shift doubling
    from 1e-3 up to ``max_shift_tries`` times."""
    sh = shift if shift > 0 else 0.0
    for _ in range(max_shift_tries + 1):
        vals = base.copy()
        if sh:
            vals[diag_mask] *= (1.0 + sh)
        if factor(indptr, indices, vals) == 0:
            return vals
        sh = max(2 * sh, 1e-3)
    raise ValueError(f"{name} breakdown persists after diagonal shifts")


@span("sblas.solvers.ichol", "build")
def ichol(a, *, shift: float = 0.0, max_shift_tries: int = 6,
          trsv_sweeps: int | None = None, device=None) -> TriangularPair:
    """IC(0) preconditioner: ``M = L L^T`` on the pattern of ``tril(A)``.

    The factorization runs on the host (:func:`sblas_torch.native.ic0_inplace`,
    f64); the application is a forward solve on ``L`` and the backsolve on
    ``csr_transpose(L)`` (``lower=False``), through ``SptrsvPlan`` ``auto``
    or, with ``trsv_sweeps=k``, ``k`` Jacobi sweeps each. On a non-positive
    pivot the diagonal is shifted and the factorization retried.
    """
    from . import native

    lo = tril(as_csr(a))
    n = lo.shape[0]
    last = lo.indptr[1:] - 1
    has_diag = (lo.indptr[1:] > lo.indptr[:-1]) & (
        lo.indices[np.maximum(last, 0)] == np.arange(n))
    if not has_diag.all():
        raise ValueError("IC(0) needs a full diagonal")
    vals = _shifted(native.ic0_inplace, lo.indptr, lo.indices,
                    cast(lo.data, np.float64), lo.indices == lo.row_ids(),
                    shift, max_shift_tries, "IC(0)")
    l = CSR(lo.shape, lo.indptr, lo.indices, cast(vals, lo.dtype))
    lt = csr_transpose(l)
    dev = _device(device)
    if trsv_sweeps is not None:
        return TriangularPair(
            SptrsvJacobiPlan(l, lower=True, sweeps=trsv_sweeps, device=dev),
            SptrsvJacobiPlan(lt, lower=False, sweeps=trsv_sweeps,
                             device=dev))
    return TriangularPair(SptrsvPlan(l, lower=True, device=dev),
                          SptrsvPlan(lt, lower=False, device=dev))


@span("sblas.solvers.ilu", "build")
def ilu(a, *, shift: float = 0.0, max_shift_tries: int = 6,
        trsv_sweeps: int | None = None, device=None) -> TriangularPair:
    """ILU(0) preconditioner: ``M = L U`` on the pattern of ``A``
    (nonsymmetric).

    The factorization is the host IKJ sweep
    (:func:`sblas_torch.native.ilu0_inplace`, f64); the application is a
    forward solve on the unit-diagonal ``L`` and a backsolve on ``U``,
    through ``SptrsvPlan`` ``auto`` or ``trsv_sweeps`` Jacobi sweeps. On a
    zero pivot the diagonal is shifted and the factorization retried.
    """
    from . import native

    a = as_csr(a)
    if a.shape[0] != a.shape[1]:
        raise ValueError("ILU(0) needs a square matrix")
    if not has_full_diagonal(a):
        raise ValueError("ILU(0) needs a full diagonal")
    coo = a.tocoo()
    vals = _shifted(native.ilu0_inplace, a.indptr, a.indices,
                    cast(coo.data, np.float64), coo.row == coo.col,
                    shift, max_shift_tries, "ILU(0)")
    fac = CSR(a.shape, a.indptr, a.indices, cast(vals, a.dtype))
    l = tril(fac, unit_diagonal=True)
    u = triu(fac)
    dev = _device(device)
    if trsv_sweeps is not None:
        return TriangularPair(
            SptrsvJacobiPlan(l, lower=True, unit_diagonal=True,
                             sweeps=trsv_sweeps, device=dev),
            SptrsvJacobiPlan(u, lower=False, sweeps=trsv_sweeps, device=dev))
    return TriangularPair(
        SptrsvPlan(l, lower=True, unit_diagonal=True, device=dev),
        SptrsvPlan(u, lower=False, device=dev))


def _ilu0_numpy(indptr, indices, vals) -> int:
    """Plain ILU(0) (python IKJ sweep), the version the tests hold the C++
    library to; nothing on the solvers' path calls it."""
    n = len(indptr) - 1
    diag = np.full(n, -1, dtype=np.int64)
    pos = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        p0, p1 = int(indptr[i]), int(indptr[i + 1])
        pos[indices[p0:p1]] = np.arange(p0, p1)
        bad = 0
        for p in range(p0, p1):
            k = int(indices[p])
            if k >= i:
                break
            ukk = vals[diag[k]]
            if ukk == 0.0:
                bad = k + 1
                break
            lik = vals[p] / ukk
            vals[p] = lik
            for q in range(int(diag[k]) + 1, int(indptr[k + 1])):
                pj = pos[indices[q]]
                if pj >= 0:
                    vals[pj] -= lik * vals[q]
        if not bad:
            pd = pos[i]
            if pd < 0 or vals[pd] == 0.0:
                bad = i + 1
            else:
                diag[i] = pd
        pos[indices[p0:p1]] = -1
        if bad:
            return int(bad)
    return 0


def _ic0_numpy(indptr, indices, vals) -> int:
    """Plain IC(0) (python loops), the version the tests hold the C++
    library to; nothing on the solvers' path calls it."""
    n = len(indptr) - 1
    for i in range(n):
        p0, p1 = int(indptr[i]), int(indptr[i + 1])
        for p in range(p0, p1 - 1):
            k = int(indices[p])
            k0, k1 = int(indptr[k]), int(indptr[k + 1]) - 1
            dot = 0.0
            a_, b_ = p0, k0
            while a_ < p and b_ < k1:
                ca, cb = int(indices[a_]), int(indices[b_])
                if ca == cb:
                    dot += vals[a_] * vals[b_]
                    a_ += 1
                    b_ += 1
                elif ca < cb:
                    a_ += 1
                else:
                    b_ += 1
            vals[p] = (vals[p] - dot) / vals[int(indptr[k + 1]) - 1]
        d = vals[p1 - 1] - float(np.sum(vals[p0:p1 - 1] ** 2))
        if not d > 0.0:
            return i + 1
        vals[p1 - 1] = np.sqrt(d)
    return 0


def _is_plan(a) -> bool:
    """Has ``a`` the SpMV protocol: ``shape``, ``dtype``, ``device`` and
    ``a(x, alpha, beta, y)`` (an :class:`SpmvPlan`, a distributed plan of
    :mod:`sblas_torch.parallel`)?"""
    return callable(a) and all(hasattr(a, k) for k in ("shape", "dtype",
                                                        "device"))


def _setup(a, b, x0, name: str, method: str, device):
    """The square plan of ``a`` (a matrix, or a plan with the SpMV
    protocol), and ``b``, ``x`` (``x0`` or zeros) on its device in its
    dtype."""
    plan = a if _is_plan(a) else SpmvPlan(a, method, device=device)
    n = plan.shape[0]
    if plan.shape[0] != plan.shape[1]:
        raise ValueError(f"{name} needs a square matrix")
    kw = {"dtype": plan.dtype, "device": plan.device}
    b = torch.as_tensor(b, **kw)
    x = torch.zeros(n, **kw) if x0 is None else torch.as_tensor(x0, **kw)
    return plan, b, x


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v)


def _rel(rnorm: torch.Tensor, bnorm: torch.Tensor) -> float:
    return float(rnorm / torch.clamp(bnorm, min=1e-30))


def cg(a, b, *, tol: float = 1e-6, maxiter: int = 1000, M=None, x0=None,
       method: str = "auto", device=None):
    """Conjugate gradient for SPD ``A``; ``M`` as :func:`jacobi` or
    :func:`ichol` returns. Returns ``(x, {"iterations", "rel_residual"})``."""
    plan, b, x = _setup(a, b, x0, "cg", method, device)
    bnorm = _norm(b)
    stop = torch.as_tensor(tol, dtype=plan.dtype) * bnorm
    r = plan(x, -1.0, 1.0, b)                      # b - A x0, fused
    z = M(r) if M is not None else r
    p, rz, it = z, torch.dot(r, z), 0
    while it < maxiter and bool(_norm(r) > stop):  # the one host read
        ap = plan(p)
        alpha = rz / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = M(r) if M is not None else r
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz, it = rz_new, it + 1
    return x, {"iterations": it, "rel_residual": _rel(_norm(r), bnorm)}


def bicgstab(a, b, *, tol: float = 1e-6, maxiter: int = 1000, M=None,
             x0=None, method: str = "auto", device=None):
    """BiCGSTAB for general square ``A`` (shadow residual ``r0``), right
    preconditioned by ``M``. Returns ``(x, {"iterations",
    "rel_residual"})``."""
    plan, b, x = _setup(a, b, x0, "bicgstab", method, device)
    bnorm = _norm(b)
    stop = torch.as_tensor(tol, dtype=plan.dtype) * bnorm
    r = plan(x, -1.0, 1.0, b)
    rhat = r
    p, rho, it = r, torch.dot(rhat, r), 0
    while it < maxiter and bool(_norm(r) > stop):  # the one host read
        ph = M(p) if M is not None else p
        v = plan(ph)
        alpha = rho / torch.dot(rhat, v)
        s = r - alpha * v
        sh = M(s) if M is not None else s
        t = plan(sh)
        omega = torch.dot(t, s) / torch.dot(t, t)
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        rho_new = torch.dot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        rho, it = rho_new, it + 1
    return x, {"iterations": it, "rel_residual": _rel(_norm(r), bnorm)}


def gmres(a, b, *, tol: float = 1e-6, maxiter: int = 1000,
          restart: int = 30, M=None, x0=None, method: str = "auto",
          device=None):
    """Restarted GMRES(m), right-preconditioned (solves ``A M^-1 u = b``,
    ``x = M^-1 u``, so the residual it minimizes is the true one).

    Each cycle runs ``restart`` Arnoldi steps (modified Gram-Schmidt on the
    device), whatever the residual on the way, then solves the rotated
    ``(m, m)`` triangle, with zero pivots neutralised (``y_i = 0``): the
    direction converged exactly. ``maxiter`` counts matvecs in steps of
    ``restart``; the cycle's residual is ``|g[m]|`` after the rotations.
    Returns ``(x, {"iterations", "rel_residual"})``.
    """
    plan, b, x = _setup(a, b, x0, "gmres", method, device)
    m, n = int(restart), plan.shape[0]
    dt = np.float64 if plan.dtype == torch.float64 else np.float32
    kw = {"dtype": plan.dtype, "device": plan.device}

    def precond(v):
        return M(v) if M is not None else v

    def cycle(x):
        r = plan(x, -1.0, 1.0, b)
        beta = _norm(r)
        vs = torch.zeros((m + 1, n), **kw)
        vs[0] = r / torch.clamp(beta, min=1e-30)
        h = np.zeros((m + 1, m), dt)
        cs, sn = np.zeros(m, dt), np.zeros(m, dt)
        g = np.zeros(m + 1, dt)
        g[0] = beta.item()
        for j in range(m):
            w = plan(precond(vs[j]))
            hs = []
            for i in range(j + 1):
                hij = torch.dot(vs[i], w)
                w = w - hij * vs[i]
                hs.append(hij)
            hj1 = _norm(w)
            vs[j + 1] = w / torch.clamp(hj1, min=1e-30)
            hc = np.zeros(m + 1, dt)
            hc[:j + 2] = torch.stack([*hs, hj1]).cpu().numpy()  # host read
            for i in range(j):
                hi, hi1 = hc[i], hc[i + 1]
                hc[i] = cs[i] * hi + sn[i] * hi1
                hc[i + 1] = -sn[i] * hi + cs[i] * hi1
            denom = np.sqrt(hc[j] ** 2 + hc[j + 1] ** 2)
            c = hc[j] / max(denom, dt(1e-30)) if denom > 0 else dt(1.0)
            s = hc[j + 1] / max(denom, dt(1e-30)) if denom > 0 else dt(0.0)
            cs[j], sn[j] = c, s
            hc[j], hc[j + 1] = denom, 0.0
            h[:, j] = hc
            gj = g[j]
            g[j], g[j + 1] = c * gj, -s * gj
        # h[:m, :m] is upper triangular after the rotations; a zero pivot
        # means that direction converged exactly: neutralise it (y_i = 0)
        hd = np.diagonal(h[:m, :m])
        hm = h[:m, :m].copy()
        np.fill_diagonal(hm, np.where(hd == 0, 1.0, hd))
        rhs = np.where(hd == 0, 0.0, g[:m]).astype(dt)
        y = torch.linalg.solve_triangular(
            torch.from_numpy(hm), torch.from_numpy(rhs)[:, None],
            upper=True)[:, 0]
        x = x + precond(vs[:m].T @ y.to(plan.device))
        return x, abs(g[m])

    bnorm = dt(_norm(b).item())
    stop = dt(tol) * bnorm
    rnorm = dt(_norm(b - plan(x)).item())
    it = 0
    while rnorm > stop and it < maxiter:
        x, rnorm = cycle(x)
        it += m
    return x, {"iterations": it,
               "rel_residual": float(rnorm / max(bnorm, dt(1e-30)))}
