"""Linear solves: ``sblas_torch.solvers.cg`` on ``SpmvPlan(A,
params["method"])`` with the preconditioner ``params["precond"]``
(``"ic0"``: ``solvers.ichol``, ``"jacobi"``: ``solvers.jacobi``), to
``params["tol"]``, one right-hand side a solve from a fixed pool of
``params["rhs_pool"]`` (``b = A x*``, ``x*`` standard normal from the
mix's ``work_seed``), taken in an order drawn from the run's seed,
``x0 = 0``. The check: each kept answer's true relative residual,
against ``params["limits"]["rel_residual"]``."""

from __future__ import annotations

import numpy as np
import torch

from .. import roofline
from ..reference import cg as ref
from .common import (Sample, host_csr, sync, tri_lower_nnz, work_generator,
                     work_order)


class Solves:
    def __init__(self, inputs: dict, params: dict, seed: int, device,
                 spans, control: bool = False):
        self.inputs, self.p, self.device, self.spans = \
            inputs, params, torch.device(device), spans
        self.control = control
        n, pool = inputs["shape"][0], int(params["rhs_pool"])
        x_true = torch.randn((n, pool),
                             generator=work_generator(params, self.device),
                             dtype=torch.float64, device=self.device)
        self.b = ref.rhs(inputs, x_true).t().contiguous()
        self.order = work_order(seed, pool)
        # counted before the set-up's peak memory is read from zero
        self.lower_nnz = tri_lower_nnz(inputs) \
            if spans.on and params["precond"] == "ic0" else 0
        self.sample = Sample(seed, int(params["check_sample"]))
        self.kept: dict = {}
        self.iterations: list = []
        self.unconverged = 0

    def build(self) -> None:
        import sblas_torch.solvers as solvers
        from sblas_torch.ops.spmv import SpmvPlan

        data = self.inputs["data"]
        if self.control:
            data = data.to(getattr(torch, self.p["control"]["dtype"]))
        a = host_csr(self.inputs, data)
        plan = SpmvPlan(a, self.p["method"], device=self.device)
        self.route = plan.route_reason
        kind = self.p["precond"]
        if kind == "ic0":
            pre = solvers.ichol(a, device=self.device)
        elif kind == "jacobi":
            pre = solvers.jacobi(a, device=self.device)
        else:
            raise ValueError(f"unknown preconditioner {kind!r}")
        self._wrap(plan, pre, data.dtype)

    def _wrap(self, plan, pre, dtype) -> None:
        """The plan and the preconditioner as the solver gets them: bare,
        or inside ranges with each call's least time."""
        m, n = self.inputs["shape"]
        nnz = self.inputs["indices"].numel()
        es = torch.empty((), dtype=dtype).element_size()

        def spmv_least(args, kwargs):
            beta = args[2] if len(args) > 2 else kwargs.get("beta", 0.0)
            return roofline.least_seconds(
                roofline.spmm_bytes(m, n, nnz, 1, es, es, beta != 0),
                roofline.flops(nnz, 1), dtype)

        self.plan = self.spans.wrap("spmv", plan, spmv_least)
        if not self.spans.on:
            self.pre = pre
        elif self.p["precond"] == "ic0":
            least = roofline.least_seconds(
                roofline.sptrsv_bytes(n, self.lower_nnz, 1, es, es),
                roofline.flops(self.lower_nnz, 1), dtype)
            fwd = self.spans.wrap("sptrsv", pre.fwd, lambda a, k: least)
            bwd = self.spans.wrap("sptrsv", pre.bwd, lambda a, k: least)
            self.pre = lambda r: bwd(fwd(r))
        else:
            self.pre = self.spans.wrap("precond", pre)

    def window(self, expected: int) -> None:
        """Forget the warm-up's solves; draw the sample among the
        ``expected`` solves of the window."""
        self.sample.expect(expected)
        self.kept, self.iterations, self.unconverged = {}, [], 0

    def solve(self, i: int) -> None:
        from sblas_torch.solvers import cg

        j = self.order[i % len(self.order)]
        x, info = cg(self.plan, self.b[j], M=self.pre,
                     tol=float(self.p["tol"]), maxiter=int(self.p["maxiter"]))
        sync(self.device)
        self.iterations.append(info["iterations"])
        if not info["rel_residual"] < float(self.p["tol"]):
            self.unconverged += 1
        if self.sample.keep(i):
            self.kept[i] = (j, x)
        self.last = (i, j, x)

    def release(self) -> None:
        self.plan = self.pre = None

    def compare(self) -> tuple[dict, int]:
        """``({name: (value, limit)}, answers over their limit)``."""
        i, j, x = self.last
        kept = {**self.kept, i: (j, x)}
        rel = ref.rel_residuals(self.inputs,
                                [(self.b[j], x) for j, x in kept.values()])
        limit = float(self.p["limits"]["rel_residual"])
        over = sum(1 for r in rel if not r < limit)
        return {"rel_residual": (max(rel), limit)}, over + self.unconverged

    def info(self) -> dict:
        return {"iterations": float(np.mean(self.iterations))
                if self.iterations else None, "route": self.route}
