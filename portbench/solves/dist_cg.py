"""Linear solves across the cell's cards on row-sharded vectors: each rank
holds its own rows of the matrix (a generator that takes ``rank`` and
``world``), builds the port's halo plan from those rows alone
(``HaloSpmvPlan(rows, mesh, row0=...)``) and the Jacobi preconditioner of
its block, and runs ``sblas_torch.parallel.dist_cg`` on them to
``params["tol"]`` from ``x0 = 0``: ``b``, ``x`` and every vector of the
loop are each rank's rows. One right-hand side a solve from a fixed pool
of ``params["rhs_pool"]``: ``b = A x*``, ``x*`` standard normal over all
``n`` rows from the mix's ``work_seed``, drawn on every rank alike, of
which each rank keeps its rows of ``b`` (the plain reference) and drops
``x*``; taken in an order drawn from the run's seed.

The check, after the window: each kept answer gathered whole on every rank
by ``torch.distributed`` itself, each rank's ``||b_r - A_r x||^2`` and
``||b_r||^2`` by the plain reference, added over the ranks by one
``all_reduce``: the global ``||b - A x|| / ||b||``, the same on every rank,
against ``params["limits"]["rel_residual"]``."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .. import roofline
from ..reference import cg as ref
from ..reference.sparse import csr_f64, matmul
from .common import Sample, host_csr, sync, work_generator, work_order

# torch 2.13 renames all_gather_into_tensor; earlier versions have only it
_all_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


class Solves:
    def __init__(self, inputs: dict, params: dict, seed: int, device,
                 spans, control: bool = False, rank: int = 0,
                 world: int = 1):
        if params["precond"] != "jacobi":
            raise ValueError(f"dist_cg runs Jacobi only, not "
                             f"{params['precond']!r}")
        self.inputs, self.p, self.device, self.spans = \
            inputs, params, torch.device(device), spans
        self.control = control
        n = inputs["shape"][1]
        gen = work_generator(params, self.device)
        self.b = []
        for _ in range(int(params["rhs_pool"])):
            x_true = torch.randn(n, generator=gen, dtype=torch.float64,
                                 device=self.device)
            self.b.append(ref.rhs(inputs, x_true))
            del x_true
        self.order = work_order(seed, len(self.b))
        self.sample = Sample(seed, int(params["check_sample"]))
        self.kept: dict = {}
        self.iterations: list = []
        self.unconverged = 0

    def build(self) -> None:
        from sblas_torch import solvers
        from sblas_torch.parallel import HaloSpmvPlan, make_mesh

        data = self.inputs["data"]
        if self.control:
            data = data.to(getattr(torch, self.p["control"]["dtype"]))
        rows = host_csr(self.inputs, data)
        row0 = int(self.inputs["row0"])
        mesh = make_mesh(device=self.device)
        plan = HaloSpmvPlan(rows, mesh, row0=row0,
                            local_method=self.p["method"])
        pre = solvers.jacobi(rows, row0=row0, device=self.device)
        self.route = (f"{mesh.backend}, {mesh.transport}, halo "
                      f"{plan.halo}, {plan.route_reason}")
        m, nnz = rows.shape[0], rows.nnz
        ext = m + 2 * plan.halo
        es = torch.empty((), dtype=data.dtype).element_size()

        def least(args, kwargs):
            """The rank's local SpMV on its ``(rows, rows + 2H)`` block."""
            beta = args[2] if len(args) > 2 else kwargs.get("beta", 0.0)
            return roofline.least_seconds(
                roofline.spmm_bytes(m, ext, nnz, 1, es, es, beta != 0),
                roofline.flops(nnz, 1), data.dtype)

        self.plan = self.spans.wrap("halo_spmv", plan.sharded(), least)
        self.pre = self.spans.wrap("precond", pre)

    def window(self, expected: int) -> None:
        """Forget the warm-up's solves; draw the sample among the
        ``expected`` solves of the window: rank 0's count, since each
        rank's comes from its own warm-up's time, and every rank has to
        keep the same solves for ``compare``'s collectives."""
        count = torch.tensor([expected], device=self.device)
        dist.broadcast(count, src=0)
        self.sample.expect(int(count))
        self.kept, self.iterations, self.unconverged = {}, [], 0

    def solve(self, i: int) -> None:
        from sblas_torch.parallel import dist_cg

        j = self.order[i % len(self.order)]
        x, info = dist_cg(self.plan, self.b[j], M=self.pre,
                          tol=float(self.p["tol"]),
                          maxiter=int(self.p["maxiter"]))
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
        """``({name: (value, limit)}, answers over their limit)``: the
        global relative residual of each kept answer, on every rank."""
        i, j, x = self.last
        kept = {**self.kept, i: (j, x)}
        a = csr_f64(self.inputs)
        n = self.inputs["shape"][1]
        sums = []
        for j, x in kept.values():
            whole = x.new_empty(n)
            _all_gather_into(whole, x.contiguous())
            b = self.b[j].to(torch.float64)
            r = b - matmul(a, whole.to(torch.float64))
            sums.append(torch.stack([r.dot(r), b.dot(b)]))
            del whole, r
        sums = torch.stack(sums)
        dist.all_reduce(sums)
        rel = (sums[:, 0].sqrt() / sums[:, 1].sqrt()).tolist()
        limit = float(self.p["limits"]["rel_residual"])
        over = sum(1 for r in rel if not r < limit)
        return {"rel_residual": (max(rel), limit)}, over + self.unconverged

    def info(self) -> dict:
        return {"iterations": float(np.mean(self.iterations))
                if self.iterations else None, "route": self.route}
