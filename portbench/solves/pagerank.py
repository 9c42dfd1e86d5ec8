"""GAP PageRank (``params["k"] == 1``) and batched personalized PageRank
(``k > 1``) by power iteration on the column-stochastic operator
``M = A D^-1`` (``A`` the symmetric 0/1 adjacency, ``D`` its degrees),
built on the card in set-up and planned once: ``SpmvPlan(M,
params["method"])`` at ``k == 1``, else ``SpmmPlan(M, params["method"],
k_hint=k)``. The state is float32, as GAP's scores are; each iteration's
L1 change (``vector_norm``, one pass, its tree sum in float32 far finer
than the tolerance) is read on the host (GAP's stopping rule: every
column's change below ``params["tol"]``, or ``params["max_iters"]``
iterations).

- ``k == 1``: ``x = 1/n``, then ``x' = d M x + (1 - d)/n`` (one fused
  call, ``beta = 1`` on the constant teleport vector).
- ``k > 1``: one batch of ``k`` sources a solve, from a fixed pool of
  ``params["source_pool"]`` batches drawn from the mix's ``work_seed``
  among the generated vertices of degree >= 1 (so the same vertices of
  the same graph under every run's labels), taken in an order drawn from
  the run's seed; column ``j`` starts at and teleports to its own source:
  ``X = e_S``, then ``X' = d M X``, ``X'[s_j, j] += 1 - d``.

The check: each kept answer's worst column's L1 gap to the float64
reference, relative to the reference's L1 norm, against
``params["limits"]["rank_gap"]``."""

from __future__ import annotations

import torch

from .. import roofline
from ..reference import pagerank as ref
from .common import Sample, host_csr, sync, work_generator, work_order


class Solves:
    def __init__(self, inputs: dict, params: dict, seed: int, device,
                 spans, control: bool = False):
        self.inputs, self.p, self.device, self.spans = \
            inputs, params, torch.device(device), spans
        self.control = control
        self.k = int(params["k"])
        self.d = float(params["damping"])
        n = inputs["shape"][0]
        indptr = inputs["indptr"].to(torch.int64)
        deg = indptr[1:] - indptr[:-1]
        if self.k == 1:
            self.tele = torch.full((n,), (1.0 - self.d) / n,
                                   dtype=torch.float32, device=self.device)
        else:
            labels = inputs["labels"]
            live = torch.nonzero(deg[labels] > 0)[:, 0]
            pool = int(params["source_pool"])
            pick = torch.randint(
                live.numel(), (pool, self.k),
                generator=work_generator(params, self.device),
                device=self.device)
            self.sources = labels[live[pick]]
            self.order = work_order(seed, pool)
            self.cols = torch.arange(self.k, device=self.device)
        self.sample = Sample(seed, int(params["check_sample"]))
        self.kept: dict = {}
        self.iterations: list = []

    def build(self) -> None:
        from sblas_torch.ops.spmm import SpmmPlan
        from sblas_torch.ops.spmv import SpmvPlan

        indptr = self.inputs["indptr"].to(torch.int64)
        deg = (indptr[1:] - indptr[:-1]).to(torch.float32)
        vals = (1.0 / deg)[self.inputs["indices"].long()]   # M[i, j] = 1/deg j
        a = host_csr(self.inputs, vals)
        del vals
        vd = getattr(torch, self.p["control"]["value_dtype"]) \
            if self.control else torch.float32
        if self.k == 1:
            plan = SpmvPlan(a, self.p["method"], value_dtype=vd,
                            device=self.device)
        else:
            plan = SpmmPlan(a, self.p["method"], k_hint=self.k,
                            value_dtype=vd, device=self.device)
        self.route = plan.route_reason
        m, n = self.inputs["shape"]
        nnz = self.inputs["indices"].numel()
        k, vb = self.k, torch.empty((), dtype=vd).element_size()

        def least(args, kwargs):
            beta = args[2] if len(args) > 2 else kwargs.get("beta", 0.0)
            return roofline.least_seconds(
                roofline.spmm_bytes(m, n, nnz, k, vb, 4, beta != 0),
                roofline.flops(nnz, k), torch.float32)

        self.plan = self.spans.wrap("spmv" if k == 1 else "spmm", plan,
                                    least)

    def window(self, expected: int) -> None:
        self.sample.expect(expected)
        self.kept, self.iterations = {}, []

    def solve(self, i: int) -> None:
        n = self.inputs["shape"][0]
        tol, cap = float(self.p["tol"]), int(self.p["max_iters"])
        if self.k == 1:
            x = torch.full((n,), 1.0 / n, dtype=torch.float32,
                           device=self.device)
        else:
            src = self.sources[self.order[i % len(self.order)]]
            x = torch.zeros((n, self.k), dtype=torch.float32,
                            device=self.device)
            x[src, self.cols] = 1.0
        it = 0
        while it < cap:
            if self.k == 1:
                y = self.plan(x, self.d, 1.0, self.tele)
            else:
                y = self.plan(x, self.d)
                y[src, self.cols] += 1.0 - self.d
            err = torch.linalg.vector_norm(y - x, ord=1, dim=0)
            x, it = y, it + 1
            if float(err.max()) < tol:          # the one host read
                break
        sync(self.device)
        self.iterations.append(it)
        if self.sample.keep(i):
            self.kept[i] = x
        self.last = (i, x)

    def release(self) -> None:
        self.plan = None

    def compare(self) -> tuple[dict, int]:
        i, x = self.last
        kept = {**self.kept, i: x}
        kw = {"damping": self.d, "tol": float(self.p["tol"]),
              "max_iters": int(self.p["max_iters"])}
        gaps = []
        if self.k == 1:
            want, _ = ref.power_iteration(self.inputs, None, **kw)
            gaps = [ref.l1_gap(x, want) for x in kept.values()]
        else:
            for i, x in kept.items():
                src = self.sources[self.order[i % len(self.order)]]
                want, _ = ref.power_iteration(self.inputs, src, **kw)
                gaps.append(ref.l1_gap(x, want))
                del want
        limit = float(self.p["limits"]["rank_gap"])
        over = sum(1 for g in gaps if not g < limit)
        return {"rank_gap": (max(gaps), limit)}, over

    def info(self) -> dict:
        its = self.iterations
        return {"iterations": sum(its) / len(its) if its else None,
                "route": self.route}
