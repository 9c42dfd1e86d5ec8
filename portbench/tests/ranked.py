"""The tests' own multi-rank generator and solve loop, named by full path
in a cell that only the tests make (``portbench.tests.ranked``): no entry
of ``BENCHMARK.json`` names them.

:func:`generate` gives each rank its own rows of a 2D five-point operator
(diagonal ``cfg["diagonal"]``, off-diagonal -1, strictly dominant, so SPD)
on an ``nx`` by ``ny * world`` grid: rank ``r`` owns grid lines ``[r ny,
(r + 1) ny)``. :class:`Solves` gathers the rows into the whole matrix,
which the port's distributed plans take on every rank, and runs the port's
``dist_cg`` with Jacobi (in the range ``precond`` while traced) over a
``DistSpmvPlan`` on the mesh of every rank, in the process group that the
harness made. Each rank checks the true residual of its own rows.
``params["fault"]`` (``{"rank", "kind"}``) plants one fault on one rank,
in the window only: ``wrong`` (its answers altered), ``raise``, ``stop``
(it waits before the solve's first collective until it is stopped) or
``import`` (it loads a module named ``jax``).
"""

from __future__ import annotations

import sys
import time
import types

import numpy as np
import torch
import torch.distributed as dist

from portbench.reference import cg as ref
from portbench.solves.common import Sample, sync


def generate(cfg: dict, seed: int, device, rank: int = 0,
             world: int = 1) -> dict:
    nx, ny = int(cfg["nx"]), int(cfg["ny"])
    n, rows = nx * ny * world, nx * ny
    row = torch.arange(rank * rows, (rank + 1) * rows, device=device)
    ix, iy = row % nx, row // nx
    cols, keep = [], []
    for dx, dy in ((0, -1), (-1, 0), (0, 0), (1, 0), (0, 1)):
        cols.append(row + dy * nx + dx)
        keep.append((ix + dx >= 0) & (ix + dx < nx) & (iy + dy >= 0)
                    & (iy + dy < ny * world))
    cols, keep = torch.stack(cols, 1), torch.stack(keep, 1)
    indices = cols[keep]
    data = torch.where(indices == row[:, None].expand(-1, 5)[keep],
                       float(cfg["diagonal"]), -1.0).to(torch.float64)
    indptr = torch.zeros(rows + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(keep.sum(1), 0)
    return {"shape": (rows, n), "row0": rank * rows,
            "indptr": indptr.to(torch.int32),
            "indices": indices.to(torch.int32), "data": data}


class Solves:
    def __init__(self, inputs: dict, params: dict, seed: int, device,
                 spans, control: bool = False, rank: int = 0,
                 world: int = 1):
        self.inputs, self.p, self.device, self.spans = \
            inputs, params, torch.device(device), spans
        self.rank = rank
        fault = params.get("fault", {})
        self.fault = fault.get("kind") if fault.get("rank") == rank else None
        self.sample = Sample(seed, int(params["check_sample"]))
        self.kept, self.iterations = {}, []

    def build(self) -> None:
        from sblas_torch import solvers
        from sblas_torch.formats import CSR
        from sblas_torch.parallel import DistSpmvPlan, make_mesh

        mesh = make_mesh(device=self.device)
        mine = tuple(self.inputs[k].cpu().numpy()
                     for k in ("indptr", "indices", "data"))
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        offsets = np.cumsum([0] + [p[0][-1] for p in every[:-1]])
        n = self.inputs["shape"][1]
        a = CSR((n, n), np.concatenate(
            [[0]] + [p[0][1:].astype(np.int64) + o
                     for p, o in zip(every, offsets)]),
            np.concatenate([p[1] for p in every]),
            np.concatenate([p[2] for p in every]))
        gen = torch.Generator().manual_seed(int(self.p["work_seed"]))
        x_true = torch.randn(n, generator=gen, dtype=torch.float64)
        whole = {"shape": (n, n), "indptr": torch.from_numpy(a.indptr),
                 "indices": torch.from_numpy(a.indices),
                 "data": torch.from_numpy(a.data)}
        self.b = ref.rhs(whole, x_true).to(self.device)
        self.plan = DistSpmvPlan(a, mesh)
        self.pre = self.spans.wrap("precond",
                                   solvers.jacobi(a, device=self.device))
        self.route = (f"{mesh.backend}, {mesh.transport}, "
                      f"{self.plan.route_reason}")

    def window(self, expected: int) -> None:
        self.sample.expect(expected)
        self.kept, self.iterations = {}, []

    def solve(self, i: int) -> None:
        from sblas_torch.parallel import dist_cg

        if i >= 0 and self.fault == "raise":
            raise RuntimeError(f"planted fault: rank {self.rank} raises")
        if i >= 0 and self.fault == "stop":
            time.sleep(3600)
        if i >= 0 and self.fault == "import":
            sys.modules.setdefault("jax", types.ModuleType("jax"))
        x, info = dist_cg(self.plan, self.b, M=self.pre,
                          tol=float(self.p["tol"]),
                          maxiter=int(self.p["maxiter"]))
        sync(self.device)
        if i >= 0 and self.fault == "wrong":
            x = x * (1 + 1e-3)
        self.iterations.append(info["iterations"])
        if self.sample.keep(i):
            self.kept[i] = x
        self.last = (i, x)

    def release(self) -> None:
        self.plan = self.pre = None

    def compare(self) -> tuple[dict, int]:
        """This rank's rows: ``||b_r - A_r x|| / ||b_r||`` of each kept
        answer."""
        i, x = self.last
        r0, rows = self.inputs["row0"], self.inputs["shape"][0]
        b = self.b[r0:r0 + rows]
        kept = {**self.kept, i: x}
        rel = ref.rel_residuals(self.inputs, [(b, y) for y in kept.values()])
        limit = float(self.p["limits"]["rel_residual"])
        return {"rel_residual": (max(rel), limit)}, \
            sum(1 for r in rel if not r < limit)

    def info(self) -> dict:
        return {"iterations": float(np.mean(self.iterations)),
                "route": self.route}
