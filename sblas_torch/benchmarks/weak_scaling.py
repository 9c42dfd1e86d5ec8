"""Weak scaling of the distributed plans: the port of
``benchmarks/weak_scaling.py`` (BASELINE config 5: uk-2002/twitter7-like
graphs, each rank's share of the work held as the rank count grows).

    python -m sblas_torch.benchmarks.weak_scaling --plan 1d --chips 1,2,4
    python -m sblas_torch.benchmarks.weak_scaling --device cpu --chips 1,2 \\
        --plan cg --rows-per-chip 400

``--plan``: ``1d`` (row split, ``x`` gathered), ``2d`` (the most square
``rows`` x ``cols`` mesh: ``x`` sharded over ``cols``, partial ``y``
summed), ``halo`` (neighbour strips; band-local matrices), ``cg`` (CG on a
Poisson grid of ``rows-per-chip * chips`` rows: the iteration count must be
the single-device solver's) and ``spmm`` (``--nrhs`` columns). The
triangular solves (``sptrsv``, ``sptrsm``) have no distributed port yet
(``sblas_torch.parallel.NOT_PORTED``): asking for them raises.

One group of ``max(--chips)`` ranks runs every count (``torchrun``'s ranks,
or local ranks it starts): at ``c`` ranks the mesh is the first ``c``
ranks, the rest wait. Each record carries the validation against scipy, the
nnz balance, the stream bytes a rank and the collective bytes a rank, the
backend, the transport and ``correctness_only``: true on the CPU and where
ranks share a card, whose times say nothing of a deployment; otherwise it
also times the plan (``bench_lib.dist_seconds``) and gives GB/s a rank and
the weak-scaling efficiency against the first count. Rank 0 prints each
record and appends it to ``--out`` (default
``build/sblas_torch/weak_<time>.jsonl``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

PLANS = ("1d", "2d", "halo", "cg", "spmm")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m sblas_torch.benchmarks.weak_scaling")
    ap.add_argument("--rows-per-chip", type=int, default=100_000)
    ap.add_argument("--avg-deg", type=float, default=16.0)
    ap.add_argument("--kind", choices=["powerlaw", "fem"],
                    default="powerlaw")
    ap.add_argument("--chips", default="1,2,4")
    ap.add_argument("--plan", choices=[*PLANS, "sptrsv", "sptrsm"],
                    default="1d")
    ap.add_argument("--nrhs", type=int, default=8,
                    help="columns for --plan spmm")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None)
    return ap


def _matrix(args, n: int, seed: int):
    from .. import datasets

    if args.kind == "powerlaw" and args.plan != "halo":
        return datasets.powerlaw_graph(n, avg_deg=args.avg_deg, seed=seed,
                                       dtype=np.float32)
    return datasets.random_csr(n, n, args.avg_deg,
                               bandwidth=int(args.avg_deg * 3), seed=seed,
                               dtype=np.float32)


def _record(args, nc: int, dev) -> dict | None:
    """The record of ``nc`` ranks (None on the ranks off the mesh)."""
    from .. import solvers
    from ..bench_lib import EPS, dist_seconds
    from ..golden import rel_err, spmm_golden, spmv_golden
    from ..parallel import (DistSpmmPlan, DistSpmvPlan, Dist2DSpmvPlan,
                            HaloSpmvPlan, dist_cg, make_mesh, make_mesh2d)

    if args.plan == "2d":
        r = int(np.sqrt(nc))
        while nc % r:
            r -= 1
        mesh = make_mesh2d(r, nc // r, device=dev)
    else:
        mesh = make_mesh(nc, device=dev)
    if not mesh.member:
        return None
    rec = {"chips": nc, "plan": args.plan, "backend": mesh.backend,
           "transport": mesh.transport, "ranks_per_card": mesh.ranks_per_card,
           "correctness_only": mesh.correctness_only}
    rng = np.random.default_rng(0)
    if args.plan == "cg":
        side = max(int(np.sqrt(args.rows_per_chip * nc)), 4)
        from .. import datasets

        a = datasets.poisson2d(side, dtype=np.float32)
        n = a.shape[0]
        b = rng.standard_normal(n).astype(np.float32)
        plan = DistSpmvPlan(a, mesh)
        t0 = time.perf_counter()
        x, info = dist_cg(plan, b, tol=1e-5, maxiter=4000)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        dt = time.perf_counter() - t0
        _, one = solvers.cg(a, b, tol=1e-5, maxiter=4000,
                            device=mesh.device)
        xs = x.cpu().numpy()
        rec.update(n=n, nnz=a.nnz, iterations=info["iterations"],
                   iterations_single_chip=one["iterations"],
                   rel_residual=info["rel_residual"],
                   true_rel_err=float(np.linalg.norm(a.to_scipy() @ xs - b)
                                      / np.linalg.norm(b)),
                   solve_seconds=dt,
                   allgather_bytes_per_chip_per_iter=int(
                       (plan.n_pad - plan.x_chunk) * 4),
                   local_method=plan.local_method)
        return rec
    n = args.rows_per_chip * nc
    a = _matrix(args, n, nc)
    if args.plan == "spmm":
        plan = DistSpmmPlan(a, mesh, k_hint=args.nrhs)
        x = rng.standard_normal((n, args.nrhs)).astype(np.float32)
        err = rel_err(plan(x).cpu().numpy(), spmm_golden(a, x))
        rec.update(k=args.nrhs, stream_bytes_per_chip=int(
            plan.bytes_per_iter_nx // nc),
            x_gather_bytes_per_chip=int((plan.n_pad - plan.x_chunk) * 4
                                        * args.nrhs))
    else:
        plan = {"1d": DistSpmvPlan, "2d": Dist2DSpmvPlan,
                "halo": HaloSpmvPlan}[args.plan](a, mesh)
        x = rng.standard_normal(n).astype(np.float32)
        err = rel_err(plan(x).cpu().numpy(), spmv_golden(a, x))
        rec["stream_bytes_per_chip"] = int(plan.bytes_per_iter // nc)
        if args.plan == "2d":
            rec["grid"] = "x".join(map(str, plan.grid))
            rec["collective_bytes_per_chip"] = plan.collective_bytes()
        elif args.plan == "halo":
            rec["halo"] = int(plan.halo)
            rec["collective_bytes_per_chip"] = int(
                plan.collective_bytes_per_chip)
        else:
            rec["x_gather_bytes_per_chip"] = int(
                (plan.n_pad - plan.x_chunk) * 4)
    rec.update(n=n, nnz=a.nnz, rel_err=float(err),
               nnz_balance=float(getattr(plan, "nnz_balance", 1.0)),
               local_method=plan.local_method,
               routes=[r[0] for r in plan.routes])
    if not mesh.correctness_only:
        xd = torch.as_tensor(x, device=mesh.device)
        per, rec["timer"] = dist_seconds(
            mesh, lambda c, x0: plan(c, EPS, 1.0, x0), xd, xd)
        rec["seconds_per_iter"] = per
        nbytes = plan.bytes_per_iter_nx if args.plan == "spmm" \
            else plan.bytes_per_iter
        rec["gbps_per_chip"] = nbytes / nc / per / 1e9
    return rec


def _rank(argv) -> int:
    """One rank's run of every count; rank 0 writes the records."""
    import torch.distributed as dist

    args = _parser().parse_args(argv)
    dev = None if args.device == "cuda" else torch.device("cpu")
    counts = [int(c) for c in args.chips.split(",")]
    out = Path(args.out) if args.out else (
        Path(__file__).resolve().parents[2] / "build" / "sblas_torch"
        / f"weak_{int(time.time())}.jsonl")
    results = []
    for nc in counts:
        rec = _record(args, nc, dev)
        if dist.get_rank() != 0:
            continue
        if results and "gbps_per_chip" in rec:
            rec["weak_efficiency"] = (rec["gbps_per_chip"]
                                      / results[0]["gbps_per_chip"])
        results.append(rec)
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)
    return len(results)


def main(argv=None) -> int:
    from ..parallel import NOT_PORTED
    from ..parallel.launch import spawn
    from ..utils.backend import pick_device

    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    if args.plan in ("sptrsv", "sptrsm"):
        raise NotImplementedError(
            f"--plan {args.plan}: the distributed triangular solves have no "
            f"port yet (sblas_torch.parallel.NOT_PORTED = {NOT_PORTED})")
    pick_device(args.device)            # raises where the card is missing
    if "RANK" in os.environ:            # torchrun started this rank
        _rank(argv)
    else:
        world = max(int(c) for c in args.chips.split(","))
        spawn(world, _rank, argv, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
