#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sblas_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of the repository

It builds the port's CUDA kernels from the sources in the checkout and
holds each against its plain torch version on the card (the f64 builds of
the csr and solve kernels too; the nnz-balanced kernel's rows and columns
kernels at K > 1 on the small cases at every K from 1 to 64). It drives the
main paths a user calls, each with every kernel launch count set to 0 just
before it and read just after:

- SpMV (``sblas_torch.spmv``, ``method="auto"``, f32 ``y = alpha A x +
  beta y``, bf16 values, ``trans``) on the emulated SuiteSparse ``cant`` at
  full size, a 1M-row FEM band matrix with 110M nonzeros, and the web
  graphs ``uk-2002`` at 5% and ``twitter7`` at 2% scale (BASELINE.json
  config 5); and ``method="rcm"`` on a band matrix with scrambled numbering;
- SpMM (``sblas_torch.spmm``, ``method="auto"``, ``Y = alpha A X + beta
  Y``) on full-size ``cant``, ``consph`` and ``pdb1HYS`` at K = 8 and 32,
  the FEM band at K = 8 and both graphs at K = 8 and 32;
- the triangular solves (``sblas_torch.sptrsv`` and ``sptrsm``,
  ``method="auto"``: the sync-free kernel) on the factors of BASELINE.json
  config 3 that ``benchmarks/run_suite.py`` solves (``band-parallel``,
  ``chol-nd-poisson2d-60`` and ``-120``) and on ``chol-nd-poisson2d-1000``,
  the same Cholesky factor at 1M rows and 50M nonzeros: K = 1 and 8, and
  ``trans=True`` (the Cholesky backsolve); and ``method="jacobi"`` on
  ``band-parallel``;
- f64 SpMV (BASELINE.json config 1: ``auto`` and ``method="pallas_ds"``,
  ``y = A x / 3 - y / 2``, ``trans``) on ``cant`` and the FEM band, f64
  SpMM (``auto``) on ``cant`` at K = 8, f64 SpMV and SpMM at K = 8
  (``auto``: the nnz-balanced kernel's f64 build) on ``uk-2002`` at 5%,
  and the f64 solves (``auto``: K = 1, 8 and the backsolve) on
  ``band-parallel`` and ``chol-nd-poisson2d-1000``, all on the f64 builds
  of the kernels;
- the Krylov solvers (``sblas_torch.solvers``): CG with Jacobi in f64 on a
  1M-row Poisson grid to convergence, IC(0)-CG, ILU(0)-BiCGSTAB and
  ILU(0)-GMRES(30) in f64 to convergence on 256 x 256 grids, and CG in f32
  on the 1M-row grid;
- the port's own entry points: the CLI (``sblas_torch.cli.main`` in this
  process: ``spmv`` on cant, ``spmm`` on cant at K = 32, ``sptrsv`` and
  ``sptrsm`` at K = 8 on ``chol:poisson:120``, ``solve`` IC(0)-CG in f64
  on ``poisson:256`` to 1e-8, ``stream``), the examples
  (``sblas_torch.examples``: each ``main()``, then checked as the JAX
  package's ``tests/test_examples.py`` checks its own) and the suite
  (``sblas_torch.benchmarks.run_suite --quick --case cant``);
- the distributed plans (``sblas_torch.parallel``, :func:`dist_phase`): a
  world of one rank over NCCL in this process, every plan on cant and
  ``uk-2002`` at 5% (and the halo plans on the FEM band) with ``dist_cg``
  f64 on the 1M-row Poisson grid, and the distributed triangular solves
  (``DistSptrsvPlan``, ``DistSptrsmPlan`` at K = 8) on
  ``chol-nd-poisson2d-1000`` in f64 (one batch, the single-device plan's
  bits at K = 1), each timed beside the single-device plan; then four ranks
  sharing the card over gloo, staged through host memory (correctness
  only), with the solves on ``chol-nd-poisson2d-120`` in f32 and f64 at
  K = 1 and 4, lower and upper, each rank's local route launching its
  kernel and every rank returning the same bits;

checks every result against scipy, and fails where the route the rule
picked launched no kernel (in f64: no f64 build). It times each kernel
beside its plain version, its bound (bytes at the card's data-sheet memory
rate, or flops at its rate for the type: fp32 or fp64), cuSPARSE and a
STREAM triad, times the routes of each matrix
against each other (``rule_picked``, ``faster_route``), times the SpMV
csr kernel at every lanes-per-row width it takes (each width checked
first), times each solve beside its plain version, its bound, its ns
per level and cuSPARSE's ``triangular_solve``, the block kernel at K = 8
and 32 at both block heights, the nnz-balanced kernel's rows and columns
kernels (also at K = 16, where the rule switches) and the columns kernel
in column-chunk-major order (one launch a half of X's columns) on both
graphs at K = 8 and 32, and times IC(0)-CG for 30 iterations on the
1M-row grid: ms per iteration, split into the SpMV, the two triangular
solves and the rest, with the true residual. The solve kernel takes its
tickets level by level, small levels grouped; every factor's solve, the
1M-row IC(0) and ILU(0) factors' among them, is held bit for bit to the
same kernel in plain level order and in row order (its earlier ticket
orders) and with small levels grouped up to 512 .. 4,096 rows; the
nnz-balanced kernel is held to its plain version at every share size it
takes; ILU(0)-BiCGSTAB and ILU(0)-GMRES(30) on the 1M-row grid report the
true residual. The suite (``python -m sblas_torch.benchmarks.run_suite``)
times what this run only checks: those orders, the share and ticket group
sizes, the other solvers, the factorizations and the large cases. It
imports only the port.

Output: one JSON line per phase; a ``{"kernels": [...]}`` line; the card's
``name, power.limit`` as nvidia-smi prints it; and last
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero; so it does without a CUDA device, where it prints no result.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import sys
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np


T_START = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


# the dist phase's alpha, beta and tolerance (f32 against scipy)
DIST_AB = (2.5, -0.5)
DIST_TOL = 2e-5


# the launch counters (``bench_lib.COUNTERS``) of each local route's kernel
# builds: a dist plan's call must move one of its route's, of its dtype
ROUTE_COUNTERS = {"csr": ("spmv_csr", "spmv_csr_f64"),
                  "block": ("spmm_bsr",),
                  "merge": ("spmm_csr", "spmm_csr_f64", "spmm_csr_rows",
                            "spmm_csr_cols", "spmm_csr_cols_f64")}
ROUTE_COUNTERS["pseg"] = ROUTE_COUNTERS["merge"]
ROUTE_COUNTERS["syncfree"] = ("sptrsv_csr", "sptrsv_csr_f64")


def _window(call) -> tuple:
    """``call()`` with every launch count set to 0 just before it and read
    just after: ``(its result, {counter: launches} of those that
    moved)``."""
    import torch

    from sblas_torch.bench_lib import COUNTERS, launch_counts

    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)
    out = call()
    torch.cuda.synchronize()
    return out, {k: v for k, v in launch_counts().items() if v}


def _check_routes(label: str, methods, moved: dict, f64: bool) -> None:
    """Raise unless, for each local route in ``methods``, a counter of its
    kernel builds of the dtype (f64 or not) moved."""
    for method in sorted(set(methods)):
        family = [k for k in ROUTE_COUNTERS.get(method, ())
                  if k.endswith("_f64") == f64]
        if not any(moved.get(k) for k in family):
            raise RuntimeError(f"{label}: route {method!r} launched none of "
                               f"{family} (launches {moved})")


def _dist_inputs(name: str, a, k, cache: dict) -> tuple:
    """x (or X), y and scipy's ``alpha A x + beta y`` for a matrix and K,
    the same on every rank (seeded by the matrix's name and K), computed
    once a run: every plan of the matrix at K takes them."""
    from sblas_torch.golden import spmm_golden, spmv_golden

    if (name, k) not in cache:
        rng = np.random.default_rng(zlib.crc32(f"{name} {k}".encode()))
        m, n = a.shape
        tail = () if k is None else (k,)
        x = rng.standard_normal((n, *tail)).astype(a.dtype)
        y = rng.standard_normal((m, *tail)).astype(a.dtype)
        golden = spmv_golden if k is None else spmm_golden
        cache[name, k] = x, y, golden(a, x, *DIST_AB, y)
    return cache[name, k]


def _dist_cases(mats: dict, meshes: dict, world: int) -> list:
    """``(matrix name, plan label, k, make_plan)`` of every plan the dist
    phase runs on ``world`` ranks: on cant and uk-2002@0.05 the 1D plans
    under each strategy, the ring and the 1D SpMM at K = 8 (and 32 at one
    rank); the 2D
    and hierarchical plans (on cant alone at one rank, where they run the
    1D plans' local work); the halo plans on the FEM band at one rank, on
    cant and uk-2002@0.05 (refused: its halo is not band-local) at
    several."""
    from sblas_torch import parallel as par

    one, two, hier = meshes["1d"], meshes["2d"], meshes["hier"]
    cases = []
    for name in ("cant", "uk-2002@0.05"):
        a = mats[name]
        for st in ("even_rows", "nnz_balanced", "nnz_split"):
            cases.append((name, f"DistSpmvPlan {st}", None,
                          lambda a=a, st=st: par.DistSpmvPlan(
                              a, one, strategy=st)))
        cases.append((name, "RingSpmvPlan", None,
                      lambda a=a: par.RingSpmvPlan(a, one)))
        for k in (8, 32) if world == 1 else (8,):
            cases.append((name, f"DistSpmmPlan K={k}", k,
                          lambda a=a, k=k: par.DistSpmmPlan(a, one,
                                                            k_hint=k)))
        if world == 1 and name != "cant":
            continue
        cases.append((name, "Dist2DSpmvPlan", None,
                      lambda a=a: par.Dist2DSpmvPlan(a, two)))
        cases.append((name, "Dist2DSpmmPlan K=8", 8,
                      lambda a=a: par.Dist2DSpmmPlan(a, two)))
        for st in ("nnz_balanced", "nnz_split"):
            cases.append((name, f"HierSpmvPlan {st}", None,
                          lambda a=a, st=st: par.HierSpmvPlan(
                              a, hier, strategy=st)))
        cases.append((name, "HierSpmmPlan K=8", 8,
                      lambda a=a: par.HierSpmmPlan(a, hier)))
    for name in (("fem-band-1M-112M",) if world == 1
                 else ("cant", "uk-2002@0.05")):
        a = mats[name]
        cases.append((name, "HaloSpmvPlan", None,
                      lambda a=a: par.HaloSpmvPlan(a, one)))
        cases.append((name, "HaloSpmmPlan K=8", 8,
                      lambda a=a: par.HaloSpmmPlan(a, one)))
    return cases


def _dist_run(name, label, k, make, mats, inputs: dict) -> tuple:
    """Build and call one dist plan against scipy: ``(plan, record)``, or
    ``(None, record)`` where the plan refused the matrix. The call is its
    own launch window (``_window``): raises where the result is off or
    where a local route of this rank (each step's, on the ring) launched
    none of its kernel builds."""
    from sblas_torch.golden import rel_err

    t0 = time.perf_counter()
    try:
        plan = make()
    except ValueError as e:
        return None, {"refused": str(e)}
    build_s = time.perf_counter() - t0
    x, y, want = _dist_inputs(name, mats[name], k, inputs)
    got, moved = _window(lambda: plan(x, *DIST_AB, y))
    out = got.cpu().numpy()
    err = rel_err(out, want)
    if out.shape != want.shape or not np.isfinite(out).all() or \
            not err < DIST_TOL:
        raise RuntimeError(f"{name} {label}: rel_err {err} vs scipy (tol "
                           f"{DIST_TOL})")
    methods = getattr(plan, "step_methods", [plan.local_method])
    _check_routes(f"{name} {label}", methods, moved, f64=False)
    return plan, {"rel_err": err, "route": plan.local_method,
                  "step_routes": methods, "launches": moved,
                  "sha256": hashlib.sha256(out.tobytes()).hexdigest()[:16],
                  "build_s": build_s,
                  "seconds": time.perf_counter() - t0}


# the 4-rank gloo run of dist_cg stops here (a cut depth: an iteration
# there costs ~20 ms of host staging); the world of one runs the same cut
# too, and the two iterates must be the same bits
DIST_CG_CUT = 100


def _dist_cg(mesh, a, b, cut: bool = False) -> dict:
    """dist_cg in f64 with Jacobi: to 1e-8, its true residual within 2e-8;
    or, ``cut``, ``DIST_CG_CUT`` iterations, its reported residual within
    1e-6 of the true one. The solve is its own launch window: its plan's
    route must launch its f64 kernel build."""
    from sblas_torch import parallel as par
    from sblas_torch import solvers

    t0 = time.perf_counter()
    tol, maxiter = (0.0, DIST_CG_CUT) if cut else (1e-8, 20000)
    plan = par.DistSpmvPlan(a, mesh)        # dist_cg's own default plan
    m = solvers.jacobi(a, device=mesh.device)
    (x, info), moved = _window(lambda: par.dist_cg(
        plan, b, tol=tol, maxiter=maxiter, M=m))
    xs = x.cpu().numpy()
    true = float(np.linalg.norm(b - a.to_scipy() @ xs) / np.linalg.norm(b))
    agree = abs(info["rel_residual"] - true) / true
    if not np.isfinite(xs).all() or (
            not (info["iterations"] == DIST_CG_CUT and agree <= 1e-6)
            if cut else not (info["rel_residual"] < 1e-8 and true <= 2e-8)):
        raise RuntimeError(f"dist_cg: {info}, true residual {true}")
    _check_routes("dist_cg", [plan.local_method], moved, f64=True)
    return {**info, "true_rel_residual": true, "route": plan.local_method,
            "step_routes": [plan.local_method], "launches": moved, "seconds": time.perf_counter() - t0,
            "sha256": hashlib.sha256(xs.tobytes()).hexdigest()[:16]}


# the dist solves against scipy (sblas_torch.golden's solve tolerances)
DIST_SOLVE_TOL = {np.float32: 1e-3, np.float64: 1e-10}


def _dist_solve(mesh, l, k, lower: bool = True) -> tuple:
    """``DistSptrsvPlan`` (``k`` None) or ``DistSptrsmPlan`` (``k``
    columns) of the factor ``l`` built and called once against scipy, the
    call in a launch window of its own: ``(plan, b, x, record)``. Raises
    where the result is off, or where a local route of the rank (the
    sync-free kernel; the csr or merge kernel where the rank has off-batch
    entries) launched none of its kernel builds of the dtype."""
    from sblas_torch import parallel as par
    from sblas_torch.golden import rel_err, sptrsm_golden, sptrsv_golden

    rng = np.random.default_rng(zlib.crc32(f"{l.shape} {k}".encode()))
    b = rng.standard_normal((l.shape[0], *(() if k is None else (k,))))
    b = b.astype(l.dtype)
    t0 = time.perf_counter()
    plan = (par.DistSptrsvPlan(l, mesh, lower=lower) if k is None else
            par.DistSptrsmPlan(l, mesh, lower=lower))
    build_s = time.perf_counter() - t0
    x, moved = _window(lambda: plan(b))
    out = x.cpu().numpy()
    want = (sptrsv_golden(l, b, lower=lower) if k is None else
            sptrsm_golden(l, b, lower=lower))
    err = rel_err(out, want)
    tol = DIST_SOLVE_TOL[np.dtype(l.dtype).type]
    label = f"{plan.__class__.__name__} K={k or 1} lower={lower}"
    if out.shape != want.shape or not np.isfinite(out).all() or \
            not err < tol:
        raise RuntimeError(f"{label}: rel_err {err} vs scipy (tol {tol})")
    _check_routes(label, plan.step_methods, moved,
                  f64=l.dtype == np.float64)
    return plan, b, x, {
        "rel_err": err, "nlevels": plan.nlevels, "nbatches": plan.nbatches,
        "step_routes": plan.step_methods, "launches": moved,
        "sha256": hashlib.sha256(out.tobytes()).hexdigest()[:16],
        "build_s": build_s, "seconds": time.perf_counter() - t0}


def _dist_rank_solves(mesh, chol) -> dict:
    """The 4-rank dist solves: ``chol`` (chol-nd-poisson2d-120) in f32 and
    f64, K = 1 and 4, lower and upper (its transpose)."""
    from sblas_torch.formats import csr_transpose

    out = {}
    for dt in (np.float32, np.float64):
        low = chol.astype(dt)
        for lower, l in ((True, low), (False, csr_transpose(low))):
            for k in (None, 4):
                name = "DistSptrsvPlan" if k is None else "DistSptrsmPlan"
                label = (f"chol-nd-poisson2d-120 {np.dtype(dt).name} {name} "
                         f"K={k or 1} {'lower' if lower else 'upper'}")
                out[label] = _dist_solve(mesh, l, k, lower)[3]
    return out


DIST_RANK_MATS = ("cant", "uk-2002@0.05", "poisson", "chol120")


def _dist_rank(path: str) -> dict:
    """One of the ranks that share the card (gloo, staged through host
    memory): every plan of ``_dist_cases`` on the matrices the parent saved
    to ``path`` (``launch.save_matrix``), 2D and hierarchical on 2 x 2,
    then ``dist_cg`` f64 on the Poisson grid, cut to ``DIST_CG_CUT``
    iterations. Returns each case's record (its result's hash, to hold the
    ranks' bits equal; the launches of its own window)."""
    from sblas_torch import parallel as par
    from sblas_torch.parallel.launch import load_matrix

    with np.load(path) as arrays:
        mats = {name: load_matrix(arrays, name) for name in DIST_RANK_MATS}
    meshes = {"1d": par.make_mesh(), "2d": par.make_mesh2d(2, 2),
              "hier": par.make_mesh_hier(2, 2)}
    out = {"transport": meshes["1d"].transport,
           "ranks_per_card": meshes["1d"].ranks_per_card, "cases": {}}
    inputs = {}
    for name, label, k, make in _dist_cases(mats, meshes, 4):
        out["cases"][f"{name} {label}"] = _dist_run(
            name, label, k, make, mats, inputs)[1]
    b = np.random.default_rng(3).standard_normal(mats["poisson"].shape[0])
    out["cases"][f"dist_cg f64 poisson2d(1000), {DIST_CG_CUT} its"] = \
        _dist_cg(meshes["1d"], mats["poisson"], b, cut=True)
    out["cases"].update(_dist_rank_solves(meshes["1d"], mats["chol120"]))
    return out


def dist_phase(mats: dict, poisson, chol: dict, card: str,
               emit_fn) -> dict:
    """The distributed plans (``sblas_torch.parallel``), in two parts.

    (a) A world of one rank over NCCL in this process, at full size: the
    cases of ``_dist_cases`` at one rank (2D and hierarchical on 1 x 1) and
    ``dist_cg`` f64 with Jacobi on ``poisson`` to 1e-8; each call against
    scipy, in a launch window of its own in which its local route's kernel
    must launch. Outside those windows: each plan timed beside the
    single-device plan of the same route on the same matrix
    (``bench_lib.dist_seconds``: CUDA graphs where the collectives capture,
    else CUDA events; the record says which), the cost of the collectives
    and the padding at one rank, and on uk-2002@0.05 where it goes; two
    ``bench_lib.bench_dist_spmv`` records; ``solvers.cg``'s iterations
    beside ``dist_cg``'s.

    (b) Four ranks sharing the card over gloo, staged through host memory
    (``correctness_only``), on the arrays this run made, saved to a fresh
    directory: every case on cant and uk-2002@0.05, 2D and hierarchical on
    2 x 2, and ``dist_cg`` f64 on ``poisson`` cut to ``DIST_CG_CUT``
    iterations, whose iterate must be the bits of (a)'s at the same cut;
    every rank's local route must launch its kernel in each call's window,
    and every rank must return the same bits. The triangular solves
    (``DistSptrsvPlan``, ``DistSptrsmPlan``): in (a) on
    chol-nd-poisson2d-1000 of ``chol`` (the f64 factors) at K = 1 and 8,
    against scipy, in one batch, K = 1 the single-device plan's bits, each
    timed beside the single-device plan; in (b) on chol-nd-poisson2d-120 in
    f32 and f64, K = 1 and 4, lower and upper (its transpose), each against
    scipy, the same bits on every rank. Returns the launches of (a)'s
    windows, summed by kernel."""
    import tempfile

    import torch
    import torch.distributed as dist

    from sblas_torch import parallel as par
    from sblas_torch import solvers
    from sblas_torch.bench_lib import (COUNTERS, EPS, bench_dist_spmv,
                                       dist_seconds)
    from sblas_torch.ops.spmm import SpmmPlan
    from sblas_torch.ops.spmv import SpmvPlan
    from sblas_torch.ops.sptrsv import get_plan as get_sptrsv_plan
    from sblas_torch.parallel.launch import save_matrix, spawn
    from sblas_torch.utils.timing import measure_seconds_per_iter

    t0 = time.perf_counter()
    meshes = {"1d": par.make_mesh(), "2d": par.make_mesh2d(),
              "hier": par.make_mesh_hier()}
    mesh = meshes["1d"]
    if (mesh.size, mesh.backend) != (1, "nccl"):
        raise RuntimeError(f"dist: a world of one over nccl expected, got "
                           f"{mesh.size} over {mesh.backend}")
    launches = dict.fromkeys(COUNTERS, 0)

    def add(rec):
        for k, v in rec["launches"].items():
            launches[k] += v
        return rec

    res, timing, single_us, inputs = {}, {}, {}, {}
    for name, case, k, make in _dist_cases(mats, meshes, 1):
        label = f"{name} {case}"
        plan, res[label] = _dist_run(name, case, k, make, mats, inputs)
        if plan is None:
            raise RuntimeError(f"{label}: refused at one rank: "
                               f"{res[label]['refused']}")
        add(res[label])
        a = mats[name]
        method = plan.local_method
        xd = torch.from_numpy(inputs[name, k][0]).to(mesh.device)
        per, timer = dist_seconds(
            mesh, lambda c, x0: plan(c, EPS, 1.0, x0), xd, xd)
        key = (name, method, k)
        if key not in single_us:    # one single-device plan a route and K
            single = SpmvPlan(a, method, device=mesh.device) \
                if k is None else SpmmPlan(a, method, k_hint=k,
                                           device=mesh.device)
            single_us[key] = 1e6 * measure_seconds_per_iter(
                lambda c, x0: single(c, EPS, 1.0, x0), xd, xd)
            del single
        timing[label] = {"dist_us": per * 1e6, "single_us": single_us[key],
                         "overhead_us": per * 1e6 - single_us[key],
                         "timer": timer}
        del plan, xd
    b = np.random.default_rng(3).standard_normal(poisson.shape[0])
    res["dist_cg f64 poisson2d(1000)"] = add(_dist_cg(mesh, poisson, b))
    cut = f"dist_cg f64 poisson2d(1000), {DIST_CG_CUT} its"
    res[cut] = add(_dist_cg(mesh, poisson, b, cut=True))
    # the triangular solves at full width: chol-nd-poisson2d-1000 in f64,
    # one batch; K = 1 must be the single-device plan's bits
    big = chol["chol-nd-poisson2d-1000"]
    single = get_sptrsv_plan(big)      # the main path's cached plan
    for k in (None, 8):
        plan, bk, x, rec = _dist_solve(mesh, big, k)
        label = f"chol-nd-poisson2d-1000 f64 {plan.__class__.__name__} " \
            f"K={k or 1}"
        res[label] = add(rec)
        if plan.nbatches != 1:
            raise RuntimeError(f"{label}: {plan.nbatches} batches at one "
                               "rank")
        bd = torch.from_numpy(bk).to(mesh.device)
        if k is None and not torch.equal(x, single.solve(bd)):
            raise RuntimeError(f"{label}: not the single-device plan's bits")
        per, timer = dist_seconds(
            mesh, lambda c, b0: plan(b0 + EPS * c), bd, bd, iters=5)
        one = measure_seconds_per_iter(
            lambda c, b0: single.solve(b0 + EPS * c), bd, bd, iters_lo=1,
            iters_hi=5)
        timing[label] = {"dist_us": per * 1e6, "single_us": one * 1e6,
                         "overhead_us": (per - one) * 1e6, "timer": timer,
                         "build_s": rec["build_s"]}
        res[label]["same_bits_as_single"] = k is None
        del plan, x, bd
    del single
    emit_fn({"phase": "launches", "path": "dist", **launches})

    # outside the launch windows: where a call's time goes on the graph, at
    # K = 1 and 8: the x gather (padding, all_gather), the local plan, the
    # y gather (padding, all_gather, unpadding), each graph-timed alone
    from sblas_torch.parallel.spmv_dist import pad_rows, unpad
    uk = mats["uk-2002@0.05"]
    for k in (None, 8):
        plan = par.DistSpmvPlan(uk, mesh) if k is None else \
            par.DistSpmmPlan(uk, mesh)
        xd = torch.from_numpy(inputs["uk-2002@0.05", k][0]).to(mesh.device)
        xl = plan.local_x(xd)
        y0 = torch.zeros_like(plan._local(xl))
        steps = {"gather_x": (lambda c: plan.local_x(c), xd),
                 "local": (lambda c: plan._local(xl, EPS, 1.0, c), y0),
                 "gather_y": (lambda c: unpad(plan._gather(pad_rows(
                     c, plan.rows_pad)), plan._segs), y0)}
        timing[f"uk-2002@0.05 DistSp{'mv' if k is None else 'mm'}Plan "
               f"K={k or 1} breakdown"] = {
            name: 1e6 * measure_seconds_per_iter(step, c0)
            for name, (step, c0) in steps.items()}
        del plan, xd, xl, y0
    # the CLI's record (bench_lib.bench_dist_spmv), here on the world of one
    for st in ("nnz_balanced", "nnz_split"):
        rec = bench_dist_spmv(mats["cant"], mesh, strategy=st).as_dict()
        if not rec["rel_err"] < DIST_TOL:
            raise RuntimeError(f"bench_dist_spmv cant {st}: {rec}")
        timing[f"cant bench_dist_spmv {st}"] = {
            key: rec[key] for key in ("us", "local_us", "collective_us",
                                      "collective_bytes", "timer",
                                      "local_method", "rel_err")}
    _, one = solvers.cg(poisson, b, tol=1e-8, maxiter=20000,
                        M=solvers.jacobi(poisson))
    res["dist_cg f64 poisson2d(1000)"]["solvers_cg_iterations"] = \
        one["iterations"]
    emit_fn({"phase": "dist", "part": "world of one", "card": card,
             "backend": mesh.backend, "transport": mesh.transport,
             "backend_reason": mesh.backend_reason, "checks": res,
             "timing": timing, "seconds": time.perf_counter() - t0})
    dist.destroy_process_group()

    t1 = time.perf_counter()
    srcs = {"cant": mats["cant"], "uk-2002@0.05": mats["uk-2002@0.05"],
            "poisson": poisson, "chol120": chol["chol-nd-poisson2d-120"]}
    arrays = {}
    for name in DIST_RANK_MATS:
        save_matrix(arrays, name, srcs[name])
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/dist_mats.npz"
        np.savez(path, **arrays)
        ranks = spawn(4, _dist_rank, path, device="cuda")
    for r, got in enumerate(ranks):
        if got["transport"] != "gloo-host" or got["ranks_per_card"] != 4:
            raise RuntimeError(f"dist rank {r}: {got['transport']}, "
                               f"{got['ranks_per_card']} ranks a card")
        for label, rec in got["cases"].items():
            if rec.get("sha256") != ranks[0]["cases"][label].get("sha256"):
                raise RuntimeError(f"{label}: rank {r}'s bits differ")
    if ranks[0]["cases"][cut]["sha256"] != res[cut]["sha256"]:
        raise RuntimeError(f"{cut}: 4 ranks' iterate differs from one "
                           "rank's")
    for label, rec in ranks[0]["cases"].items():
        if rec.get("nbatches", 2) < 2:
            raise RuntimeError(f"{label}: one batch at 4 ranks")
    emit_fn({"phase": "dist", "part": "4 ranks share the card",
             "correctness_only": True, "ranks_per_card": 4,
             "transport": "gloo-host", "checks": ranks[0]["cases"],
             **{f"{key}_by_rank": {label: [g["cases"][label].get(key)
                                           for g in ranks]
                                   for label in ranks[0]["cases"]}
                for key in ("step_routes", "launches")},
             "seconds": time.perf_counter() - t1})
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run",
              file=sys.stderr)
        return 1

    import sblas_torch
    from sblas_torch import datasets
    from sblas_torch import solvers
    from sblas_torch import cli
    from sblas_torch.bench_lib import (COUNTERS, EPS, SOLVE_TOL,
                                       bench_solver, bench_spmm, bench_spmv,
                                       bench_sptrsm, bench_sptrsv)
    from sblas_torch.benchmarks import run_suite
    from sblas_torch.examples import cg as ex_cg
    from sblas_torch.examples import convection_ilu as ex_ilu
    from sblas_torch.examples import pagerank as ex_pr
    from sblas_torch.golden import (KERNEL_TOL, KERNEL_TOL_F64, rel_err,
                                    spmm_golden, spmv_golden, sptrsm_golden,
                                    sptrsv_golden, value_tol)
    from sblas_torch.ops.common import as_csr, relabeled
    from sblas_torch.ops.kernels import _build
    from sblas_torch.ops.kernels import spmm_bsr as bkern
    from sblas_torch.ops.kernels import spmm_csr as ckern
    from sblas_torch.ops.kernels import sptrsv_csr as skern
    from sblas_torch.ops.kernels import spmv_csr as kern
    from sblas_torch.ops.spmm import SpmmPlan
    from sblas_torch.ops.spmm import _get_plan as spmm_plan
    from sblas_torch.native import BUILD_DIR
    from sblas_torch.ops.spmv import _get_plan, csr_stream_bytes
    from sblas_torch.ops.sptrsv import get_plan as sptrsv_plan
    from sblas_torch.retile_bsr import pack_bsr
    from sblas_torch.utils.backend import probe
    from sblas_torch.utils.timing import (HBM_BYTES_PER_S,
                                          measure_seconds_per_iter,
                                          peak_flops, stream_bandwidth)

    # the plain versions' products (torch.bmm) in full f32, stated
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    f32_tol = value_tol(torch.float32)
    # f64 SpMV and SpMM against scipy: the JAX package's ds class
    f64_tol = 1e-13
    t_start = time.perf_counter()
    # each kernel build's launch count: (wrapper module, counter)
    kernels = dict(COUNTERS)

    def launched(kname):
        mod, attr = kernels[kname]
        return getattr(mod, attr)

    def vec(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def vec64(*shape):
        return rng.standard_normal(shape)

    def on_card(arr):
        return torch.from_numpy(arr).to(dev)

    # 1. probe ----------------------------------------------------------
    info = probe()
    emit({"phase": "probe", **info})
    if not info["nvidia_smi"]:
        raise RuntimeError("nvidia-smi gave no name, power.limit")
    card = info["nvidia_smi"].splitlines()[0]

    # 2. build, and meanwhile generate the matrices: nvcc runs in processes
    # of its own and the generators in threads (numpy releases the GIL on
    # its large arrays), so the host's cores share the wait. The matrices:
    # the FEM suite; the 1M-row, 112M-nnz FEM band; the web graphs of
    # BASELINE.json config 5 at the scales benchmarks/run_suite.py runs
    # them; the triangular factors of config 3 as it builds them, and the
    # nested-dissection Cholesky factor scaled up to 1M rows and 50M
    # nonzeros. Both factor generators compute in f64 and cast at the end,
    # so the f32 factors are the f64 ones cast: the same bits as generating
    # them in f32. A job's seconds are its own, run beside the others ----
    def timed(fn, *args, **kw):
        t0 = time.perf_counter()
        return fn(*args, **kw), time.perf_counter() - t0

    def chol_nd(grid):
        return datasets.cholesky_factor(datasets.poisson2d_nd(
            grid, dtype=np.float64), dtype=np.float64)

    t0 = time.perf_counter()
    graph_scales = {"uk-2002@0.05": 0.05, "twitter7@0.02": 0.02}
    with ThreadPoolExecutor(max_workers=4) as pool:
        jobs = {"build": pool.submit(timed, _build.build),
                "fem": pool.submit(timed, datasets.random_csr, 1_000_000,
                                   1_000_000, 112, bandwidth=1500, seed=7,
                                   dtype=np.float32)}
        for name in ("twitter7@0.02", "uk-2002@0.05"):
            jobs[name] = pool.submit(timed, datasets.emulate,
                                     name.split("@")[0],
                                     scale=graph_scales[name],
                                     dtype=np.float32)
        for grid in (1000, 120, 60):
            jobs[f"chol-nd-poisson2d-{grid}"] = pool.submit(timed, chol_nd,
                                                            grid)
        jobs["band-parallel"] = pool.submit(
            timed, datasets.lower_triangular, 62451, 30, bandwidth=4000,
            seed=1, dtype=np.float64)
        for name in ("cant", "consph", "pdb1HYS"):
            jobs[name] = pool.submit(timed, datasets.emulate, name,
                                     dtype=np.float32)
        # a job that raised raises here
        done = {name: job.result() for name, job in jobs.items()}
    lib, build_s = done.pop("build")
    _build.load()
    log = lib.with_suffix(".log")
    emit({"phase": "build", "seconds": build_s,
          "with_generation_s": time.perf_counter() - t0,
          "library": lib.name,
          "ptxas": _build.ptxas_report(log.read_text() if log.exists()
                                       else "")})

    # 3. the csr kernel vs its plain version on the card ----------------
    fem_suite = {name: done[name][0] for name in ("cant", "consph",
                                                  "pdb1HYS")}
    cant = fem_suite["cant"]
    suite_gen_s = sum(done[name][1] for name in fem_suite)
    fem, fem_gen_s = done["fem"]
    graphs = {name: done[name][0] for name in graph_scales}
    graph_gen_s = {name: done[name][1] for name in graph_scales}
    factor_names = ("band-parallel", "chol-nd-poisson2d-60",
                    "chol-nd-poisson2d-120", "chol-nd-poisson2d-1000")
    factors64 = {name: done[name][0] for name in factor_names}
    factor_gen_s = {name: done[name][1] for name in factor_names}
    del done, jobs
    factors = {name: l.astype(np.float32) for name, l in factors64.items()}
    # the f64 matrices of the f64 paths: the f32 ones cast (exact)
    cant64, fem64 = cant.astype(np.float64), fem.astype(np.float64)
    empty = sblas_torch.CSR((5, 7), np.zeros(6, np.int32),
                            np.zeros(0, np.int32), np.zeros(0, np.float32))
    cases = {
        "banded(300,5)": datasets.banded(300, 5),
        "random_csr(100,90,2)": datasets.random_csr(100, 90, 2, seed=4),
        "random_csr(400,400,12,skew=1.2)": datasets.random_csr(
            400, 400, 12, skew=1.2, seed=3),
        "nnz=0 (5x7)": empty,
        "cant": cant,
        "fem-band-1M-112M": fem,
    }
    max_abs = {name: 0.0 for name in kernels}

    def check_plain(kernel, label, got, want, tol=KERNEL_TOL):
        torch.cuda.synchronize()
        g, w = got.cpu().numpy(), want.cpu().numpy()
        if g.shape != w.shape or not np.isfinite(g).all():
            raise RuntimeError(f"{label}: bad kernel output")
        err = rel_err(g, w)
        max_abs[kernel] = max(max_abs[kernel],
                              float(np.max(np.abs(g - w), initial=0.0)))
        if not err <= tol:
            raise RuntimeError(f"{label}: kernel vs plain rel_err {err} > "
                               f"{tol}")
        return err

    def against_plain(label, op, x, alpha, beta, yy):
        f64 = op["data"].dtype == torch.float64
        return check_plain("spmv_csr_f64" if f64 else "spmv_csr", label,
                           kern.spmv_csr(op, x, alpha, beta, yy),
                           kern.spmv_csr_reference(op, x, alpha, beta, yy),
                           KERNEL_TOL_F64 if f64 else KERNEL_TOL)

    for name, a in cases.items():
        x = on_card(vec(a.shape[1]))
        y = on_card(vec(a.shape[0]))
        errs = {}
        for vd in (torch.float32, torch.bfloat16):
            op = kern.prepare(sblas_torch.to_device(a, dev, vd))
            for alpha, beta, yy in ((2.5, -0.5, y), (1.0, 0.0, None)):
                label = f"{str(vd)[6:]},alpha={alpha}"
                errs[label] = against_plain(f"{name} {label}", op, x, alpha,
                                            beta, yy)
            del op
        # the f64 build: f64 values, x, y, alpha = 1/3 and beta
        a64 = {"cant": cant64, "fem-band-1M-112M": fem64}.get(name)
        op = kern.prepare(sblas_torch.to_device(
            a.astype(np.float64) if a64 is None else a64, dev))
        x64, y64 = on_card(vec64(a.shape[1])), on_card(vec64(a.shape[0]))
        for alpha, beta, yy in ((1 / 3, -0.5, y64), (1.0, 0.0, None)):
            label = f"float64,alpha={alpha:.4f}"
            errs[label] = against_plain(f"{name} {label}", op, x64, alpha,
                                        beta, yy)
        del op, x64, y64
        emit({"phase": "kernel_vs_plain", "kernel": "spmv_csr",
              "matrix": name, "nnz": a.nnz, "tol": KERNEL_TOL,
              "tol_f64": KERNEL_TOL_F64, "rel_err": errs})

    # 4. the block kernel vs its plain version on the card --------------
    def drop_rows(a, *spans):
        coo = a.tocoo()
        keep = np.ones(a.nnz, bool)
        for lo, hi in spans:
            keep &= (coo.row < lo) | (coo.row >= hi)
        return sblas_torch.COO(a.shape, coo.row[keep], coo.col[keep],
                               coo.data[keep]).tocsr()

    block_cases = {
        "banded(300,5)": datasets.banded(300, 5),
        "random_csr(300,200,6)": datasets.random_csr(300, 200, 6, seed=2),
        "empty block-rows (450x400)": drop_rows(
            datasets.random_csr(450, 400, 7, seed=6), (64, 320), (420, 450)),
        "nnz=0 (5x7)": empty,
        **fem_suite,
    }
    for name, a in block_cases.items():
        m, n = a.shape
        errs, pack_s = {}, {}
        for br in (128, 64):
            t0 = time.perf_counter()
            bsr = pack_bsr(a, br=br)
            pack_s[br] = time.perf_counter() - t0
            for vd in (torch.float32, torch.bfloat16):
                op = bkern.prepare(bkern.bsr_to_device(bsr, dev, vd))
                for k in (1, 3, 8, 32):
                    x, y = on_card(vec(n, k)), on_card(vec(m, k))
                    for alpha, beta, yy in ((2.5, -0.5, y), (1.0, 0.0, None)):
                        label = f"br={br},{str(vd)[6:]},K={k},Y={yy is not None}"
                        errs[label] = check_plain(
                            "spmm_bsr", f"{name} {label}",
                            bkern.spmm_bsr(op, x, alpha, beta, yy),
                            bkern.spmm_bsr_reference(op, x, alpha, beta, yy))
                del op
            del bsr
        emit({"phase": "spmm_kernel_vs_plain", "matrix": name, "nnz": a.nnz,
              "pack_bsr_s": pack_s, "tol": KERNEL_TOL,
              "max_rel_err": max(errs.values()), "cases": len(errs)})

    # 4b. the nnz-balanced kernel vs its plain version on the card ------
    long_rows = sblas_torch.COO(
        (400, 30000),
        np.concatenate([np.zeros(21000), np.full(24000, 9),
                        rng.integers(0, 300, 3000)]),
        np.concatenate([rng.permutation(30000)[:21000],
                        rng.permutation(30000)[:24000],
                        rng.integers(0, 30000, 3000)]),
        vec(48000)).tocsr()
    csr_cases = {
        "banded(300,5)": datasets.banded(300, 5),
        "random_csr(100,90,2)": datasets.random_csr(100, 90, 2, seed=4),
        "nnz=0 (5x7)": empty,
        "rows of 21000/24000 nnz, empty rows (400x30000)": long_rows,
    }
    t0 = time.perf_counter()
    for name, a in graphs.items():
        csr_cases[name] = a
        csr_cases[f"{name} hub-relabeled"] = relabeled(a)[0]
    relabel_s = time.perf_counter() - t0
    # the FEM matrices where the SpMM rule may pick the kernel: at the main
    # path's K = 8 and 32, f32 values (uniform rows, G = 8; ~107k shares on
    # the band)
    csr_cases["cant"], csr_cases["fem-band-1M-112M"] = cant, fem
    depth = {"cant": ((torch.float32,), (8, 32)),
             "fem-band-1M-112M": ((torch.float32,), (8,))}
    for name in graphs:
        depth[name] = depth[f"{name} hub-relabeled"] = (
            (torch.float32, torch.bfloat16), (1, 3, 8, 32))

    def csr_kname(op, k):
        """The counter of the kernel a launch of ``op`` with ``k`` columns
        runs: the merge SpMV at K = 1, else the rows or the columns kernel,
        each build on its own."""
        f64 = op["data"].dtype == torch.float64
        if k == 1:
            return "spmm_csr_f64" if f64 else "spmm_csr"
        if ckern.rows_kernel(op, k):
            return "spmm_csr_rows"
        return "spmm_csr_cols_f64" if f64 else "spmm_csr_cols"

    for name, a in csr_cases.items():
        m, n = a.shape
        errs = {}
        # the small cases at every K the kernels take, in both of the K > 1
        # kernels (the rule's pick and the other)
        vds, ks = depth.get(name, ((torch.float32, torch.bfloat16),
                                   (1, 2, 3, 8, 16, 32, 33, 64)))
        for vd in vds:
            op = ckern.prepare(sblas_torch.to_device(a, dev, vd))
            designs = ("rows", "cols") if name not in depth else (None,)
            for k in ks:
                x, y = on_card(vec(n, k)), on_card(vec(m, k))
                for design in designs:
                    o = op if design is None or k == 1 else {
                        **op, "design": design}
                    for alpha, beta, yy in ((2.5, -0.5, y), (1.0, 0.0, None)):
                        label = (f"{str(vd)[6:]},K={k},Y={yy is not None}"
                                 + (f",{design}" if design else ""))
                        errs[label] = check_plain(
                            csr_kname(o, k), f"{name} {label}",
                            ckern.spmm_csr(o, x, alpha, beta, yy),
                            ckern.spmm_csr_reference(o, x, alpha, beta, yy))
                del x, y
            shares, fixups = op["part"].shape[0] - 1, op["fix"].numel()
            del op
        emit({"phase": "spmm_csr_vs_plain", "matrix": name, "shape": a.shape,
              "nnz": a.nnz, "longest_row": int(a.row_lengths.max(initial=0)),
              "shares": shares, "fixups": fixups, "tol": KERNEL_TOL,
              "max_rel_err": max(errs.values()), "cases": len(errs)})

    # the nnz-balanced kernel's f64 build vs its plain version on both
    # graphs (the f64 values are the f32 ones cast), K = 1 and 8, alpha =
    # 1/3
    for name, a in graphs.items():
        m, n = a.shape
        errs = {}
        op = ckern.prepare(sblas_torch.to_device(a.astype(np.float64), dev))
        for k in (1, 8):
            x, y = on_card(vec64(n, k)), on_card(vec64(m, k))
            for alpha, beta, yy in ((1 / 3, -0.5, y), (1.0, 0.0, None)):
                label = f"float64,K={k},Y={yy is not None}"
                errs[label] = check_plain(
                    csr_kname(op, k), f"{name} {label}",
                    ckern.spmm_csr(op, x, alpha, beta, yy),
                    ckern.spmm_csr_reference(op, x, alpha, beta, yy),
                    KERNEL_TOL_F64)
            del x, y
        del op
        emit({"phase": "spmm_csr_vs_plain", "matrix": name,
              "dtype": "float64", "nnz": a.nnz, "tol": KERNEL_TOL_F64,
              "max_rel_err": max(errs.values()), "cases": len(errs)})

    # 4c. the sync-free solve kernel vs its plain version on the card, on
    # each factor, lower (L) and upper (L^T, the backsolve), K = 1 and 8,
    # in f32 and (its f64 build) f64; and the same bits on 20 repeats ----
    for name, l in factors.items():
        errs, nlevels, t0 = {}, {}, time.perf_counter()
        for fl, kname, tol, mk in (
                (l, "sptrsv_csr", KERNEL_TOL, vec),
                (factors64[name], "sptrsv_csr_f64", KERNEL_TOL_F64, vec64)):
            for side, a, lower in (("L", fl, True),
                                   ("L^T", as_csr(fl, True), False)):
                op = sptrsv_plan(a, lower=lower)._op
                for k in (1, 8):
                    b = on_card(mk(a.shape[0], k))
                    got = skern.sptrsv_csr(op, b)
                    label = f"{side},K={k},{str(b.dtype)[6:]}"
                    errs[label] = check_plain(
                        kname, f"{name} {label}", got,
                        skern.sptrsv_csr_reference(op, b), tol)
                    # the tickets (levels, small ones grouped) against
                    # plain level order and the earlier row order: the
                    # same bits, and the same bits 20 times
                    level = {**op, "perm": on_card(skern.ticket_order(
                        op["levels"], lower, 0))}
                    for o in (skern.row_order(op), level):
                        if not torch.equal(skern.sptrsv_csr(o, b), got):
                            raise RuntimeError(f"{name} {label}: ticket "
                                               "order differs from row "
                                               "or level order")
                    for _ in range(20):
                        if not torch.equal(skern.sptrsv_csr(op, b), got):
                            raise RuntimeError(
                                f"{name} {label}: the solve changed "
                                "from run to run")
                nlevels[side] = op["nlevels"]
                del op, b, got
        emit({"phase": "sptrsv_kernel_vs_plain", "matrix": name,
              "n": l.shape[0], "nnz": l.nnz, "nlevels": nlevels,
              "longest_row": int(l.row_lengths.max(initial=0)),
              "tol": KERNEL_TOL, "tol_f64": KERNEL_TOL_F64, "rel_err": errs,
              "repeats_bit_equal": 20, "row_order_bit_equal": True,
              "level_order_bit_equal": True,
              "seconds": time.perf_counter() - t0})

    # 4d. the nnz-balanced kernel at every share size it takes (merged-path
    # items; the suite's ``sweeps`` stage times each) on both graphs at
    # K = 1, 8 (the rows kernel) and 32 (the columns kernel) and on
    # banded(300,5) at K = 1, against its plain version; the solve kernel
    # with small levels grouped up to 512 .. 4,096 rows, the same bits as
    # with the rule's GROUP_ROWS ------------------------------------------
    t0 = time.perf_counter()
    unit_errs = {}
    for name, a, ks, units in (
            *((name, a, (1, 8, 32), (256, 384, 512, 1024, 2048))
              for name, a in graphs.items()),
            ("banded(300,5)", datasets.banded(300, 5), (1,),
             (256, 512, 1024, 2048))):
        t = sblas_torch.to_device(a, dev)
        for k in ks:
            x0 = on_card(vec(a.shape[1], k))
            for unit in units:
                op = ckern.prepare(t, unit)
                label = f"{name} unit={unit} K={k}"
                unit_errs[label] = check_plain(
                    csr_kname(op, k), label, ckern.spmm_csr(op, x0, 2.5),
                    ckern.spmm_csr_reference(op, x0, 2.5))
                del op
            del x0
        del t
    group_bits = {}
    for name, k in (("band-parallel", 1), ("band-parallel", 8),
                    ("chol-nd-poisson2d-120", 1),
                    ("chol-nd-poisson2d-1000", 1)):
        op = sptrsv_plan(factors[name])._op
        b0 = on_card(vec(op["shape"][0], k))
        got = skern.sptrsv_csr(op, b0)
        for g in (512, 1024, 2048, 4096):
            o = {**op, "perm": on_card(skern.ticket_order(
                op["levels"], True, g))}
            if not torch.equal(skern.sptrsv_csr(o, b0), got):
                raise RuntimeError(f"{name} K={k} group {g}: other bits")
        group_bits[f"{name} K={k}"] = [512, 1024, 2048, 4096]
        del op, o, b0, got
    emit({"phase": "share_and_group_sizes", "tol": KERNEL_TOL,
          "unit_rel_err": unit_errs, "group_bit_equal": group_bits,
          "rule_unit": ckern.UNIT, "rule_unit_cols": ckern.UNIT_COLS,
          "rule_unit_spmv": ckern.UNIT_SPMV,
          "rule_group_rows": skern.GROUP_ROWS,
          "seconds": time.perf_counter() - t0})

    # 5. the main paths, through the user's entry points: the route is the
    # rule's pick, and each call must launch that route's kernel ---------
    by_route = {"csr": "spmv_csr", "rcm": "spmv_csr", "merge": "spmm_csr",
                "pseg": "spmm_csr", "block": "spmm_bsr",
                "syncfree": "sptrsv_csr"}

    def route_kernel(plan, k):
        """The counter of the kernel build ``plan``'s route launches for an
        output of ``k`` columns (the SpMV passes launch at K = 1)."""
        route = plan._spmv.method if plan.method == "spmv_passes" \
            else plan.method
        if route in ("merge", "pseg"):
            vt = torch.float64 if plan.dtype == torch.float64 \
                else torch.float32
            return csr_kname({"data": torch.empty(0, dtype=vt)},
                             1 if plan.method == "spmv_passes" else k)
        kname = by_route[route]
        return kname + "_f64" if plan.dtype == torch.float64 else kname

    def check(res, name, label, call, plan_of, ref, tol):
        before = {k: launched(k) for k in kernels}
        out = call()
        torch.cuda.synchronize()
        plan = plan_of()
        kname = route_kernel(plan, out.shape[1] if out.dim() == 2 else 1)
        if launched(kname) == before[kname]:
            raise RuntimeError(f"{name} {label}: route {plan.method!r} "
                               f"({plan.route_reason}) launched no {kname}")
        got = out.cpu().numpy()
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise RuntimeError(f"{name} {label}: bad output")
        err = rel_err(got, ref)
        if not err < tol:
            raise RuntimeError(f"{name} {label}: rel_err vs scipy {err} "
                               f">= {tol}")
        res[label] = {"rel_err": err, "tol": tol, "method": plan.method,
                      "kernel": kname, "route_reason": plan.route_reason}

    def spmv_main_path(name, a):
        m, n = a.shape
        x, y0, xt = vec(n), vec(m), vec(m)
        at = as_csr(a, True)    # the host transpose spmv builds and caches
        bf16 = {"value_dtype": torch.bfloat16}
        res = {}
        ref = spmv_golden(a, x)     # one golden per input
        check(res, name, "f32", lambda: sblas_torch.spmv(a, x),
              lambda: _get_plan(a, "auto"), ref, f32_tol)
        check(res, name, "f32 alpha/beta",
              lambda: sblas_torch.spmv(a, x, 2.5, -0.5, y0, method="auto"),
              lambda: _get_plan(a, "auto"),
              spmv_golden(a, x, 2.5, -0.5, y0), f32_tol)
        check(res, name, "bf16 values",
              lambda: sblas_torch.spmv(a, x, method="auto", **bf16),
              lambda: _get_plan(a, "auto", **bf16), ref,
              value_tol(torch.bfloat16))
        check(res, name, "f32 trans",
              lambda: sblas_torch.spmv(a, xt, trans=True, method="auto"),
              lambda: _get_plan(at, "auto"), spmv_golden(at, xt), f32_tol)
        return res

    def spmm_main_path(name, a, k, extra_checks, method="auto"):
        m, n = a.shape
        x, y0 = vec(n, k), vec(m, k)
        kw = {"method": method, "k_hint": k}
        bf16 = {**kw, "value_dtype": torch.bfloat16}
        res = {}
        ref = spmm_golden(a, x, 2.5, -0.5, y0)     # one golden per input
        t0 = time.perf_counter()
        check(res, name, "f32 alpha/beta",
              lambda: sblas_torch.spmm(a, x, 2.5, -0.5, y0, **kw),
              lambda: spmm_plan(a, method, k_hint=k), ref, f32_tol)
        first_s = time.perf_counter() - t0
        if "bf16" in extra_checks:
            check(res, name, "bf16 values alpha/beta",
                  lambda: sblas_torch.spmm(a, x, 2.5, -0.5, y0, **bf16),
                  lambda: spmm_plan(a, method, k_hint=k,
                                    value_dtype=torch.bfloat16),
                  ref, value_tol(torch.bfloat16))
        if "trans" in extra_checks:
            xt = vec(m, k)
            at = as_csr(a, True)
            check(res, name, "f32 trans",
                  lambda: sblas_torch.spmm(a, xt, trans=True, **kw),
                  lambda: spmm_plan(at, method, k_hint=k),
                  spmm_golden(at, xt), f32_tol)
        emit({"phase": "main_path", "path": "spmm", "matrix": name, "k": k,
              "method": method, "nnz": a.nnz, "first_call_s": first_s,
              "checks": res})

    def reset():
        for mod, attr in kernels.values():
            setattr(mod, attr, 0)

    def counts():
        torch.cuda.synchronize()
        return {name: launched(name) for name in kernels}

    # a band matrix with scrambled numbering: what rcm is for
    base = datasets.random_csr(100_000, 100_000, 40, bandwidth=60, seed=21,
                               dtype=np.float32)
    perm = np.random.default_rng(22).permutation(100_000)
    scrambled = sblas_torch.CSR.from_scipy(
        base.to_scipy().tocsr()[perm][:, perm])
    spmv_mats = {"cant": cant, "fem-band-1M-112M": fem, **graphs}

    reset()
    for name, a in spmv_mats.items():
        t0 = time.perf_counter()
        res = spmv_main_path(name, a)
        emit({"phase": "main_path", "path": "spmv", "matrix": name,
              "shape": a.shape, "nnz": a.nnz,
              "longest_row": int(a.row_lengths.max(initial=0)),
              "seconds": time.perf_counter() - t0, "checks": res})
    res = {}
    xs = vec(100_000)
    check(res, "scrambled band", "rcm f32",
          lambda: sblas_torch.spmv(scrambled, xs, method="rcm"),
          lambda: _get_plan(scrambled, "rcm"), spmv_golden(scrambled, xs),
          f32_tol)
    emit({"phase": "main_path", "path": "spmv",
          "matrix": "random_csr(100000,100000,40,bandwidth=60) scrambled",
          "nnz": scrambled.nnz, "checks": res})
    spmv_launches = counts()
    emit({"phase": "launches", "path": "spmv", **spmv_launches})
    for kname in ("spmv_csr", "spmm_csr"):
        if spmv_launches[kname] == 0:
            raise RuntimeError(f"the SpMV main path never launched {kname}")

    reset()
    for name, a in fem_suite.items():
        for k in (8, 32):
            spmm_main_path(name, a, k, {"bf16"} | (
                {"trans"} if name == "cant" else set()))
    spmm_main_path("fem-band-1M-112M", fem, 8, set())
    for name, a in graphs.items():
        for k in (8, 32):
            spmm_main_path(name, a, k, {"bf16"})
    spmm_launches = counts()
    emit({"phase": "launches", "path": "spmm", **spmm_launches})
    for kname in ("spmm_bsr", "spmm_csr_rows", "spmm_csr_cols"):
        if spmm_launches[kname] == 0:
            raise RuntimeError(f"the SpMM main path never launched {kname}")
    launches = {name: spmv_launches[name] + spmm_launches[name]
                for name in kernels}
    # the dense-block route by name, whichever route the rule picked above
    # (outside the main path's launch window)
    for name, a in fem_suite.items():
        spmm_main_path(name, a, 8, set(), method="block")

    # 5c. the triangular solves: sptrsv and sptrsm (auto: the sync-free
    # kernel), the Cholesky backsolve (trans), and the Jacobi sweeps. One
    # right-hand side per factor, made in f64, and one scipy golden of the
    # f64 factor per input: the f32 path solves the same b cast to f32 ----
    def check_solve(res, name, label, call, plan, ref, kname, tol):
        before = launched(kname)
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if launched(kname) == before:
            raise RuntimeError(f"{name} {label}: route {plan.method!r} "
                               f"({plan.route_reason}) launched no {kname}")
        got = out.cpu().numpy()
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise RuntimeError(f"{name} {label}: bad output")
        err = rel_err(got, ref)
        if not err < tol:
            raise RuntimeError(f"{name} {label}: rel_err vs scipy {err} "
                               f">= {tol}")
        res[label] = {"rel_err": err, "tol": tol, "method": plan.method,
                      "kernel": kname,
                      "route_reason": getattr(plan, "route_reason", None),
                      "nlevels": plan.nlevels, "seconds": seconds}

    goldens = {}
    t0 = time.perf_counter()
    for name, l in factors64.items():
        n = l.shape[0]
        b, bm = vec64(n), vec64(n, 8)
        goldens[name] = {
            "b": b, "bm": bm, "K=1": sptrsv_golden(l, b),
            "K=8": sptrsm_golden(l, bm),
            "trans K=1": sptrsv_golden(as_csr(l, True), b, lower=False)}
    solve_golden_s = time.perf_counter() - t0

    def solve_main_path(name, l, dtype):
        g = goldens[name]
        b, bm = g["b"].astype(dtype), g["bm"].astype(dtype)
        lt = as_csr(l, True)
        tol = SOLVE_TOL[np.dtype(dtype)]
        kname = "sptrsv_csr_f64" if dtype == np.float64 else "sptrsv_csr"
        res, t0 = {}, time.perf_counter()
        check_solve(res, name, "K=1", lambda: sblas_torch.sptrsv(l, b),
                    sptrsv_plan(l), g["K=1"], kname, tol)
        check_solve(res, name, "K=8", lambda: sblas_torch.sptrsm(l, bm),
                    sptrsv_plan(l), g["K=8"], kname, tol)
        check_solve(res, name, "trans K=1",
                    lambda: sblas_torch.sptrsv(l, b, trans=True),
                    sptrsv_plan(lt, lower=False), g["trans K=1"], kname, tol)
        emit({"phase": "main_path", "path": "sptrsv", "matrix": name,
              "dtype": np.dtype(dtype).name, "n": l.shape[0], "nnz": l.nnz,
              "seconds": time.perf_counter() - t0, "checks": res})

    reset()
    for name, l in factors.items():
        solve_main_path(name, l, np.float32)
    bp = factors["band-parallel"]
    b = goldens["band-parallel"]["b"].astype(np.float32)
    res = {}
    check_solve(res, "band-parallel", "jacobi K=1",
                lambda: sblas_torch.sptrsv(bp, b, method="jacobi"),
                sptrsv_plan(bp, method="jacobi"),
                goldens["band-parallel"]["K=1"],
                by_route[sptrsv_plan(bp, method="jacobi")._e.method],
                SOLVE_TOL[np.dtype(np.float32)])
    emit({"phase": "main_path", "path": "sptrsv", "matrix": "band-parallel",
          "checks": res,
          "sweeps": sptrsv_plan(bp, method="jacobi").sweeps})
    sptrsv_launches = counts()
    emit({"phase": "launches", "path": "sptrsv", **sptrsv_launches})
    if sptrsv_launches["sptrsv_csr"] == 0:
        raise RuntimeError("the solves' main path never launched sptrsv_csr")
    launches = {name: launches[name] + sptrsv_launches[name]
                for name in kernels}

    # 5d. f64 (BASELINE.json config 1): SpMV through auto and pallas_ds by
    # name, y = A x / 3 - y / 2 and trans, on cant and the FEM band; SpMM
    # (auto) on cant at K = 8; SpMV and SpMM K = 8 (auto: the nnz-balanced
    # kernel's f64 build) on uk-2002@0.05 in f64; the solves (auto) on
    # band-parallel and chol-nd-poisson2d-1000. Each call must launch the
    # f64 build of its route's kernel ------------------------------------
    def spmv64_main_path(name, a):
        m, n = a.shape
        x, y0, xt = vec64(n), vec64(m), vec64(m)
        at = as_csr(a, True)
        ref = spmv_golden(a, x, 1 / 3, -0.5, y0)     # one golden per input
        res, t0 = {}, time.perf_counter()
        check(res, name, "f64 alpha=1/3, beta=-1/2",
              lambda: sblas_torch.spmv(a, x, 1 / 3, -0.5, y0),
              lambda: _get_plan(a, "auto"), ref, f64_tol)
        check(res, name, "pallas_ds alpha=1/3, beta=-1/2",
              lambda: sblas_torch.spmv(a, x, 1 / 3, -0.5, y0,
                                       method="pallas_ds"),
              lambda: _get_plan(a, "pallas_ds"), ref, f64_tol)
        check(res, name, "f64 trans",
              lambda: sblas_torch.spmv(a, xt, trans=True),
              lambda: _get_plan(at, "auto"), spmv_golden(at, xt), f64_tol)
        emit({"phase": "main_path", "path": "spmv", "matrix": name,
              "dtype": "float64", "nnz": a.nnz,
              "seconds": time.perf_counter() - t0, "checks": res})

    reset()
    for name, a in (("cant", cant64), ("fem-band-1M-112M", fem64)):
        spmv64_main_path(name, a)
    # the graph in f64: its values are the f32 ones cast
    uk64 = graphs["uk-2002@0.05"].astype(np.float64)
    for name, a in (("cant", cant64), ("uk-2002@0.05", uk64)):
        x, y0 = vec64(a.shape[1], 8), vec64(a.shape[0], 8)
        res = {}
        if a is uk64:
            xv, yv = x[:, 0].copy(), y0[:, 0].copy()
            check(res, name, "f64 SpMV alpha=1/3, beta=-1/2",
                  lambda: sblas_torch.spmv(a, xv, 1 / 3, -0.5, yv),
                  lambda: _get_plan(a, "auto"),
                  spmv_golden(a, xv, 1 / 3, -0.5, yv), f64_tol)
        check(res, name, "f64 K=8 alpha=1/3, beta=-1/2",
              lambda: sblas_torch.spmm(a, x, 1 / 3, -0.5, y0, k_hint=8),
              lambda: spmm_plan(a, "auto", k_hint=8),
              spmm_golden(a, x, 1 / 3, -0.5, y0), f64_tol)
        emit({"phase": "main_path", "path": "spmm", "matrix": name,
              "dtype": "float64", "k": 8, "checks": res})
    for name in ("band-parallel", "chol-nd-poisson2d-1000"):
        solve_main_path(name, factors64[name], np.float64)
    f64_launches = counts()
    emit({"phase": "launches", "path": "f64", **f64_launches})
    for kname in ("spmv_csr_f64", "spmm_csr_f64", "spmm_csr_cols_f64",
                  "sptrsv_csr_f64"):
        if f64_launches[kname] == 0:
            raise RuntimeError(f"the f64 main path never launched {kname}")
    launches = {name: launches[name] + f64_launches[name]
                for name in kernels}

    # 5e. the solvers, through sblas_torch.solvers: CG + Jacobi in f64 on
    # the 1M-row Poisson grid to convergence; IC(0)-CG, ILU(0)-BiCGSTAB
    # and ILU(0)-GMRES(30) in f64 to convergence on 256 x 256 grids; CG in
    # f32 on the 1M-row grid. Each checked by its true residual (scipy,
    # f64) -----------------------------------------------------------------
    t0 = time.perf_counter()
    grid = {np.float64: datasets.poisson2d(1000, dtype=np.float64)}
    grid[np.float32] = grid[np.float64].astype(np.float32)
    small = {"poisson2d(256)": datasets.poisson2d(256, dtype=np.float64),
             "convection_diffusion(256)": datasets.convection_diffusion(
                 256, dtype=np.float64)}
    solver_gen_s = time.perf_counter() - t0

    def check_solver(res, label, solve, a, b, tol, limit, **kw):
        t0 = time.perf_counter()
        x, info = solve(a, b, tol=tol, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        xs = x.cpu().numpy().astype(np.float64)
        b64 = np.asarray(b, dtype=np.float64)
        true = float(np.linalg.norm(b64 - a.to_scipy().astype(np.float64)
                                    @ xs) / np.linalg.norm(b64))
        if xs.shape != b64.shape or not np.isfinite(xs).all():
            raise RuntimeError(f"{label}: bad solution")
        if not (info["rel_residual"] < tol and true <= limit):
            raise RuntimeError(f"{label}: {info}, true residual {true} > "
                               f"{limit}")
        res[label] = {**info, "true_rel_residual": true, "tol": tol,
                      "limit": limit, "seconds": seconds,
                      "ms_per_iter": 1e3 * seconds
                      / max(info["iterations"], 1)}

    reset()
    res = {}
    b1m = vec64(grid[np.float64].shape[0])
    check_solver(res, "cg+jacobi f64 poisson2d(1000)", solvers.cg,
                 grid[np.float64], b1m, 1e-8, 2e-8, maxiter=20000,
                 M=solvers.jacobi(grid[np.float64]))
    b256 = vec64(small["poisson2d(256)"].shape[0])
    p256, c256 = small["poisson2d(256)"], small["convection_diffusion(256)"]
    m_ic, m_ilu = solvers.ichol(p256), solvers.ilu(c256)
    check_solver(res, "ic0-cg f64 poisson2d(256)", solvers.cg, p256, b256,
                 1e-8, 2e-8, maxiter=5000, M=m_ic)
    check_solver(res, "ilu0-bicgstab f64 convection_diffusion(256)",
                 solvers.bicgstab, c256, b256, 1e-8, 2e-8, maxiter=5000,
                 M=m_ilu)
    check_solver(res, "ilu0-gmres(30) f64 convection_diffusion(256)",
                 solvers.gmres, c256, b256, 1e-8, 2e-8, maxiter=5000,
                 restart=30, M=m_ilu)
    check_solver(res, "cg f32 poisson2d(1000)", solvers.cg,
                 grid[np.float32], b1m.astype(np.float32), 1e-4, 1e-3,
                 maxiter=20000)
    emit({"phase": "main_path", "path": "solvers", "checks": res,
          "levels": {"ic0 poisson2d(256)": [m_ic.fwd.nlevels,
                                            m_ic.bwd.nlevels],
                     "ilu0 convection_diffusion(256)": [
                         m_ilu.fwd.nlevels, m_ilu.bwd.nlevels]},
          "generate_s": solver_gen_s})
    solver_launches = counts()
    emit({"phase": "launches", "path": "solvers", **solver_launches})
    for kname in ("spmv_csr", "spmv_csr_f64", "sptrsv_csr_f64"):
        if solver_launches[kname] == 0:
            raise RuntimeError(f"the solvers' main path never launched "
                               f"{kname}")
    launches = {name: launches[name] + solver_launches[name]
                for name in kernels}
    del m_ic, m_ilu

    # 5f. the port's own entry points, each window with the counts reset:
    # the CLI (sblas_torch.cli.main, in this process; every record checked
    # and the kernel build of the route its rule picked launched), the
    # examples (each main() on the card, then checked as
    # tests/test_examples.py checks the JAX package's) and the suite
    # (run_suite --quick --case cant) -----------------------------------------
    def quiet(fn, *args, **kw):
        """``fn``'s result and what it printed."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = fn(*args, **kw)
        return out, buf.getvalue()

    def route_of(method, k, f64):
        """The kernel build a route launches for ``k`` columns."""
        if method in ("merge", "pseg"):
            vt = torch.float64 if f64 else torch.float32
            return csr_kname({"data": torch.empty(0, dtype=vt)}, k)
        return by_route[method] + ("_f64" if f64 else "")

    solve_tol = SOLVE_TOL[np.dtype(np.float32)]
    cli_calls = [(["spmv", "--matrix", "cant"], f32_tol),
                 (["spmm", "--matrix", "cant", "--k", "32"], f32_tol),
                 (["sptrsv", "--matrix", "chol:poisson:120"], solve_tol),
                 (["sptrsm", "--matrix", "chol:poisson:120", "--k", "8"],
                  solve_tol),
                 (["solve", "--matrix", "poisson:256", "--dtype", "f64",
                   "--precond", "ichol", "--tol", "1e-8"], 2e-8),
                 (["stream"], None)]
    reset()
    res, t0 = {}, time.perf_counter()
    for argv, tol in cli_calls:
        label = " ".join(argv)
        before = counts()
        rc, printed = quiet(cli.main, argv)
        after = counts()
        rec = json.loads(printed.strip().splitlines()[-1])
        if rc != 0:
            raise RuntimeError(f"cli {label}: exit {rc}")
        if tol is None:
            if not rec["gbps"] > 0:
                raise RuntimeError(f"cli {label}: {rec}")
            res[label] = {"gbps": rec["gbps"]}
            continue
        f64 = rec["dtype"] == "float64"
        knames = [route_of(rec["method"], rec.get("k", 1), f64)]
        if argv[0] == "solve":
            knames.append("sptrsv_csr_f64" if f64 else "sptrsv_csr")
        else:
            for key in ("bound_us", "device"):
                if key not in rec:
                    raise RuntimeError(f"cli {label}: no {key} in {rec}")
            if "baseline_us" not in rec and "baseline_error" not in rec:
                raise RuntimeError(f"cli {label}: no baseline in {rec}")
        for kname in knames:
            if after[kname] == before[kname]:
                raise RuntimeError(f"cli {label}: route {rec['method']!r} "
                                   f"launched no {kname}")
        if not rec["rel_err"] < tol:
            raise RuntimeError(f"cli {label}: rel_err {rec['rel_err']} >= "
                               f"{tol}")
        res[label] = {key: rec.get(key) for key in (
            "method", "route_reason", "rel_err", "seconds_per_iter",
            "bound_us", "baseline_us", "iterations", "kernel_share")}
        res[label]["kernels"] = knames
    emit({"phase": "cli", "seconds": time.perf_counter() - t0,
          "tol": {" ".join(a): t for a, t in cli_calls}, "checks": res})
    cli_launches = counts()
    emit({"phase": "launches", "path": "cli", **cli_launches})
    for kname in ("spmv_csr", "spmm_bsr", "sptrsv_csr", "spmv_csr_f64",
                  "sptrsv_csr_f64"):
        if cli_launches[kname] == 0:
            raise RuntimeError(f"the CLI's path never launched {kname}")
    launches = {name: launches[name] + cli_launches[name]
                for name in kernels}

    reset()
    t0 = time.perf_counter()
    printed = {}
    for mod, argv in ((ex_cg, ["48"]), (ex_ilu, ["64"]),
                      (ex_pr, ["30000"])):
        rc, printed[mod.__name__] = quiet(mod.main, argv)
        if rc != 0:
            raise RuntimeError(f"{mod.__name__}.main: exit {rc}")
    res = {}
    a = datasets.poisson2d(24, dtype=np.float32)
    b = np.random.default_rng(1).standard_normal(a.shape[0]).astype(
        np.float32)
    _, it, r_plain = ex_cg.cg(a, b, tol=1e-5)
    xp, itp, r_ssor = ex_cg.cg(a, b, tol=1e-5,
                               m_solve=ex_cg.ssor_preconditioner(a))
    err = float(np.linalg.norm(a.to_scipy() @ xp.cpu().numpy() - b)
                / np.linalg.norm(b))
    if not (r_plain < 1e-5 and r_ssor < 1e-5 and itp < it and err < 5e-5):
        raise RuntimeError(f"cg example: {it}, {itp} iterations, residuals "
                           f"{r_plain}, {r_ssor}, true {err}")
    res["cg"] = {"iterations": it, "ssor_iterations": itp, "true_rel_err": err}
    a, b, (_, plain), (x1, pre) = ex_ilu.solve(nx=24, eps=0.02)
    err = float(np.linalg.norm(a.to_scipy() @ x1.cpu().numpy() - b)
                / np.linalg.norm(b))
    if not (pre["rel_residual"] < 1e-6
            and pre["iterations"] < plain["iterations"] / 2 and err < 1e-4):
        raise RuntimeError(f"convection_ilu example: {plain}, {pre}, {err}")
    res["convection_ilu"] = {"plain": plain, "ilu0": pre, "true_rel_err": err}
    # as the JAX package's test asks of its bucket route: converged to 1e-9
    # in under 200 iterations, and the pseg path (the merge kernel) beside
    # it; both routes sum each row in a fixed order, so the iteration
    # reaches its fixed point
    g = datasets.emulate("uk-2002", scale=0.01, dtype=np.float32)
    r, it = ex_pr.pagerank(g, method="bucket", tol=1e-9)
    rp, itp = ex_pr.pagerank(g, method="pseg", tol=1e-9)
    diff = float((rp - r).abs().max() / r.max())
    res["pagerank"] = {"bucket_iterations": it, "sum": float(r.sum()),
                       "pseg_iterations": itp, "pseg_vs_bucket": diff}
    emit({"phase": "examples", "seconds": time.perf_counter() - t0,
          "checks": res, "printed": printed})
    if not (abs(float(r.sum()) - 1.0) < 1e-3 and it < 200 and itp < 200
            and diff < 1e-5):
        raise RuntimeError(f"pagerank example: {res['pagerank']}")
    example_launches = counts()
    emit({"phase": "launches", "path": "examples", **example_launches})
    for kname in ("spmv_csr", "spmm_csr", "sptrsv_csr"):
        if example_launches[kname] == 0:
            raise RuntimeError(f"the examples never launched {kname}")
    launches = {name: launches[name] + example_launches[name]
                for name in kernels}
    del g, r, rp

    reset()
    t0 = time.perf_counter()
    suite_out = BUILD_DIR / "smoke_suite.jsonl"
    suite_out.unlink(missing_ok=True)
    rc, _ = quiet(run_suite.main, ["--quick", "--case", "cant", "--out",
                                   str(suite_out)])
    recs = [json.loads(line) for line in suite_out.read_text().splitlines()]
    benched = [r for r in recs if "seconds_per_iter" in r
               and r["name"] != "stream_triad"]
    if rc != 0 or not benched or any("error" in r for r in recs):
        raise RuntimeError(f"run_suite --quick --case cant: exit {rc}, "
                           f"{len(benched)} records")
    emit({"phase": "suite", "seconds": time.perf_counter() - t0,
          "records": len(recs), "out": str(suite_out),
          "us": {f"{r['stage']} {r['name']} {r['method']}"
                 + (f" br={r['block_rows']}" if "block_rows" in r else ""):
                 r["seconds_per_iter"] * 1e6 for r in benched}})
    suite_launches = counts()
    emit({"phase": "launches", "path": "suite", **suite_launches})
    for kname in ("spmv_csr", "spmm_bsr"):
        if suite_launches[kname] == 0:
            raise RuntimeError(f"the suite never launched {kname}")
    launches = {name: launches[name] + suite_launches[name]
                for name in kernels}

    # 5g. the distributed plans (sblas_torch.parallel): a world of one
    # rank over NCCL here at full size, then 4 ranks sharing the card over
    # gloo (correctness only); see dist_phase -------------------------------
    dist_launches = dist_phase(
        {"cant": cant, "uk-2002@0.05": graphs["uk-2002@0.05"],
         "fem-band-1M-112M": fem}, grid[np.float64], factors64, card, emit)
    for kname in ("spmv_csr", "spmm_csr", "spmm_csr_rows", "spmm_csr_cols",
                  "spmm_bsr", "spmv_csr_f64", "sptrsv_csr_f64"):
        if dist_launches[kname] == 0:
            raise RuntimeError(f"the dist path never launched {kname}")
    launches = {name: launches[name] + dist_launches[name]
                for name in kernels}

    # the csr SpMV route by name on the graphs' rows of 10^5+ nonzeros, with
    # this run's random x (outside the launch windows)
    for name, a in graphs.items():
        x = vec(a.shape[1])
        err = rel_err(sblas_torch.spmv(a, x, method="csr").cpu().numpy(),
                      spmv_golden(a, x))
        emit({"phase": "csr_long_rows", "matrix": name,
              "longest_row": int(a.row_lengths.max(initial=0)),
              "rel_err": err, "tol": f32_tol})
        if not err < f32_tol:
            raise RuntimeError(f"{name}: csr route rel_err {err} >= "
                               f"{f32_tol}")

    # 6. SpMV timing: the csr kernel, the nnz-balanced one, their plain
    # versions, cuSPARSE and the bound ------------------------------------
    def bound_us(nbytes, flops, dtype=np.float32):
        bytes_s = nbytes / HBM_BYTES_PER_S
        flops_s = flops / peak_flops(dtype)
        return max(bytes_s, flops_s) * 1e6, \
            "bytes" if bytes_s >= flops_s else "operations"

    def us(step, x0, **kw):
        return 1e6 * measure_seconds_per_iter(step, x0, x0, **kw)

    # the plain versions take tens of ms on the graphs: fewer iterations
    few = {"iters_lo": 2, "iters_hi": 6, "repeats": 1}

    def x_gather_fit(a, k, merge_us):
        """The share of the X bytes the merge route gathers (K floats a
        nonzero) that its time pays at the STREAM rate beyond its CSR
        stream, X in and Y in and out: the SpMM rule's X_GATHER."""
        m, n = a.shape
        rest = csr_stream_bytes(m, a.nnz, 4) + (n + 2 * m) * k * 4
        return (merge_us * 1e-6 * stream_bandwidth(dev) * 1e9 - rest) / \
            (a.nnz * k * 4)

    timings = {}
    for name, a in (("cant", cant), ("fem-band-1M-112M", fem)):
        rec = bench_spmv(a, method="csr", ratio_pairs=2, device=dev)
        rec16 = bench_spmv(a, method="csr", value_dtype=torch.bfloat16,
                           device=dev, baseline=False)
        merge = bench_spmv(a, method="merge", device=dev, baseline=False)
        t = sblas_torch.to_device(a, dev)
        x0 = on_card(vec(a.shape[1]))
        plain = us(lambda x, x0: kern.spmv_csr_reference(t, x, EPS, 1.0, x0),
                   x0)
        # what an eager caller of the entry point waits per call, host
        # Python included (the graph-timed numbers above leave it out)
        sblas_torch.spmv(a, x0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            sblas_torch.spmv(a, x0)
        torch.cuda.synchronize()
        eager = (time.perf_counter() - t0) / 200
        bound = max(rec.bytes / HBM_BYTES_PER_S,
                    rec.flops / peak_flops(a.dtype))
        kernel_us, merge_us = rec.seconds_per_iter * 1e6, \
            merge.seconds_per_iter * 1e6
        timings[name] = {"kernel_us": kernel_us, "plain_us": plain,
                         "bound_us": bound * 1e6,
                         "cusparse_us": rec.extra["baseline_us"]}
        emit({"phase": "timing", "kernel": "spmv_csr", "matrix": name,
              "card": card,
              "kernel_us": kernel_us, "kernel_gbps": rec.gbps,
              "pct_stream": rec.extra["pct_stream"],
              "stream_gbps": rec.extra["stream_gbps"],
              "bytes_per_iter": rec.bytes, "bound_us": bound * 1e6,
              "plain_us": plain,
              "eager_spmv_us_per_call": eager * 1e6,
              "cusparse_us": rec.extra["baseline_us"],
              "kernel_bf16_us": rec16.seconds_per_iter * 1e6,
              "kernel_bf16_gbps": rec16.gbps,
              "merge_us": merge_us,
              "rule_picked": _get_plan(a, "auto").method,
              "faster_route": "csr" if kernel_us <= merge_us else "merge",
              "rel_err": rec.extra["rel_err"],
              "ratio_pairs": rec.extra["ratio_pairs"]})
        del t, x0

    # 6a. f64: the csr kernel's f64 build (auto's route) on cant and the FEM
    # band, its plain version, cuSPARSE's f64 addmv and the bound (12 B a
    # nonzero, 8 B vectors, fp64 rate); uk-2002@0.05 in f64: the
    # nnz-balanced kernel's f64 build (auto's merge), its plain version,
    # cuSPARSE and the bound, against the csr kernel and the torch bucket
    # route, and SpMM at K = 8 (merge, spmv_passes, bucket); SpMM on cant
    # at K = 8 (auto) against the torch bsr route and cuSPARSE's addmm ---
    for name, a in (("cant", cant64), ("fem-band-1M-112M", fem64)):
        rec = bench_spmv(a, method="csr", ratio_pairs=2, device=dev)
        t = sblas_torch.to_device(a, dev)
        x0 = on_card(vec64(a.shape[1]))
        plain = us(lambda x, x0: kern.spmv_csr_reference(t, x, EPS, 1.0, x0),
                   x0)
        bound, by = bound_us(rec.bytes, rec.flops, np.float64)
        timings[name + " f64"] = {
            "kernel_us": rec.seconds_per_iter * 1e6, "plain_us": plain,
            "bound_us": bound, "bound_by": by,
            "cusparse_us": rec.extra["baseline_us"]}
        emit({"phase": "timing", "kernel": "spmv_csr_f64", "matrix": name,
              "card": card, **timings[name + " f64"],
              "kernel_gbps": rec.gbps, "pct_stream": rec.extra["pct_stream"],
              "stream_gbps": rec.extra["stream_gbps"],
              "bytes_per_iter": rec.bytes,
              "rule_picked": _get_plan(a, "auto").method,
              "route_reason": _get_plan(a, "auto").route_reason,
              "rel_err": rec.extra["rel_err"],
              "ratio_pairs": rec.extra["ratio_pairs"]})
        del t, x0
    routes = {r: bench_spmv(uk64, method=r, device=dev,
                            baseline=r == "merge")
              for r in ("merge", "csr", "bucket")}
    route_times = {r: rec.seconds_per_iter * 1e6 for r, rec in routes.items()}
    t = ckern.prepare(sblas_torch.to_device(uk64, dev))
    x0 = on_card(vec64(uk64.shape[1], 1))
    bound, by = bound_us(routes["merge"].bytes, routes["merge"].flops,
                         np.float64)
    timings["uk-2002@0.05 f64"] = {
        "kernel_us": route_times["merge"], "bound_us": bound,
        "bound_by": by, "cusparse_us": routes["merge"].extra["baseline_us"],
        "plain_us": us(lambda x, x0: ckern.spmm_csr_reference(
            t, x, EPS, 1.0, x0), x0, **few)}
    emit({"phase": "timing", "kernel": "spmm_csr_f64", "matrix":
          "uk-2002@0.05", "card": card, **timings["uk-2002@0.05 f64"],
          "route_us": route_times,
          "rule_picked": _get_plan(uk64, "auto").method,
          "route_reason": _get_plan(uk64, "auto").route_reason,
          "faster_route": min(route_times, key=route_times.get),
          "rel_err": {r: rec.extra["rel_err"] for r, rec in routes.items()}})
    del x0, routes
    routes = {r: bench_spmm(uk64, 8, method=r, device=dev,
                            baseline=r == "merge")
              for r in ("merge", "spmv_passes", "bucket")}
    route_times = {r: rec.seconds_per_iter * 1e6 for r, rec in routes.items()}
    x0 = on_card(vec64(uk64.shape[1], 8))
    timings["uk-2002@0.05 f64 K=8"] = {
        "kernel_us": route_times["merge"],
        "bound_us": routes["merge"].extra["bound_us"],
        "bound_by": routes["merge"].extra["bound_by"],
        "cusparse_us": routes["merge"].extra["baseline_us"],
        "plain_us": us(lambda x, x0: ckern.spmm_csr_reference(
            t, x, EPS, 1.0, x0), x0, **few)}
    emit({"phase": "spmm_timing", "matrix": "uk-2002@0.05",
          "dtype": "float64", "k": 8, "card": card, "route_us": route_times,
          **timings["uk-2002@0.05 f64 K=8"],
          "rule_picked": spmm_plan(uk64, "auto", k_hint=8).method,
          "faster_route": min(route_times, key=route_times.get),
          "rel_err": {r: rec.extra["rel_err"] for r, rec in routes.items()}})
    del uk64, routes, t, x0
    rec = bench_spmm(cant64, 8, method="auto", device=dev)
    others = {r: bench_spmm(cant64, 8, method=r, device=dev,
                            baseline=False).seconds_per_iter * 1e6
              for r in ("bsr", "merge", "spmv_passes")}
    emit({"phase": "spmm_timing", "matrix": "cant", "dtype": "float64",
          "k": 8, "card": card, "method": rec.extra["method"],
          "route_reason": rec.extra["route_reason"],
          "kernel_us": rec.seconds_per_iter * 1e6,
          "bound_us": rec.extra["bound_us"], "bound_by": rec.extra["bound_by"],
          "cusparse_us": rec.extra["baseline_us"], "route_us": others,
          "faster_route": min(others, key=others.get),
          "kernel_gbps": rec.gbps, "pct_stream": rec.extra["pct_stream"],
          "rel_err": rec.extra["rel_err"]})
    del rec

    # 6b. the graphs: the nnz-balanced kernel in natural order (the merge
    # route auto runs) and hub-relabeled (the pseg operand), its plain
    # version, cuSPARSE, the bound and every route, at K = 1, 8, 32 -------
    def route_us(a, k, routes):
        """Graph-timed us of each SpMM route through its plan, each first
        checked against one scipy golden of the same X."""
        x_np = vec(a.shape[1], k)
        want = spmm_golden(a, x_np)
        x0 = on_card(x_np)
        out = {}
        for r in routes:
            plan = spmm_plan(a, r, k_hint=k)
            err = rel_err(plan(x0).cpu().numpy(), want)
            if not err < f32_tol:
                raise RuntimeError(f"{r} on K={k}: rel_err {err}")
            out[r] = us(lambda x, x0, plan=plan: plan(x, EPS, 1.0, x0), x0)
        return out

    graph_timings = {}
    for name, a in graphs.items():
        m, n = a.shape
        ap = relabeled(a)[0]
        nat = ckern.prepare(sblas_torch.to_device(a, dev))
        rel = ckern.prepare(sblas_torch.to_device(ap, dev))
        sp = torch.sparse_csr_tensor(
            on_card(a.indptr), on_card(a.indices), on_card(a.data),
            size=a.shape)
        longest = int(a.row_lengths.max(initial=0))
        for k in (1, 8, 32):
            x0 = on_card(vec(n, k))
            row = {
                "kernel_us": us(lambda x, x0: ckern.spmm_csr(
                    nat, x, EPS, 1.0, x0), x0),
                "kernel_relabeled_us": us(lambda x, x0: ckern.spmm_csr(
                    rel, x, EPS, 1.0, x0), x0),
                "plain_us": us(lambda x, x0: ckern.spmm_csr_reference(
                    nat, x, EPS, 1.0, x0), x0, **few)}
            nbytes = csr_stream_bytes(m, a.nnz, 4) + (n + 2 * m) * k * 4
            row["bound_us"], row["bound_by"] = bound_us(nbytes,
                                                        2 * a.nnz * k)
            if k > 1:
                # both K > 1 kernels, and the columns kernel in
                # column-chunk-major order: one launch a half of X's
                # columns (each half contiguous), every share of the first
                # half before the second's. Each checked first
                want = ckern.spmm_csr_reference(nat, x0, 2.5)
                row["rule_kernel"] = csr_kname(nat, k)
                cols = {**nat, "design": "cols"}
                for key, o in (("rows_us", {**nat, "design": "rows"}),
                               ("cols_us", cols)):
                    check_plain(csr_kname(o, k), f"{name} K={k} {key}",
                                ckern.spmm_csr(o, x0, 2.5), want)
                    row[key] = us(lambda x, x0, o=o: ckern.spmm_csr(
                        o, x, EPS, 1.0, x0), x0)
                lo, hi = (x0[:, :k // 2].contiguous(),
                          x0[:, k // 2:].contiguous())
                check_plain("spmm_csr_cols", f"{name} K={k} chunk-major",
                            torch.cat([ckern.spmm_csr(cols, h, 2.5)
                                       for h in (lo, hi)], 1), want)
                row["cols_chunk_major_us"] = us(
                    lambda x, x0, hi=hi: (
                        ckern.spmm_csr(cols, hi, EPS, 1.0, hi),
                        ckern.spmm_csr(cols, x, EPS, 1.0, x0))[1], lo)
                del want, lo, hi
            if k == 1:
                v0 = x0.view(-1)
                row["cusparse_us"] = us(lambda x, x0: torch.addmv(
                    x0, sp, x, beta=1.0, alpha=EPS), v0)
                routes = {
                    r: bench_spmv(a, method=r, device=dev,
                                  baseline=False).seconds_per_iter * 1e6
                    for r in ("csr", "merge", "pseg")}
                # the csr kernel's time per serial step of its longest row
                # (the SpMV rule's CSR_STEP_NS)
                row["csr_walk_steps"] = longest / kern.group_size(m, a.nnz)
                row["csr_ns_per_step"] = 1e3 * routes["csr"] / \
                    row["csr_walk_steps"]
                picked = _get_plan(a, "auto").method
            else:
                row["cusparse_us"] = us(lambda x, x0: torch.addmm(
                    x0, sp, x, beta=1.0, alpha=EPS), x0)
                routes = route_us(a, k, ("merge", "spmv_passes") + (
                    ("pseg",) if k == 8 else ()))
                prices = SpmmPlan.prices(a, k)
                free = torch.cuda.mem_get_info(dev)[0]
                row["block_stream_mb"] = prices["block_stream"] / 1e6
                if prices["block_stream"] <= free // 2:
                    routes.update(route_us(a, k, ("block",)))
                picked = spmm_plan(a, "auto", k_hint=k).method
                row["x_gather_fit"] = x_gather_fit(a, k, routes["merge"])
            graph_timings[(name, k)] = row
            emit({"phase": "graph_timing", "matrix": name, "k": k,
                  "card": card, "nnz": a.nnz, "longest_row": longest, **row,
                  "route_us": routes, "rule_picked": picked,
                  "faster_route": min(routes, key=routes.get)})
            del x0
        # K = 16, the last K the rule gives the rows kernel: both K > 1
        # kernels, each checked first
        x0 = on_card(vec(n, 16))
        want = ckern.spmm_csr_reference(nat, x0, 2.5)
        row = {"rule_kernel": csr_kname(nat, 16)}
        for design in ("rows", "cols"):
            o = {**nat, "design": design}
            check_plain(csr_kname(o, 16), f"{name} K=16 {design}",
                        ckern.spmm_csr(o, x0, 2.5), want)
            row[f"{design}_us"] = us(lambda x, x0, o=o: ckern.spmm_csr(
                o, x, EPS, 1.0, x0), x0)
        emit({"phase": "k_switch", "matrix": name, "k": 16, "card": card,
              **row})
        del nat, rel, sp, x0, want

    # 7. SpMM timing on the FEM matrices: the block kernel, its plain
    # version, cuSPARSE, the bound and the other routes -----------------
    spmm_timings = {}
    fem_rows = [(name, a, k, br) for name, a in fem_suite.items()
                for k in (8, 32) for br in (128, 64)]
    for name, a, k, br in fem_rows:
        rec = bench_spmm(a, k, method="block", block_rows=br, ratio_pairs=2,
                         device=dev)
        row = {"kernel_us": rec.seconds_per_iter * 1e6,
               "bound_us": rec.extra["bound_us"],
               "bound_by": rec.extra["bound_by"],
               "cusparse_us": rec.extra["baseline_us"]}
        op = spmm_plan(a, "block", k_hint=k, block_rows=br)._op
        x0 = on_card(vec(a.shape[1], k))
        row["plain_us"] = us(lambda x, x0: bkern.spmm_bsr_reference(
            op, x, EPS, 1.0, x0), x0)
        del op, x0
        extra = {}
        if br == 128:
            rec16 = bench_spmm(a, k, method="block",
                               value_dtype=torch.bfloat16, device=dev,
                               baseline=False)
            routes = {"block": row["kernel_us"]}
            for r in ("merge", "spmv_passes"):
                routes[r] = bench_spmm(a, k, method=r, device=dev,
                                       baseline=False).seconds_per_iter * 1e6
            extra = {"kernel_bf16_us": rec16.seconds_per_iter * 1e6,
                     "kernel_bf16_gbps": rec16.gbps,
                     "bound_bf16_us": rec16.extra["bound_us"],
                     "route_us": routes,
                     "rule_picked": spmm_plan(a, "auto", k_hint=k).method,
                     "faster_route": min(routes, key=routes.get),
                     "x_gather_fit": x_gather_fit(a, k, routes["merge"])}
        spmm_timings[(name, k, br)] = row
        emit({"phase": "spmm_timing", "matrix": name, "k": k,
              "block_rows": br, "card": card, **row, **extra,
              "kernel_gflops": rec.gflops, "kernel_gbps": rec.gbps,
              "pct_stream": rec.extra["pct_stream"],
              "stream_gbps": rec.extra["stream_gbps"],
              "bytes_per_iter": rec.bytes, "rel_err": rec.extra["rel_err"],
              "ratio_pairs": rec.extra["ratio_pairs"]})
    # the FEM band at K = 8: its blocks (12.8 GB) are priced, not packed
    routes = {r: bench_spmm(fem, 8, method=r, device=dev,
                            baseline=False).seconds_per_iter * 1e6
              for r in ("merge", "spmv_passes")}
    emit({"phase": "spmm_timing", "matrix": "fem-band-1M-112M", "k": 8,
          "card": card, "route_us": routes,
          "block_stream_mb": SpmmPlan.prices(fem, 8)["block_stream"] / 1e6,
          "rule_picked": spmm_plan(fem, "auto", k_hint=8).method,
          "faster_route": min(routes, key=routes.get),
          "x_gather_fit": x_gather_fit(fem, 8, routes["merge"])})

    # 7b. the solves: the sync-free kernel through its plan (K = 1, 8 and
    # the backsolve, tickets level by level, small levels grouped), its
    # plain version, the bound, ns per level and cuSPARSE's
    # triangular_solve; the Jacobi sweeps on band-parallel. The plain level
    # and row orders are timed by the suite (``solves`` stage) ----------------
    solve_timings = {}
    # the plain version runs ~8 torch calls a level: one and two solves
    solve_few = {"iters_lo": 1, "iters_hi": 2, "repeats": 1}
    solve_rows = [(name, l, vec) for name, l in factors.items()]
    solve_rows += [(name + " f64", factors64[name], vec64)
                   for name in ("band-parallel", "chol-nd-poisson2d-1000")]
    for name, l, mk in solve_rows:
        lt = as_csr(l, True)
        # on the default device: the plans the main path built and cached
        recs = {"K=1": bench_sptrsv(l), "K=8": bench_sptrsm(l, 8),
                "trans K=1": bench_sptrsv(lt, lower=False)}
        if name == "band-parallel":
            recs["jacobi K=1"] = bench_sptrsv(l, method="jacobi",
                                              baseline=False)
        op = sptrsv_plan(l)._op
        plain_us = {k: us(lambda x, b0: skern.sptrsv_csr_reference(
            op, b0 + EPS * x), on_card(mk(l.shape[0], k)), **solve_few)
            for k in (1, 8)}
        del op
        rows = {}
        for label, rec in recs.items():
            e = rec.extra
            rows[label] = {
                "method": e["method"], "us": rec.seconds_per_iter * 1e6,
                "bound_us": e["bound_us"], "bound_by": e["bound_by"],
                "bytes": rec.bytes, "gbps": rec.gbps,
                "ns_per_level": e["ns_per_level"],
                "levels_per_s": e["levels_per_s"], "nlevels": e["nlevels"],
                "rel_err": e["rel_err"],
                "cusparse_us": e.get("baseline_us"),
                "cusparse_error": e.get("baseline_error"),
                **({"sweeps": e["sweeps"]} if "sweeps" in e else {})}
        rows["K=1"]["plain_us"], rows["K=8"]["plain_us"] = plain_us[1], \
            plain_us[8]
        solve_timings[name] = rows
        emit({"phase": "sptrsv_timing", "matrix": name, "card": card,
              "dtype": np.dtype(l.dtype).name, "n": l.shape[0],
              "nnz": l.nnz, **rows})

    # 7c. the solvers: IC(0)-CG in f64 on the 1M-row grid for 30 iterations
    # (a cut depth): ms per iteration split into the SpMV, the two
    # triangular solves and the rest, the kernels' share of the wall time,
    # and the reported residual against the true one. Then, untimed,
    # ILU(0)-BiCGSTAB and ILU(0)-GMRES(30) for 30 iterations on the 1M-row
    # convection_diffusion grid, their reported residual held to the true
    # one, and each 1M-row factor's solves held bit for bit to the same
    # kernel in row order and in plain level order. The suite's ``solvers``
    # stage times the other solvers, those orders and the factorizations
    # ------------------------------------------------------------------------
    p1m = grid[np.float64]
    m_ic = solvers.ichol(p1m)
    row = bench_solver(solvers.cg, p1m, b1m, M=m_ic, tol=0.0, maxiter=30)
    agree = abs(row["rel_residual"] - row["true_rel_residual"]) / \
        row["true_rel_residual"]
    if not agree <= 1e-6:
        raise RuntimeError(f"ic0-cg: reported residual {row['rel_residual']} "
                           f"against the true {row['true_rel_residual']}")
    row["residual_agreement"] = agree
    emit({"phase": "solver_timing", "solver": "ic0-cg", "card": card,
          "matrix": "poisson2d(1000)", **row})
    t0 = time.perf_counter()
    c1m = datasets.convection_diffusion(1000, dtype=np.float64)
    m_ilu = solvers.ilu(c1m)
    res = {}
    for label, solve, kw in (("ilu0-bicgstab", solvers.bicgstab, {}),
                             ("ilu0-gmres(30)", solvers.gmres,
                              {"restart": 30})):
        x, info = solve(c1m, b1m, tol=0.0, maxiter=30, M=m_ilu, **kw)
        xs = x.cpu().numpy()
        if xs.shape != b1m.shape or not np.isfinite(xs).all():
            raise RuntimeError(f"{label}: bad solution")
        true = float(np.linalg.norm(b1m - c1m.to_scipy() @ xs)
                     / np.linalg.norm(b1m))
        agree = abs(info["rel_residual"] - true) / true
        if not (info["iterations"] == 30 and agree <= 1e-6):
            raise RuntimeError(f"{label}: reported residual "
                               f"{info['rel_residual']} after "
                               f"{info['iterations']} iterations, true {true}")
        res[label] = {**info, "true_rel_residual": true,
                      "residual_agreement": agree}
    b0 = on_card(b1m)
    for label, m_ in (("ic0 poisson2d(1000)", m_ic),
                      ("ilu0 convection_diffusion(1000)", m_ilu)):
        for side, sp in (("fwd", m_.fwd), ("bwd", m_.bwd)):
            op = sp._op
            got = skern.sptrsv_csr(op, b0)
            level = {**op, "perm": on_card(skern.ticket_order(
                op["levels"], op["lower"], 0))}
            for order, o in (("row", skern.row_order(op)), ("level", level)):
                if not torch.equal(skern.sptrsv_csr(o, b0), got):
                    raise RuntimeError(f"{label} {side}: the ticket order "
                                       f"differs from {order} order")
            res[f"{label} {side}"] = {"nlevels": op["nlevels"],
                                      "row_order_bit_equal": True,
                                      "level_order_bit_equal": True}
    emit({"phase": "solver_checks", "checks": res,
          "seconds": time.perf_counter() - t0})
    del m_ic, m_ilu, c1m, b0, got, level, op

    # 8. lanes-per-row sweep: every width the csr kernel takes, on cant in
    # f32, bf16 and f64 and on the FEM band in f64 (an earlier f32 sweep of
    # the band found G = 8 fastest there too), each width checked against
    # the plain version before it is timed -------------------------------
    sweeps = [("cant", cant, vd) for vd in (torch.float32, torch.bfloat16)]
    sweeps += [("cant", cant64, torch.float64),
               ("fem-band-1M-112M", fem64, torch.float64)]
    for name, a, vd in sweeps:
        mk = vec64 if vd == torch.float64 else vec
        x, y = on_card(mk(a.shape[1])), on_card(mk(a.shape[0]))
        op = kern.prepare(sblas_torch.to_device(a, dev, vd))
        sweep, errs = {}, {}
        for g in kern.GROUPS:
            opg = {**op, "group": g}
            errs[g] = against_plain(f"{name} {vd} G={g}", opg, x, 2.5, -0.5,
                                    y)
            sweep[g] = us(lambda c, x0: kern.spmv_csr(opg, c, EPS, 1.0, x0),
                          x)
        emit({"phase": "group_sweep", "matrix": name, "card": card,
              "values": str(vd)[6:], "rule_group": op["group"],
              "us": sweep, "rel_err": errs})
        del op, x, y

    emit({"phase": "total", "seconds": time.perf_counter() - t_start,
          "suite_generate_s": suite_gen_s, "fem_generate_s": fem_gen_s,
          "graph_generate_s": graph_gen_s, "relabel_s": relabel_s,
          "factor_generate_s": factor_gen_s,
          "solve_golden_s": solve_golden_s,
          "solver_generate_s": solver_gen_s})
    main = spmm_timings[("consph", 8, 128)]
    tw1 = graph_timings[("twitter7@0.02", 1)]
    tw = graph_timings[("twitter7@0.02", 8)]
    uk32 = graph_timings[("uk-2002@0.05", 32)]
    big = solve_timings["chol-nd-poisson2d-1000"]["K=1"]
    big64 = solve_timings["chol-nd-poisson2d-1000 f64"]["K=1"]
    cant_f64 = timings["cant f64"]
    uk_f64 = timings["uk-2002@0.05 f64"]
    uk8_f64 = timings["uk-2002@0.05 f64 K=8"]
    emit({"kernels": [
        {"name": "spmv_csr", "route": "cuda",
         "source": "sblas_torch/csrc/spmv_csr.cu",
         "replaces": "sblas/ops/kernels/spmv_pallas.py:55",
         "launches": launches["spmv_csr"], "max_abs_err": max_abs["spmv_csr"],
         "ms": timings["cant"]["kernel_us"] / 1e3,
         "plain_ms": timings["cant"]["plain_us"] / 1e3,
         "bound_ms": timings["cant"]["bound_us"] / 1e3, "bound_by": "bytes",
         "library_ms": timings["cant"]["cusparse_us"] / 1e3,
         "shape": "cant f32"},
        {"name": "spmm_bsr", "route": "cuda",
         "source": "sblas_torch/csrc/spmm_bsr.cu",
         "replaces": ["sblas/ops/kernels/spmm_bsr_pallas.py:96",
                      "sblas/ops/kernels/spmm_bsr_pallas.py:44",
                      "sblas/ops/kernels/spmm_bsr_pallas.py:481"],
         "launches": launches["spmm_bsr"], "max_abs_err": max_abs["spmm_bsr"],
         "ms": main["kernel_us"] / 1e3, "plain_ms": main["plain_us"] / 1e3,
         "bound_ms": main["bound_us"] / 1e3, "bound_by": main["bound_by"],
         "library_ms": main["cusparse_us"] / 1e3,
         "shape": "consph f32 K=8"},
        {"name": "spmm_csr", "route": "cuda",
         "source": "sblas_torch/csrc/spmm_csr.cu",
         "replaces": "sblas/ops/kernels/spmv_pseg.py:37",
         "launches": launches["spmm_csr"], "max_abs_err": max_abs["spmm_csr"],
         "ms": tw1["kernel_us"] / 1e3, "plain_ms": tw1["plain_us"] / 1e3,
         "bound_ms": tw1["bound_us"] / 1e3, "bound_by": tw1["bound_by"],
         "library_ms": tw1["cusparse_us"] / 1e3,
         "shape": "twitter7@0.02 f32 K=1, natural order (route merge; "
                  "spmv_merge_kernel)"},
        {"name": "spmm_csr_rows", "route": "cuda",
         "source": "sblas_torch/csrc/spmm_csr.cu",
         "replaces": ["sblas/ops/kernels/spmm_pseg.py:134",
                      "sblas/ops/kernels/spmm_pseg.py:350",
                      "sblas/ops/kernels/spmm_pallas.py:30"],
         "launches": launches["spmm_csr_rows"],
         "max_abs_err": max_abs["spmm_csr_rows"],
         "ms": tw["kernel_us"] / 1e3, "plain_ms": tw["plain_us"] / 1e3,
         "bound_ms": tw["bound_us"] / 1e3, "bound_by": tw["bound_by"],
         "library_ms": tw["cusparse_us"] / 1e3,
         "shape": "twitter7@0.02 f32 K=8, natural order (route merge; "
                  "spmm_rows_kernel)"},
        {"name": "spmm_csr_cols", "route": "cuda",
         "source": "sblas_torch/csrc/spmm_csr.cu",
         "replaces": ["sblas/ops/kernels/spmm_pseg.py:134",
                      "sblas/ops/kernels/spmm_pseg.py:350",
                      "sblas/ops/kernels/spmm_pallas.py:30"],
         "launches": launches["spmm_csr_cols"],
         "max_abs_err": max_abs["spmm_csr_cols"],
         "ms": uk32["kernel_us"] / 1e3, "plain_ms": uk32["plain_us"] / 1e3,
         "bound_ms": uk32["bound_us"] / 1e3, "bound_by": uk32["bound_by"],
         "library_ms": uk32["cusparse_us"] / 1e3,
         "shape": "uk-2002@0.05 f32 K=32, natural order (route merge; "
                  "spmm_merge_kernel)"},
        {"name": "sptrsv_csr", "route": "cuda",
         "source": "sblas_torch/csrc/sptrsv_csr.cu",
         "replaces": ["sblas/ops/kernels/sptrsv_pallas.py:510",
                      "sblas/ops/kernels/sptrsv_pallas.py:1045"],
         "launches": launches["sptrsv_csr"],
         "max_abs_err": max_abs["sptrsv_csr"],
         "ms": big["us"] / 1e3, "plain_ms": big["plain_us"] / 1e3,
         "bound_ms": big["bound_us"] / 1e3, "bound_by": big["bound_by"],
         "library_ms": None if big["cusparse_us"] is None
         else big["cusparse_us"] / 1e3,
         "shape": "chol-nd-poisson2d-1000 (1M rows, 50.2M nnz) f32, K=1"},
        {"name": "spmv_csr_f64", "route": "cuda",
         "source": "sblas_torch/csrc/spmv_csr.cu",
         "replaces": "sblas/ops/kernels/spmv_wsell_ds.py:80",
         "launches": launches["spmv_csr_f64"],
         "max_abs_err": max_abs["spmv_csr_f64"],
         "ms": cant_f64["kernel_us"] / 1e3,
         "plain_ms": cant_f64["plain_us"] / 1e3,
         "bound_ms": cant_f64["bound_us"] / 1e3,
         "bound_by": cant_f64["bound_by"],
         "library_ms": cant_f64["cusparse_us"] / 1e3,
         "shape": "cant f64"},
        {"name": "spmm_csr_f64", "route": "cuda",
         "source": "sblas_torch/csrc/spmm_csr.cu",
         "replaces": "sblas/ops/kernels/spmv_pseg.py:37",
         "launches": launches["spmm_csr_f64"],
         "max_abs_err": max_abs["spmm_csr_f64"],
         "ms": uk_f64["kernel_us"] / 1e3, "plain_ms": uk_f64["plain_us"] / 1e3,
         "bound_ms": uk_f64["bound_us"] / 1e3, "bound_by": uk_f64["bound_by"],
         "library_ms": uk_f64["cusparse_us"] / 1e3,
         "shape": "uk-2002@0.05 f64, K=1 (route merge, auto's f64 pick; "
                  "spmv_merge_kernel)"},
        {"name": "spmm_csr_cols_f64", "route": "cuda",
         "source": "sblas_torch/csrc/spmm_csr.cu",
         "replaces": ["sblas/ops/kernels/spmm_pseg.py:134",
                      "sblas/ops/kernels/spmm_pseg.py:350",
                      "sblas/ops/kernels/spmm_pallas.py:30"],
         "launches": launches["spmm_csr_cols_f64"],
         "max_abs_err": max_abs["spmm_csr_cols_f64"],
         "ms": uk8_f64["kernel_us"] / 1e3,
         "plain_ms": uk8_f64["plain_us"] / 1e3,
         "bound_ms": uk8_f64["bound_us"] / 1e3,
         "bound_by": uk8_f64["bound_by"],
         "library_ms": uk8_f64["cusparse_us"] / 1e3,
         "shape": "uk-2002@0.05 f64 K=8 (route merge, auto's f64 pick; "
                  "spmm_merge_kernel)"},
        {"name": "sptrsv_csr_f64", "route": "cuda",
         "source": "sblas_torch/csrc/sptrsv_csr.cu",
         "replaces": ["sblas/ops/kernels/sptrsv_ds.py:65",
                      "sblas/ops/kernels/sptrsv_ds.py:159"],
         "launches": launches["sptrsv_csr_f64"],
         "max_abs_err": max_abs["sptrsv_csr_f64"],
         "ms": big64["us"] / 1e3, "plain_ms": big64["plain_us"] / 1e3,
         "bound_ms": big64["bound_us"] / 1e3, "bound_by": big64["bound_by"],
         "library_ms": None if big64["cusparse_us"] is None
         else big64["cusparse_us"] / 1e3,
         "shape": "chol-nd-poisson2d-1000 (1M rows, 50.2M nnz) f64, K=1"}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
