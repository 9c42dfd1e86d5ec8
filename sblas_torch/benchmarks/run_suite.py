"""The port's benchmark suite: the counterpart of ``benchmarks/run_suite.py``
(BASELINE.json configs 1-5), on one NVIDIA card.

    python -m sblas_torch.benchmarks.run_suite            # every stage below
    python -m sblas_torch.benchmarks.run_suite --quick    # cant, band-parallel
    python -m sblas_torch.benchmarks.run_suite --large [--web] [--case NAME]
    python -m sblas_torch.benchmarks.run_suite --graphs-only

Stages, in order (``--case`` keeps the matrices whose name holds it):

- ``stream``: the STREAM triad of the device;
- ``fem_spmv``: cant, consph, pdb1HYS and pwtk (``auto``) in f32, bf16
  values and f64 (config 1);
- ``fem_spmm``: the same matrices at K = 8 and 32 (``auto``), and the
  block kernel at 64-row blocks (config 2);
- ``solves``: the factors ``run_suite.py`` builds (band-parallel,
  chol-nd-poisson2d-120 and -60; f64 on band-parallel and -60) at K = 1
  and 8, the plain level-set solve beside band-parallel and -60
  (``compare_reference``), and the sync-free kernel in its ticket order,
  plain level order and row order on each, chol-nd-poisson2d-1000 (1M
  rows) included (config 3);
- ``graphs``: uk-2002@0.05 and twitter7@0.02 at K = 1, 8 and 32 (config 5);
- ``solvers``: the IC(0) and ILU(0) factorizations of the 1M-row grids
  (seconds on the host clock, best of 3), and CG + Jacobi to 1e-8, IC(0)-CG,
  ILU(0)-BiCGSTAB and ILU(0)-GMRES(30) for 30 iterations on them, each
  factor's solves in the three orders;
- ``sweeps``: the merge kernel at every share size (``unit_sweep``) and the
  solve kernel at every ticket group size (``ticket_group_sweep``);
- ``large`` (only with ``--large``): fem-band-1M-112M, powerlaw-1M-102M and
  fem-cluster-1M-109M (and uk-2002 at full scale with ``--web``), each
  generated once into ``build/sblas_torch/matrices/`` (``matrix_cache``),
  with its generator and plan seconds, SpMV and SpMM at K = 8 and 32.

Every record is one JSON line in ``--out`` (default
``build/sblas_torch/suite_<time>.jsonl``) and on stdout, with its stage and
the card's ``name, power.limit`` as nvidia-smi gives them; each stage ends
with a line of its seconds and of the kernels it launched. A stage that
raises is recorded with its error, the stages after it still run, and the
process exits 1. It runs on the card; ``--device cpu`` runs the kernels'
plain versions on the host clock.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from .. import datasets, solvers
from ..bench_lib import (EPS, bench_solver, bench_spmm, bench_spmv,
                         bench_sptrsm, bench_sptrsv)
from ..golden import KERNEL_TOL, rel_err
from ..matrix_cache import cached_matrix
from ..native import BUILD_DIR
from ..ops.common import as_csr
from ..ops.kernels import spmm_csr as ckern
from ..ops.kernels import sptrsv_csr as skern
from ..ops.spmv import SpmvPlan
from ..ops.sptrsv import get_plan as sptrsv_plan
from ..trace import launch_counts
from ..utils.timing import (BenchRecord, measure_host_seconds,
                            measure_seconds_per_iter, stream_bandwidth)

FEM = ("cant", "consph", "pdb1HYS", "pwtk")
GRAPHS = (("uk-2002", 0.05), ("twitter7", 0.02))
# interleaved (kernel, STREAM) pairs a record takes on the card: the JAX
# suite's, 9 on the two FEM matrices nearest its bar
FEM_PAIRS = {"consph": 9, "pdb1HYS": 9}
# the preconditioned solvers' iterations (a cut depth: the time per
# iteration is what the stage measures)
SOLVER_ITERS = 30
Gen = Callable[[], object]


class Suite:
    """Where the stages write: one JSON line a record, in ``out`` and on
    stdout; the matrices a run has generated, by name; the stages that
    failed."""

    def __init__(self, out: Path, device: torch.device, card: str):
        self.out, self.device, self.card = out, device, card
        self.records: list[dict] = []
        self.failed: list[str] = []
        self._mats: dict = {}
        out.parent.mkdir(parents=True, exist_ok=True)

    def emit(self, stage: str, rec, **extra) -> dict:
        d = rec.as_dict() if isinstance(rec, BenchRecord) else dict(rec)
        d = {"stage": stage, **d, **extra, "card": self.card}
        self.records.append(d)
        line = json.dumps(d)
        with open(self.out, "a") as f:
            f.write(line + "\n")
        print(line, flush=True)
        return d

    def matrix(self, name: str, gen: Gen):
        """``gen()``, once a run: later stages share what an earlier one
        generated."""
        if name not in self._mats:
            self._mats[name] = gen()
        return self._mats[name]

    def run(self, stages: list[tuple[str, Callable[["Suite"], None]]]) -> int:
        """Run each stage; 1 if any raised (recorded, the rest still run),
        else 0."""
        for name, stage in stages:
            before, t0 = launch_counts(), time.perf_counter()
            try:
                stage(self)
            except Exception as e:      # recorded; the process exits 1
                self.failed.append(name)
                self.emit(name, {"error": f"{type(e).__name__}: {e}",
                                 "traceback": traceback.format_exc()[-2000:]})
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            after = launch_counts()
            self.emit(name, {"stage_seconds": time.perf_counter() - t0,
                             "launches": {k: after[k] - before[k]
                                          for k in after}})
        print(f"# wrote {len(self.records)} records to {self.out}"
              + (f"; failed: {', '.join(self.failed)}" if self.failed
                 else ""), flush=True)
        return 1 if self.failed else 0


def _us(dev: torch.device, step, x0, **kw) -> float:
    """Marginal µs of ``step(x, x0)``: CUDA graphs on the card, the host
    clock on the CPU."""
    measure = measure_seconds_per_iter if dev.type == "cuda" \
        else measure_host_seconds
    return 1e6 * measure(step, x0, x0, **kw)


def _vec(dev, shape, seed, dtype=np.float32) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(dtype)).to(dev)


def _check(label: str, got: torch.Tensor, want: torch.Tensor,
           tol: float = KERNEL_TOL) -> float:
    """A kernel against its plain version; raises past ``tol``."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    if g.shape != w.shape or not np.isfinite(g).all():
        raise RuntimeError(f"{label}: bad kernel output")
    err = rel_err(g, w)
    if not err <= tol:
        raise RuntimeError(f"{label}: kernel vs plain rel_err {err} > {tol}")
    return err


# -- the case tables: name -> generator ----------------------------------

def fem_cases() -> dict[str, Gen]:
    return {name: (lambda name=name: datasets.emulate(
        name, scale=1.0, dtype=np.float32)) for name in FEM}


def graph_cases() -> dict[str, Gen]:
    return {f"{name}@{s:g}": (lambda name=name, s=s: datasets.emulate(
        name, scale=s, dtype=np.float32)) for name, s in GRAPHS}


def factor_cases() -> dict[str, Gen]:
    """The triangular factors of config 3, in f64 (the f32 ones are these
    cast: both generators compute in f64), and the nested-dissection
    Cholesky factor at 1M rows and 50M nonzeros."""
    cases = {"band-parallel": lambda: datasets.lower_triangular(
        62451, 30, bandwidth=4000, seed=1, dtype=np.float64)}
    for grid in (120, 60, 1000):
        cases[f"chol-nd-poisson2d-{grid}"] = lambda grid=grid: \
            datasets.cholesky_factor(datasets.poisson2d_nd(
                grid, dtype=np.float64), dtype=np.float64)
    return cases


def solver_cases() -> dict[str, Gen]:
    """The solvers' 1M-row grids, in f64: the SPD one (IC(0), CG) first,
    the nonsymmetric one (ILU(0), BiCGSTAB, GMRES) second."""
    return {"poisson2d(1000)": lambda: datasets.poisson2d(
                1000, dtype=np.float64),
            "convection_diffusion(1000)": lambda: datasets.convection_diffusion(
                1000, dtype=np.float64)}


def large_key(name: str) -> str:
    """The matrix cache's key of the large case ``name``."""
    return f"suite-large-{name}"


def large_cases(web: bool = False) -> dict[str, Gen]:
    """The >= 100M-nonzero single-card cases of ``run_suite.py:327``."""
    cases = {
        "fem-band-1M-112M": lambda: datasets.random_csr(
            1_000_000, 1_000_000, 112, bandwidth=1500, seed=7,
            dtype=np.float32),
        "powerlaw-1M-102M": lambda: datasets.powerlaw_graph(
            1_000_000, avg_deg=120, seed=7, dtype=np.float32),
        "fem-cluster-1M-109M": lambda: datasets.random_csr(
            1_000_000, 1_000_000, 130, bandwidth=180, seed=11,
            dtype=np.float32),
    }
    if web:
        cases["uk-2002-full"] = lambda: datasets.emulate(
            "uk-2002", scale=1.0, dtype=np.float32)
    return cases


# -- the stages ------------------------------------------------------------

def stage_stream(s: Suite) -> None:
    bw = stream_bandwidth(s.device)
    s.emit("stream", BenchRecord("stream_triad", 1.0, bytes=bw * 1e9,
                                 extra={"device": str(s.device)}))


def stage_fem_spmv(s: Suite, mats: dict[str, Gen],
                   dtypes=("f32", "bf16", "f64")) -> None:
    for name, gen in mats.items():
        a = s.matrix(name, gen)
        pairs = FEM_PAIRS.get(name, 5)
        for dt in dtypes:
            if dt == "f64":
                rec = bench_spmv(a.astype(np.float64), ratio_pairs=pairs,
                                 device=s.device)
            else:
                vd = torch.bfloat16 if dt == "bf16" else None
                rec = bench_spmv(a, value_dtype=vd, ratio_pairs=pairs,
                                 device=s.device)
            s.emit("fem_spmv", rec, matrix=name)


def stage_fem_spmm(s: Suite, mats: dict[str, Gen], ks=(8, 32)) -> None:
    for name, gen in mats.items():
        a = s.matrix(name, gen)
        for k in ks:
            s.emit("fem_spmm", bench_spmm(a, k, ratio_pairs=3,
                                          device=s.device), matrix=name)
            s.emit("fem_spmm", bench_spmm(a, k, method="block", block_rows=64,
                                          baseline=False, device=s.device),
                   matrix=name)


def order_us(dev, op: dict, b0: torch.Tensor, turns: int = 2,
             **kw) -> dict:
    """µs of the solve kernel on ``op`` with its tickets (levels, small ones
    grouped), in plain level order and in row order, in turns (ticket,
    level, row, ticket, ...), each order first held bit for bit to the
    tickets; 1 and 4 solves, best of 3 each (``kw`` overrides)."""
    kw = {"iters_lo": 1, "iters_hi": 4, **kw}
    level = {**op, "perm": torch.from_numpy(skern.ticket_order(
        op["levels"], op["lower"], 0)).to(op["perm"].device)}
    orders = (("ticket_us", op), ("level_us", level),
              ("row_order_us", skern.row_order(op)))
    got = skern.sptrsv_csr(op, b0)
    for label, o in orders[1:]:
        if not torch.equal(skern.sptrsv_csr(o, b0), got):
            raise RuntimeError(f"{label}: the solve differs from the "
                               "ticket order's")
    out = {}
    for label, o in orders * turns:
        t = _us(dev, lambda x, b0, o=o: skern.sptrsv_csr(o, b0 + EPS * x),
                b0, **kw)
        out[label] = min(out.get(label, t), t)
    return out


def stage_solves(s: Suite, factors: dict[str, Gen], *,
                 f64=("band-parallel", "chol-nd-poisson2d-60"),
                 compare=("band-parallel", "chol-nd-poisson2d-60"),
                 sptrsm: bool = True, orders: bool = True) -> None:
    dev = s.device
    for name, gen in factors.items():
        l64 = s.matrix(name, gen)
        big = l64.shape[0] >= 1_000_000
        for dt in ("f32", "f64") if name in f64 else ("f32",):
            l = l64 if dt == "f64" else s.matrix(
                name + " f32", lambda: l64.astype(np.float32))
            s.emit("solves", bench_sptrsv(
                l, device=dev, compare_reference=name in compare and
                dt == "f32"), matrix=name)
            if sptrsm:
                s.emit("solves", bench_sptrsm(l, 8, device=dev),
                       matrix=name)
            if not orders or dt == "f64":
                continue
            # the kernel's three ticket orders: the 1M-row factor's in one
            # turn (its row order takes 20-116 ms a solve), the others in two
            turns = 1 if big else 2
            fkw = {"iters_lo": 1, "iters_hi": 2, "repeats": 1} if big else {}
            for label, op, k in (
                    ("K=1", sptrsv_plan(l, device=dev)._op, 1),
                    ("K=8", sptrsv_plan(l, device=dev)._op, 8),
                    ("trans K=1", sptrsv_plan(as_csr(l, True), lower=False,
                                              device=dev)._op, 1)):
                b0 = _vec(dev, (l.shape[0], k) if k > 1 else l.shape[0], k)
                s.emit("solves", {"name": "sptrsv_orders", "case": label,
                                  "n": l.shape[0], "nnz": l.nnz,
                                  "nlevels": op["nlevels"],
                                  **order_us(dev, op, b0, turns, **fkw)},
                       matrix=name)


def stage_graphs(s: Suite, graphs: dict[str, Gen], ks=(8, 32)) -> None:
    for name, gen in graphs.items():
        g = s.matrix(name, gen)
        s.emit("graphs", bench_spmv(g, ratio_pairs=5, device=s.device),
               matrix=name)
        for k in ks:
            s.emit("graphs", bench_spmm(g, k, ratio_pairs=3,
                                        device=s.device), matrix=name)


def stage_large(s: Suite, cases: dict[str, Gen], ks=(8, 32),
                root: Path | None = None) -> None:
    """Each case from the matrix cache (its seconds: generating and saving
    it the first time, loading it after), the seconds of its SpMV plan cold
    (the first in this process) and warm (a second one: the port keeps no
    layout cache, so warm is the same work on warm caches), SpMV and SpMM
    records. Plans and matrix die before the next case."""
    from ..matrix_cache import entry_dir

    for name, gen in cases.items():
        key = large_key(name)
        cached = (entry_dir(key, root) / "shape.npy").exists()
        t0 = time.perf_counter()
        a = cached_matrix(key, gen, root)
        gen_s = time.perf_counter() - t0
        plan_s = []
        for _ in range(2):
            t0 = time.perf_counter()
            plan = SpmvPlan(a, "auto", device=s.device)
            if s.device.type == "cuda":
                torch.cuda.synchronize(s.device)
            plan_s.append(time.perf_counter() - t0)
            del plan
        rec = bench_spmv(a, ratio_pairs=5, device=s.device)
        s.emit("large", rec, matrix=name, gen_seconds=gen_s,
               gen_cached=cached, plan_seconds_cold=plan_s[0],
               plan_seconds_warm=plan_s[1])
        for k in ks:
            s.emit("large", bench_spmm(a, k, ratio_pairs=3, device=s.device),
                   matrix=name)
        del a, rec
        if s.device.type == "cuda":
            torch.cuda.empty_cache()


def stage_solvers(s: Suite, cases: dict[str, Gen]) -> None:
    """IC(0) of the SPD grid of ``cases`` and ILU(0) of the nonsymmetric
    one (:func:`solver_cases`): the host factorization's seconds
    (``native.ic0_inplace``/``ilu0_inplace`` alone, best of 3, the library
    loaded before the first, and the whole ``solvers.ichol``/``ilu``
    set-up with its two solve plans), then the four solver timings of
    ``bench_solver`` for ``SOLVER_ITERS`` iterations (ms an iteration,
    split into the SpMV, the two solves and the rest), each factor's
    solves in the three ticket orders."""
    from .. import native
    from ..formats import tril

    def factor_s(fn, a) -> float:
        best = float("inf")
        for _ in range(3):
            data = a.data.astype(np.float64)
            t0 = time.perf_counter()
            fn(a.indptr, a.indices, data)
            best = min(best, time.perf_counter() - t0)
        return best

    dev = s.device
    (p_name, p_gen), (c_name, c_gen) = cases.items()
    p, c = s.matrix(p_name, p_gen), s.matrix(c_name, c_gen)
    lo = tril(p)
    native.load()           # its first load builds it on a fresh checkout
    ic0_s = factor_s(native.ic0_inplace, lo)
    ilu0_s = factor_s(native.ilu0_inplace, c)
    t0 = time.perf_counter()
    m_ic = solvers.ichol(p, device=dev)
    ichol_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    m_ilu = solvers.ilu(c, device=dev)
    ilu_s = time.perf_counter() - t0
    s.emit("solvers", {"name": "factorization", "timer": "host",
                       "n": p.shape[0], "ic0_nnz": lo.nnz, "ilu0_nnz": c.nnz,
                       "ic0_factor_s": ic0_s, "ilu0_factor_s": ilu0_s,
                       "ichol_setup_s": ichol_s, "ilu_setup_s": ilu_s,
                       "matrix": f"{p_name}, {c_name} f64"})
    b = np.random.default_rng(0).standard_normal(p.shape[0])
    runs = [("cg+jacobi", solvers.cg, p, solvers.jacobi(p, device=dev),
             {"tol": 1e-8, "maxiter": 20000}),
            ("ic0-cg", solvers.cg, p, m_ic,
             {"tol": 0.0, "maxiter": SOLVER_ITERS}),
            ("ilu0-bicgstab", solvers.bicgstab, c, m_ilu,
             {"tol": 0.0, "maxiter": SOLVER_ITERS}),
            ("ilu0-gmres(30)", solvers.gmres, c, m_ilu,
             {"tol": 0.0, "maxiter": SOLVER_ITERS, "restart": 30})]
    for label, solve, a, m_, kw in runs:
        row = bench_solver(solve, a, b, M=m_, device=dev, **kw)
        true = row["true_rel_residual"]
        if kw["tol"] and not true <= 2 * kw["tol"]:
            raise RuntimeError(f"{label}: true residual {true}")
        agree = abs(row["rel_residual"] - true) / true
        # the reported residual is the recurrence's: it must stay the true
        # one, down to f64 round-off where a small grid converges outright
        if not kw["tol"] and not agree <= 1e-6 and true > 1e-13:
            raise RuntimeError(f"{label}: reported residual "
                               f"{row['rel_residual']} against the true "
                               f"{true}")
        if label in ("ic0-cg", "ilu0-bicgstab"):
            b0 = torch.from_numpy(b).to(dev)
            for side, sp in (("fwd", m_.fwd), ("bwd", m_.bwd)):
                # row order takes ~0.27 s a solve at 1M rows: one turn, one
                # sample of one against two solves
                row[f"{side}_order_us"] = order_us(
                    dev, sp._op, b0, 1, iters_lo=1, iters_hi=2, repeats=1)
        s.emit("solvers", {"name": label, **row, "residual_agreement": agree},
               matrix=p_name if a is p else c_name)


def stage_sweeps(s: Suite, graphs: dict[str, Gen],
                 factors: dict[str, tuple[Gen, tuple]]) -> None:
    """The merge kernel at each share size (merged-path items) on the
    graphs at K = 1, 8 (the rows kernel) and 32 (the columns kernel), and
    its time for one wave of shares on a small matrix (the SpMV rule's
    ``MERGE_SHARE_NS``); the solve kernel with small levels grouped up to
    512 .. 4,096 rows (``GROUP_ROWS``) on the factors at the Ks given. Each
    variant is checked (the merge kernel against its plain version, each
    ticket order bit for bit) before it is timed."""
    from ..formats import to_device
    from ..ops.spmv import MERGE_SHARE_NS

    dev = s.device
    for name, gen in graphs.items():
        t = to_device(s.matrix(name, gen), dev)
        sweep, errs = {}, {}
        for k in (1, 8, 32):
            x0 = _vec(dev, (t["shape"][1], k), k)
            for unit in (256, 384, 512, 1024, 2048):
                op = ckern.prepare(t, unit)
                errs[f"{unit},K={k}"] = _check(
                    f"{name} unit={unit} K={k}", ckern.spmm_csr(op, x0, 2.5),
                    ckern.spmm_csr_reference(op, x0, 2.5))
                sweep[f"{unit},K={k}"] = _us(
                    dev, lambda x, x0, op=op: ckern.spmm_csr(
                        op, x, EPS, 1.0, x0), x0)
        s.emit("sweeps", {"name": "unit_sweep", "rule_unit": ckern.UNIT,
                          "rule_unit_cols": ckern.UNIT_COLS,
                          "rule_unit_spmv": ckern.UNIT_SPMV, "us": sweep,
                          "rel_err": errs}, matrix=name)
        del t
    t = to_device(datasets.banded(300, 5), dev)
    x0 = _vec(dev, (300, 1), 1)
    one_wave = {}
    for unit in (256, 512, 1024, 2048):
        op = ckern.prepare(t, unit)
        _check(f"banded(300,5) unit={unit}", ckern.spmm_csr(op, x0, 2.5),
               ckern.spmm_csr_reference(op, x0, 2.5))
        one_wave[unit] = _us(dev, lambda x, x0, op=op: ckern.spmm_csr(
            op, x, EPS, 1.0, x0), x0)
    s.emit("sweeps", {"name": "unit_sweep", "one_wave_us": one_wave,
                      "rule_share_ns": MERGE_SHARE_NS},
           matrix="banded(300,5)")
    group_sweep = {}
    for name, (gen, ks) in factors.items():
        l = s.matrix(name + " f32", lambda: s.matrix(name, gen).astype(
            np.float32))
        op = sptrsv_plan(l, device=dev)._op
        for k in ks:
            b0 = _vec(dev, (l.shape[0], k) if k > 1 else l.shape[0], k)
            got = skern.sptrsv_csr(op, b0)
            row = {}
            for grp in (512, 1024, 2048, 4096):
                o = {**op, "perm": torch.from_numpy(skern.ticket_order(
                    op["levels"], True, grp)).to(dev)}
                if not torch.equal(skern.sptrsv_csr(o, b0), got):
                    raise RuntimeError(f"{name} group {grp}: other bits")
                row[grp] = _us(dev, lambda x, b0, o=o: skern.sptrsv_csr(
                    o, b0 + EPS * x), b0, iters_lo=1, iters_hi=4)
            group_sweep[f"{name} K={k}"] = row
    s.emit("sweeps", {"name": "ticket_group_sweep",
                      "rule_group_rows": skern.GROUP_ROWS,
                      "us": group_sweep})


# -- the command -------------------------------------------------------------

def _only(cases: dict, case: str | None) -> dict:
    return {k: v for k, v in cases.items() if not case or case in k}


def stages_for(args) -> list[tuple[str, Callable[[Suite], None]]]:
    """The stages ``args`` selects, with their case tables."""
    case = args.case
    stages = [("stream", stage_stream)]
    if args.large:
        ks = (args.k,) if args.k else (8, 32)
        cases = _only(large_cases(args.web), case)
        return stages + [("large", lambda s: stage_large(s, cases, ks))]
    graphs = _only(graph_cases(), case)
    if args.graphs_only:
        return stages + [("graphs", lambda s: stage_graphs(s, graphs))]
    fem = _only(fem_cases() if not args.quick
                else {"cant": fem_cases()["cant"]}, case)
    factors = factor_cases()
    if args.quick:
        tri = _only({"band-parallel": factors["band-parallel"]}, case)
        solve_kw = {"f64": (), "compare": (), "sptrsm": False,
                    "orders": False}
    else:
        tri = _only(factors, case)
        solve_kw = {}
    if fem:
        stages += [("fem_spmv", lambda s: stage_fem_spmv(
            s, fem, ("f32",) if args.quick else ("f32", "bf16", "f64"))),
                   ("fem_spmm", lambda s: stage_fem_spmm(s, fem))]
    if tri:
        stages.append(("solves", lambda s: stage_solves(s, tri, **solve_kw)))
    if args.quick:
        return stages
    if graphs:
        stages.append(("graphs", lambda s: stage_graphs(s, graphs)))
    if _only(solver_cases(), case):
        grids = solver_cases()
        stages.append(("solvers", lambda s: stage_solvers(s, grids)))
    sweep_factors = _only({
        "band-parallel": (factors["band-parallel"], (1, 8)),
        "chol-nd-poisson2d-120": (factors["chol-nd-poisson2d-120"], (1,)),
        "chol-nd-poisson2d-1000": (factors["chol-nd-poisson2d-1000"], (1,)),
    }, case)
    if graphs or sweep_factors:
        stages.append(("sweeps", lambda s: stage_sweeps(s, graphs,
                                                        sweep_factors)))
    return stages


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sblas_torch.benchmarks.run_suite",
        description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="cant and band-parallel only, f32")
    ap.add_argument("--large", action="store_true",
                    help="only the >= 100M-nonzero single-card records")
    ap.add_argument("--web", action="store_true",
                    help="with --large: add uk-2002 at full scale (18.5M "
                         "rows, 298M nonzeros)")
    ap.add_argument("--case", default=None,
                    help="run only the matrices whose name holds this")
    ap.add_argument("--graphs-only", action="store_true",
                    help="run just the power-law graph stage")
    ap.add_argument("--k", type=int, default=None,
                    help="with --large: one SpMM K instead of 8 and 32")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from ..utils.backend import nvidia_smi, pick_device

    dev = pick_device(args.device)
    card = (nvidia_smi() or torch.cuda.get_device_name(dev)).splitlines()[0] \
        if dev.type == "cuda" else "cpu"
    out = Path(args.out or BUILD_DIR / f"suite_{int(time.time())}.jsonl")
    suite = Suite(out, dev, card)
    suite.emit("start", {"argv": list(sys.argv[1:] if argv is None
                                      else argv),
                         "device": str(dev), "torch": torch.__version__})
    return suite.run(stages_for(args))


if __name__ == "__main__":
    sys.exit(main())
