"""The halo plan built from each rank's own rows, CG on row-sharded vectors
and the Jacobi of a block of rows, on ``gloo`` CPU ranks
(:func:`sblas_torch.parallel.launch.spawn`) at 2 and 4 ranks.

Each group runs once for the whole file: its ranks import nothing of JAX
(they report what they loaded). On every matrix, f32 and f64 (HPCG's
27-point stencil of small boxes stacked along z, each rank's rows from
``portbench.generators.hpcg_ranks``; a seeded random banded matrix whose
last rank holds fewer rows), the plan from a rank's rows is held to the
plan from the whole matrix bit for bit: ``halo``, the global call (with
and without ``alpha``, ``beta``, ``y``), and the local call, which also
gives the global call's rows; the global call gives the single-device
``csr`` plan's bits. The row block's Jacobi gives the whole matrix's
Jacobi's rows. ``dist_cg`` on the sharded plan reaches a true global
residual under ``1.001 tol`` (``portbench/reference/cg.py``) within two
iterations of the single-device ``solvers.cg``, reducing twice an
iteration it launches (two more to start), one exchange an SpMV; read one
iteration behind, ``cg`` returns the bits, count and residual of the loop
that reads first, at one SpMV more a solve. A rank's rows off the
even split, and a scattered matrix, are refused on every rank. The plan's
build records its spans in their phases, and a profiled solve shows the
ranges of the exchange and the reductions.
"""

import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sblas_torch import datasets, solvers
from sblas_torch.formats import CSR
from sblas_torch.ops.spmv import SpmvPlan
from sblas_torch.parallel.launch import spawn

WORLDS = (2, 4)
TOL = 1e-8
# a box of 6^3 a rank: 216 rows (the even split), a halo of 40 (36, one
# plane, rounded up to 8)
BOX = {"nx": 6, "ny": 6, "nz": 6, "diagonal": 26.0, "off_diagonal": -1.0}
BAND_ROWS = 300           # 4 ranks: 80, 80, 80 and 60 rows
MATRICES = ("stencil-f64", "stencil-f32", "band-f32", "band-f64")
CHECKS = ("halo", "call", "call_axpby", "local", "local_axpby",
          "local_is_rows_of_call", "call_is_single_device", "jacobi")


def _box(world: int, dtype: str) -> dict:
    return {**BOX, "dtype": dtype, "process_grid": [1, 1, world]}


def _csr(g: dict) -> CSR:
    return CSR(tuple(g["shape"]), g["indptr"].numpy(), g["indices"].numpy(),
               g["data"].numpy())


def _matrix(name: str, world: int) -> CSR:
    from portbench.generators import hpcg

    kind, dtype = name.split("-")
    if kind == "stencil":
        cfg = _box(world, {"f32": "float32", "f64": "float64"}[dtype])
        return _csr(hpcg.generate({**cfg, "nz": BOX["nz"] * world}, 0, "cpu"))
    return datasets.random_csr(BAND_ROWS, BAND_ROWS, 6, bandwidth=9, seed=5,
                               dtype={"f32": np.float32,
                                      "f64": np.float64}[dtype])


def _rows_of(a: CSR, r0: int, r1: int) -> CSR:
    p0, p1 = int(a.indptr[r0]), int(a.indptr[r1])
    return CSR((r1 - r0, a.shape[1]), a.indptr[r0:r1 + 1] - p0,
               a.indices[p0:p1], a.data[p0:p1])


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _plans(name: str, world: int, mesh) -> dict:
    """One matrix's outputs on this rank, by check."""
    from sblas_torch.parallel import HaloSpmvPlan

    a = _matrix(name, world)
    n = a.shape[0]
    whole = HaloSpmvPlan(a, mesh, local_method="csr")
    r0, r1 = whole.row0, whole.row0 + whole.rows
    rows = _rows_of(a, r0, r1)
    mine = HaloSpmvPlan(rows, mesh, row0=r0, local_method="csr")
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal(n).astype(a.dtype))
    y = torch.from_numpy(rng.standard_normal(n).astype(a.dtype))
    ones = torch.ones(n, dtype=x.dtype)
    return {
        "halo": (np.array([whole.halo]), np.array([mine.halo])),
        "call": (_np(whole(x)), _np(mine(x))),
        "call_axpby": (_np(whole(x, 0.5, -2.0, y)),
                       _np(mine(x, 0.5, -2.0, y))),
        "local": (_np(whole.local(x[r0:r1])), _np(mine.local(x[r0:r1]))),
        "local_axpby": (_np(whole.local(x[r0:r1], 0.5, -2.0, y[r0:r1])),
                        _np(mine.local(x[r0:r1], 0.5, -2.0, y[r0:r1]))),
        "local_is_rows_of_call": (_np(mine(x))[r0:r1],
                                  _np(mine.local(x[r0:r1]))),
        "call_is_single_device": (_np(SpmvPlan(a, "csr", device="cpu")(x)),
                                  _np(mine(x))),
        "jacobi": (_np(solvers.jacobi(a, device="cpu")(ones))[r0:r1],
                   _np(solvers.jacobi(rows, row0=r0,
                                      device="cpu")(ones[r0:r1]))),
    }


def _refusal(make) -> str | None:
    try:
        make()
    except ValueError as e:
        return str(e)
    return None


def _whole_stencil(world: int) -> dict:
    from portbench.generators import hpcg

    return hpcg.generate({**_box(world, "float64"),
                          "nz": BOX["nz"] * world}, 0, "cpu")


def _rank_side(world: int) -> dict:
    """Every case on this rank: outputs of each matrix, the sharded CG, the
    counters, the refusals, and the JAX modules loaded."""
    from portbench.generators import hpcg_ranks
    from sblas_torch import trace
    from sblas_torch.parallel import HaloSpmvPlan, dist_cg, make_mesh

    mesh = make_mesh(device="cpu")
    rank = mesh.index
    out = {"plans": {name: _plans(name, world, mesh) for name in MATRICES}}

    g = hpcg_ranks.generate(_box(world, "float64"), 0, "cpu", rank=rank,
                            world=world)
    rows, r0 = _csr(g), g["row0"]
    n = rows.shape[1]
    x_true = np.random.default_rng(7).standard_normal(n)
    b_own = rows.to_scipy() @ x_true
    trace.reset()
    plan = HaloSpmvPlan(rows, mesh, row0=r0)
    HaloSpmvPlan(_csr(_whole_stencil(world)), mesh)
    out["spans"] = {k: v["phase"] for k, v in trace.totals()["names"].items()
                    if "Halo" in k}
    pre = solvers.jacobi(rows, row0=r0, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dist_cg(plan, b_own, M=pre, tol=TOL, maxiter=2)
    out["ranges"] = sorted({e.name for e in prof.events()
                            if e.name.startswith("sblas.")})
    trace.reset()
    plan.local(torch.zeros(plan.rows, dtype=torch.float64))
    out["one_local"] = trace.dist_counts()
    out["halo_bytes"] = 2 * plan.halo * 8
    trace.reset()
    x_own, info = dist_cg(plan, b_own, M=pre, tol=TOL, maxiter=500)
    out["cg"] = {"x": _np(x_own), "info": info,
                 "counts": trace.dist_counts()}

    wrong = _rows_of(rows, 0, rows.shape[0] - 8) if rank == 1 else rows
    out["refused_split"] = _refusal(
        lambda: HaloSpmvPlan(wrong, mesh, row0=r0))
    scattered = datasets.random_csr(64 * world, 64 * world, 6, seed=3)
    chunk = 64
    out["refused_halo"] = _refusal(lambda: HaloSpmvPlan(
        _rows_of(scattered, rank * chunk, (rank + 1) * chunk), mesh,
        row0=rank * chunk))
    out["jax"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "sblas"))
    return out


@pytest.fixture(scope="module")
def group():
    """Each world's ranks' results, spawned at first use."""
    runs = {}

    def get(world: int) -> list:
        if world not in runs:
            runs[world] = spawn(world, _rank_side, world, device="cpu")
        return runs[world]

    return get


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("matrix", MATRICES)
@pytest.mark.parametrize("check", CHECKS)
def test_own_rows_plan_gives_the_whole_matrix_plans_bits(group, world,
                                                         matrix, check):
    for r, out in enumerate(group(world)):
        want, got = out["plans"][matrix][check]
        assert want.dtype == got.dtype, (r, want.dtype, got.dtype)
        assert np.array_equal(want, got), f"rank {r}"


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_load_no_jax(group, world):
    assert [out["jax"] for out in group(world)] == [[]] * world


@pytest.mark.parametrize("world", WORLDS)
def test_the_builds_spans_are_in_their_phases(group, world):
    for out in group(world):
        assert out["spans"] == {"sblas.HaloSpmvPlan": "build",
                                "sblas.HaloPlan.halo": "build",
                                "sblas.HaloPlan.rows": "convert",
                                "sblas.HaloPlan.shift": "convert"}


@pytest.mark.parametrize("world", WORLDS)
def test_a_profiled_solve_shows_the_exchange_and_the_reductions(group,
                                                                 world):
    for out in group(world):
        assert out["ranges"] == ["sblas.dist.allreduce",
                                 "sblas.halo.exchange"]


@pytest.mark.parametrize("world", WORLDS)
def test_one_local_call_is_one_exchange(group, world):
    for out in group(world):
        assert out["one_local"] == {"halo.exchanges": 1,
                                    "halo.bytes_sent": out["halo_bytes"],
                                    "dist.allreduces": 0}


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_cg_meets_the_global_residual(group, world):
    from portbench.reference import cg as ref

    outs = group(world)
    g = _whole_stencil(world)
    x = torch.from_numpy(np.concatenate([o["cg"]["x"] for o in outs]))
    x_true = torch.from_numpy(
        np.random.default_rng(7).standard_normal(g["shape"][0]))
    b = ref.rhs(g, x_true)
    (rel,) = ref.rel_residuals(g, [(b, x)])
    assert rel < 1.001 * TOL
    assert outs[0]["cg"]["info"]["rel_residual"] < TOL


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_cg_takes_the_single_device_iterations(group, world):
    outs = group(world)
    a = _csr(_whole_stencil(world))
    b = a.to_scipy() @ np.random.default_rng(7).standard_normal(a.shape[0])
    _, info = solvers.cg(a, b, M=solvers.jacobi(a, device="cpu"), tol=TOL,
                         maxiter=500, device="cpu")
    its = {o["cg"]["info"]["iterations"] for o in outs}
    assert len(its) == 1                   # every rank stopped together
    assert abs(its.pop() - info["iterations"]) <= 2


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_cg_reduces_twice_an_iteration(group, world):
    for out in group(world):
        it = out["cg"]["info"]["iterations"]
        counts = out["cg"]["counts"]
        # ||b||, then r.z with ||r|| once before the loop; two an iteration
        # launched: it kept, and the one its last read, behind it, dropped
        assert counts["dist.allreduces"] == 2 * (it + 1) + 2
        # the residual b - A x0, then one an iteration launched
        assert counts["halo.exchanges"] == it + 2
        assert counts["halo.bytes_sent"] == (it + 2) * out["halo_bytes"]


class _Counted:
    """A single-device plan that counts its calls; with ``reductions`` the
    one-device ones, so that ``cg`` reads its stopping test behind."""

    def __init__(self, plan, behind: bool):
        self.shape, self.dtype, self.device = \
            plan.shape, plan.dtype, plan.device
        if behind:
            self.reductions = solvers._OneDevice
        self._plan, self.calls = plan, 0

    def __call__(self, x, alpha=1.0, beta=0.0, y=None):
        self.calls += 1
        return self._plan(x, alpha, beta, y)


# how the solve stops: by tol, by maxiter, or at x0 (already converged)
STOPS = {"tol": {"tol": 1e-5, "maxiter": 500},
         "maxiter": {"tol": 1e-5, "maxiter": 7},
         "x0": {"tol": 1e-3, "maxiter": 500, "exact": True}}


@pytest.mark.parametrize("dtype", (np.float32, np.float64))
@pytest.mark.parametrize("stop", STOPS)
def test_reading_behind_gives_the_bits_of_reading_first(dtype, stop):
    kw = dict(STOPS[stop])
    a = datasets.poisson2d(16, dtype=dtype)
    x_true = np.random.default_rng(9).standard_normal(a.shape[0])
    b = a.to_scipy() @ x_true.astype(dtype)
    x0 = x_true.astype(dtype) if kw.pop("exact", False) else None
    pre = solvers.jacobi(a, device="cpu")
    runs = {}
    for behind in (False, True):
        plan = _Counted(SpmvPlan(a, "csr", device="cpu"), behind)
        x, info = solvers.cg(plan, b, M=pre, x0=x0, **kw)
        runs[behind] = (_np(x), info, plan.calls)
    (x, info, calls), (xb, info_b, calls_b) = runs[False], runs[True]
    assert np.array_equal(x, xb) and info == info_b
    # the residual, then an SpMV an iteration; behind, one more where a
    # read, not maxiter, stopped the loop
    assert calls == info["iterations"] + 1
    assert calls_b == calls + int(stop != "maxiter")
    assert (info["iterations"] == 7) == (stop == "maxiter")
    assert (info["iterations"] == 0) == (stop == "x0")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("refusal,said", [
    ("refused_split", "rows not the even split"),
    ("refused_halo", "is not band-local")])
def test_refused_on_every_rank(group, world, refusal, said):
    for out in group(world):
        assert out[refusal] is not None and said in out[refusal]
