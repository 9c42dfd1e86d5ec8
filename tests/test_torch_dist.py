"""The port's distributed plans and solvers against the JAX package's, on
the same inputs.

The port runs once for the whole file, in a ``gloo`` group of 8 CPU ranks
(:func:`sblas_torch.parallel.launch.spawn`, ``device="cpu"``): every case
below goes to the ranks as ``.npz`` arrays and a JSON list, and
:func:`~sblas_torch.parallel.launch.run_cases` writes each rank's outputs
back (the ranks cannot import this module: it imports JAX). The reference
runs here, on ``sblas.parallel.make_mesh(8)`` over conftest's 8 CPU
devices, with ``local_method="ell"`` (its XLA body; its Pallas bodies in
interpret mode are the slow-marked tests). Each case is its own test.

Checks, each case: every rank returned the same bits (the solvers' loops
end only if the ranks agree on ``norm(r) > stop``); the result agrees with
scipy and with the reference within ``default_tol`` (f32 2e-5, f64 1e-11,
``sblas/golden.py:58``). Where no row is split and the shard runs the
single-device plan's route (``even_rows`` and ``nnz_balanced`` with the
``csr`` or ``merge`` local; halo), the result is the same bits as the
port's single-device plan: a shard sums each row as the whole matrix's
plan does. ``nnz_split`` and the ring add a row in several partial sums,
and the ``block`` local's 128-row blocks start elsewhere on a shard, so
those hold to ``default_tol`` only. The f64 solvers to ``tol = 1e-8`` take
the reference's distributed solvers' iteration counts and the port's
single-device solvers', and a true residual within ``2 tol``.

The triangular solves (``DistSptrsvPlan``, ``DistSptrsmPlan`` and the
one-shot functions) run the reference's own cases (``tests/test_parallel.py``,
``tests/test_dist_fuzz.py``) in the same group: each held to scipy and to
the reference's plan at ``TOL`` (f32 2e-4, f64 1e-10), the same bits on
every rank, and the reference's ``nlevels`` and ``nbatches``. Column 0 of
the K-column solve agrees with the one-column solve to ``rtol`` 1e-5.
"""

import numpy as np
import pytest

import sblas.formats as ref_formats
import sblas.parallel as ref_par
from sblas import solvers as ref_solvers
from sblas_torch import datasets, solvers
from sblas_torch.formats import csr_transpose
from sblas_torch.golden import (default_tol, rel_err, spmm_golden,
                                spmv_golden, sptrsm_golden, sptrsv_golden)
from sblas_torch.ops.spmm import SpmmPlan
from sblas_torch.ops.spmv import SpmvPlan
from sblas_torch.parallel.dryrun import nonsymmetric
from sblas_torch.parallel.launch import run_group, save_matrix

RANKS = 8
SOLVER_TOL = 1e-8
TOL = {np.float32: 2e-4, np.float64: 1e-10}   # tests/test_torch_sptrsv.py


def _ref(a):
    """The reference's CSR holding the same arrays."""
    return ref_formats.CSR(a.shape, a.indptr, a.indices, a.data)


MATRICES = {
    "rand": lambda: datasets.random_csr(256, 256, 6, seed=1),
    "skew": lambda: datasets.random_csr(400, 400, 12, skew=1.2, seed=3),
    "band": lambda: datasets.banded(512, 5, seed=3),
    "poisson": lambda: datasets.poisson2d(12, dtype=np.float64),
    "nonsym": lambda: nonsymmetric(12),
    # the reference's dist solve cases (tests/test_parallel.py)
    "tri_band": lambda: datasets.lower_triangular(
        300, 4, bandwidth=9, seed=9, dtype=np.float64),
    "tri_rand": lambda: datasets.lower_triangular(300, 5, seed=10,
                                                  dtype=np.float64),
    "tri_chol": lambda: datasets.cholesky_factor(datasets.spd_diag_dominant(
        200, 5, bandwidth=12, seed=4, dtype=np.float64), dtype=np.float64),
    "tri_upper": lambda: csr_transpose(datasets.lower_triangular(
        250, 5, seed=41, dtype=np.float64)),
    "tri_clamp": lambda: datasets.lower_triangular(600, 5, seed=1,
                                                   dtype=np.float32),
    "tri_sm": lambda: datasets.lower_triangular(500, 5, seed=3,
                                                dtype=np.float32),
}


def _fuzz(seed):
    """``tests/test_dist_fuzz.py:22-33``'s factor and ``b`` of ``seed``."""
    rng = np.random.default_rng(1000 + seed)
    n = int(rng.integers(40, 1500))
    deg = float(rng.uniform(1.5, 9.0))
    skew = float(rng.choice([0.0, 0.0, 1.2]))
    l = datasets.lower_triangular(n, deg, skew=skew, seed=seed,
                                  dtype=np.float32)
    return l, rng.standard_normal(n).astype(np.float32)


FUZZ_SEEDS = (0, 2, 5)
for _seed in FUZZ_SEEDS:
    MATRICES[f"tri_fuzz{_seed}"] = lambda s=_seed: _fuzz(s)[0]

# (id, plan or function, matrix, keywords, columns of B or None)
SOLVES = [
    ("sptrsv-band", "DistSptrsvPlan", "tri_band", {}, None),
    ("sptrsv-random", "DistSptrsvPlan", "tri_rand", {}, None),
    ("sptrsv-chol", "DistSptrsvPlan", "tri_chol", {}, None),
    ("sptrsv-upper", "DistSptrsvPlan", "tri_upper", {"lower": False}, None),
    ("sptrsv-clamp", "DistSptrsvPlan", "tri_clamp", {}, None),
    ("sptrsm", "DistSptrsmPlan", "tri_sm", {}, 6),
    ("sptrsv-sm-col0", "DistSptrsvPlan", "tri_sm", {}, None),
    ("dist_sptrsv-unit", "dist_sptrsv", "tri_band",
     {"unit_diagonal": True}, None),
    ("dist_sptrsm-upper", "dist_sptrsm", "tri_upper", {"lower": False}, 3),
    *[(f"sptrsv-fuzz{s}", "DistSptrsvPlan", f"tri_fuzz{s}", {}, None)
      for s in FUZZ_SEEDS],
]
SOLVE_K = {cid: k for cid, _, _, _, k in SOLVES}


def _solve_b(cid, a):
    """``b`` or ``B`` of a solve case, from a seed: the reference's
    (``B[:, 0]`` for the column check; the fuzz cases' own)."""
    if cid.startswith("sptrsv-fuzz"):
        return _fuzz(int(cid.removeprefix("sptrsv-fuzz")))[1]
    if cid in ("sptrsm", "sptrsv-sm-col0"):
        bk = np.random.default_rng(1).standard_normal((500, 6)).astype(
            np.float32)
        return bk if cid == "sptrsm" else np.ascontiguousarray(bk[:, 0])
    k = SOLVE_K[cid]
    rng = np.random.default_rng(len(cid))
    return rng.standard_normal((a.shape[0], *((k,) if k else ()))).astype(
        a.dtype)


def _cases():
    cases = []
    for strategy in ("even_rows", "nnz_balanced", "nnz_split"):
        for local in ("ell", "csr", "merge"):
            cases.append({"id": f"spmv-{strategy}-{local}",
                          "plan": "DistSpmvPlan", "matrix": "rand",
                          "kw": {"strategy": strategy,
                                 "local_method": local}})
    for strategy in ("nnz_balanced", "nnz_split"):
        cases.append({"id": f"spmv-{strategy}-auto-skew",
                      "plan": "DistSpmvPlan", "matrix": "skew",
                      "kw": {"strategy": strategy}})
    cases.append({"id": "ring", "plan": "RingSpmvPlan", "matrix": "rand",
                  "kw": {}})
    for strategy in ("even_rows", "nnz_balanced", "nnz_split"):
        for local in ("merge", "block"):
            cases.append({"id": f"spmm-{strategy}-{local}",
                          "plan": "DistSpmmPlan", "matrix": "rand", "k": 8,
                          "kw": {"strategy": strategy,
                                 "local_method": local}})
    cases.append({"id": "spmm-nnz_balanced-auto-skew",
                  "plan": "DistSpmmPlan", "matrix": "skew", "k": 8,
                  "kw": {}})
    cases.append({"id": "halo-spmv", "plan": "HaloSpmvPlan",
                  "matrix": "band", "kw": {"local_method": "csr"}})
    cases.append({"id": "halo-spmm", "plan": "HaloSpmmPlan",
                  "matrix": "band", "k": 8, "kw": {"local_method": "merge"}})
    cases.append({"id": "halo-spmv-refused", "plan": "HaloSpmvPlan",
                  "matrix": "rand", "kw": {}})
    cases.append({"id": "halo-spmm-refused", "plan": "HaloSpmmPlan",
                  "matrix": "rand", "k": 8, "kw": {}})
    for solver, name, jac in (("dist_cg", "poisson", True),
                              ("dist_bicgstab", "nonsym", False),
                              ("dist_gmres", "nonsym", False)):
        cases.append({"id": solver, "solver": solver, "matrix": name,
                      "jacobi": jac,
                      "kw": {"tol": SOLVER_TOL, "maxiter": 2000}})
    for cid, name, matrix, kw, _ in SOLVES:
        cases.append({"id": cid, "solve": name, "matrix": matrix, "kw": kw})
    for c in cases:
        c["mesh"] = ["1d", RANKS]
    return cases


CASES = _cases()
CASE = {c["id"]: c for c in CASES}


def _inputs(case, a):
    """``x`` (or ``X``), ``y``, ``alpha``, ``beta`` of a plan case, from a
    seed."""
    rng = np.random.default_rng(len(case["id"]))
    m, n = a.shape
    tail = (case["k"],) if "k" in case else ()
    x = rng.standard_normal((n, *tail)).astype(a.dtype)
    y = rng.standard_normal((m, *tail)).astype(a.dtype)
    return x, y, 2.5, -0.5


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Every case run once on 8 gloo CPU ranks: the matrices, and each
    rank's outputs and reports."""
    wd = tmp_path_factory.mktemp("dist")
    mats = {name: make() for name, make in MATRICES.items()}
    arrays = {}
    for name, a in mats.items():
        save_matrix(arrays, name, a)
        arrays[f"b_{name}"] = np.random.default_rng(5).standard_normal(
            a.shape[0]).astype(a.dtype)
    cases = []
    for c in CASES:
        c = dict(c)
        if "plan" in c:
            x, y, alpha, beta = _inputs(c, mats[c["matrix"]])
            arrays[f"x_{c['id']}"], arrays[f"y_{c['id']}"] = x, y
            c.update(x=f"x_{c['id']}", y=f"y_{c['id']}", alpha=alpha,
                     beta=beta)
        elif "solve" in c:
            arrays[f"b_{c['id']}"] = _solve_b(c["id"], mats[c["matrix"]])
            c["b"] = f"b_{c['id']}"
        else:
            c["b"] = f"b_{c['matrix']}"
        cases.append(c)
    return (mats, *run_group(wd, RANKS, cases, arrays))


def _same_on_every_rank(outs, infos, cid):
    # what a case reported, less the rank's own route (auto may pick
    # another route on another shard: "routes" holds them all)
    def shared(info):
        return {k: v for k, v in info.items() if k != "route"}

    for r in range(1, RANKS):
        assert shared(infos[r][cid]) == shared(infos[0][cid]), r
        if cid in outs[0]:
            assert outs[r][cid].tobytes() == outs[0][cid].tobytes(), r


def _single_device(case, a, x, y, alpha, beta):
    """The port's single-device plan of the case's local route."""
    local = case["kw"]["local_method"]
    if "k" in case:
        plan = SpmmPlan(a, local, k_hint=case["k"], device="cpu")
    else:
        plan = SpmvPlan(a, local, device="cpu")
    return plan(x, alpha, beta, y).numpy()


@pytest.mark.parametrize("cid", [c["id"] for c in CASES if "plan" in c])
def test_dist_plan_matches_reference(group, cid):
    mats, outs, infos = group
    case = CASE[cid]
    a = mats[case["matrix"]]
    _same_on_every_rank(outs, infos, cid)
    mesh = ref_par.make_mesh(RANKS)
    cls = getattr(ref_par, case["plan"])
    kw = {k: v for k, v in case["kw"].items() if k != "local_method"}
    if case["plan"] != "HaloSpmmPlan" and case["plan"] != "RingSpmvPlan":
        kw["local_method"] = "ell"
    if cid.endswith("refused"):
        with pytest.raises(ValueError) as ref_err:
            cls(_ref(a), mesh, **kw)
        assert infos[0][cid] == {"error": str(ref_err.value)}
        return
    x, y, alpha, beta = _inputs(case, a)
    got = outs[0][cid]
    golden = spmm_golden if "k" in case else spmv_golden
    tol = default_tol(a.dtype)
    assert rel_err(got, golden(a, x, alpha, beta, y)) < tol
    plan = cls(_ref(a), mesh, **kw)
    if case["plan"] == "RingSpmvPlan":         # it takes x alone
        want = alpha * np.asarray(plan(x)) + beta * y
    else:
        want = np.asarray(plan(x, alpha, beta, y))
    assert rel_err(got, want) < tol
    local = case["kw"].get("local_method")
    if case["kw"].get("strategy") != "nnz_split" and local in ("csr",
                                                               "merge"):
        np.testing.assert_array_equal(
            got, _single_device(case, a, x, y, alpha, beta))


@pytest.mark.parametrize("cid", [c["id"] for c in CASES if "solver" in c])
def test_dist_solver_matches_reference(group, cid):
    mats, outs, infos = group
    case = CASE[cid]
    a = mats[case["matrix"]]
    _same_on_every_rank(outs, infos, cid)
    b = np.random.default_rng(5).standard_normal(a.shape[0])
    kw = case["kw"]
    name = cid.removeprefix("dist_")
    ref_m = ref_solvers.jacobi(_ref(a)) if case["jacobi"] else None
    _, ref_info = getattr(ref_par, cid)(
        _ref(a), b, mesh=ref_par.make_mesh(RANKS), local_method="ell",
        M=ref_m, **kw)
    m = solvers.jacobi(a, device="cpu") if case["jacobi"] else None
    _, one = getattr(solvers, name)(a, b, M=m, device="cpu", **kw)
    info = infos[0][cid]
    assert info["iterations"] == ref_info["iterations"] == \
        one["iterations"], (info, ref_info, one)
    x = outs[0][cid]
    true = np.linalg.norm(b - a.to_scipy() @ x) / np.linalg.norm(b)
    assert info["rel_residual"] < SOLVER_TOL
    assert true <= 2 * SOLVER_TOL


def test_every_rank_builds_its_own_shard(group):
    # the ranks' local routes were gathered into every rank's plan
    _, _, infos = group
    info = infos[0]["spmv-nnz_balanced-csr"]
    assert info["routes"] == ["csr"] * RANKS
    for r in range(RANKS):
        assert infos[r]["spmm-even_rows-block"]["route"] == "block"


def _ref_solve(case, a, b):
    """The reference's plan of a solve case on its 8-device mesh: its
    ``x`` and the plan (``None`` for the one-shot functions)."""
    mesh = ref_par.make_mesh(RANKS)
    name, kw = case["solve"], case["kw"]
    if name.startswith("dist_"):
        return np.asarray(getattr(ref_par, name)(_ref(a), b, mesh, **kw)), None
    plan = getattr(ref_par, name)(_ref(a), mesh, **kw)
    return np.asarray(plan(b)), getattr(plan, "_sv", plan)


@pytest.mark.parametrize("cid", [c[0] for c in SOLVES])
def test_dist_solve_matches_reference(group, cid):
    mats, outs, infos = group
    case = CASE[cid]
    a = mats[case["matrix"]]
    _same_on_every_rank(outs, infos, cid)
    b = _solve_b(cid, a)
    tol = TOL[a.dtype.type]
    got = outs[0][cid]
    golden = sptrsv_golden if b.ndim == 1 else sptrsm_golden
    assert rel_err(got, golden(a, b, **case["kw"])) < tol
    want, ref_plan = _ref_solve(case, a, b)
    assert rel_err(got, want) < tol
    if ref_plan is not None:
        assert (infos[0][cid]["nlevels"], infos[0][cid]["nbatches"]) == \
            (ref_plan.nlevels, ref_plan.nbatches)
        assert ref_plan.nbatches > 1


def test_dist_sptrsm_column_agrees_with_one_rhs(group):
    # tests/test_parallel.py:233-245: column 0 of the K-column solve
    # against the one-column solve of B[:, 0]
    _, outs, _ = group
    np.testing.assert_allclose(outs[0]["sptrsm"][:, 0],
                               outs[0]["sptrsv-sm-col0"], rtol=1e-5,
                               atol=1e-6)


def test_dist_sptrsv_batching_reduces_collectives(group):
    # the level batching fuses the Cholesky factor's levels into few
    # exchanges (tests/test_parallel.py:141-154), each rank's batches on
    # the sync-free kernel
    _, _, infos = group
    info = infos[0]["sptrsv-chol"]
    assert info["nbatches"] < info["nlevels"] / 4
    assert info["route"][0] == "syncfree"
