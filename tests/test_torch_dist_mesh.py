"""The port's 2D and hierarchical plans against the JAX package's, on the
same inputs.

As ``tests/test_torch_dist.py``: the port runs every case once, in a
``gloo`` group of 8 CPU ranks (``device="cpu"``), the reference here on
conftest's 8 CPU devices with ``local_method="ell"`` where it takes one.
``Dist2DSpmvPlan`` and ``Dist2DSpmmPlan`` (K = 8) run on 2 x 4 and 4 x 2
(``rows`` x ``cols``) meshes, ``HierSpmvPlan`` and ``HierSpmmPlan`` on a 2
x 4 (``hosts`` x ``chips``) mesh under both strategies. Checks: every rank
returned the same bits; scipy and the reference within ``default_tol``;
the hierarchical plans under ``nnz_balanced`` with the ``csr`` or
``merge`` local, where no row is split, the same bits as the port's
single-device plan. The 2D plans add each row in ``C`` partial sums (one a
column chunk), and ``nnz_split`` cuts rows, so those hold to
``default_tol``.
"""

import numpy as np
import pytest

import sblas.formats as ref_formats
import sblas.parallel as ref_par
from sblas_torch import datasets
from sblas_torch.golden import default_tol, rel_err, spmm_golden, spmv_golden
from sblas_torch.ops.spmm import SpmmPlan
from sblas_torch.ops.spmv import SpmvPlan
from sblas_torch.parallel.launch import run_group, save_matrix

RANKS = 8
K = 8
MATRICES = {
    "rand": lambda: datasets.random_csr(300, 280, 7, seed=2),
    "skew": lambda: datasets.random_csr(400, 400, 12, skew=1.2, seed=3),
}


def _cases():
    cases = []
    for grid in ((2, 4), (4, 2)):
        g = f"{grid[0]}x{grid[1]}"
        for plan, k in (("Dist2DSpmvPlan", None), ("Dist2DSpmmPlan", K)):
            for name in MATRICES:
                cases.append({"id": f"{plan}-{g}-{name}", "plan": plan,
                              "matrix": name, "k": k, "mesh": ["2d", *grid],
                              "kw": {}})
        cases.append({"id": f"Dist2DSpmvPlan-{g}-rand-csr",
                      "plan": "Dist2DSpmvPlan", "matrix": "rand", "k": None,
                      "mesh": ["2d", *grid], "kw": {"local_method": "csr"}})
    for strategy in ("nnz_balanced", "nnz_split"):
        for plan, k, local in (("HierSpmvPlan", None, "csr"),
                               ("HierSpmmPlan", K, "merge")):
            for name in MATRICES:
                cases.append({"id": f"{plan}-{strategy}-{name}",
                              "plan": plan, "matrix": name, "k": k,
                              "mesh": ["hier", 2, 4],
                              "kw": {"strategy": strategy,
                                     "local_method": local}})
    return cases


CASES = _cases()
CASE = {c["id"]: c for c in CASES}


def _inputs(case, a):
    rng = np.random.default_rng(len(case["id"]))
    m, n = a.shape
    tail = () if case["k"] is None else (case["k"],)
    return (rng.standard_normal((n, *tail)).astype(a.dtype),
            rng.standard_normal((m, *tail)).astype(a.dtype), 2.5, -0.5)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Every case run once on 8 gloo CPU ranks: the matrices, and each
    rank's outputs and reports."""
    mats = {name: make() for name, make in MATRICES.items()}
    arrays, cases = {}, []
    for name, a in mats.items():
        save_matrix(arrays, name, a)
    for c in CASES:
        x, y, alpha, beta = _inputs(c, mats[c["matrix"]])
        arrays[f"x_{c['id']}"], arrays[f"y_{c['id']}"] = x, y
        cases.append({**c, "x": f"x_{c['id']}", "y": f"y_{c['id']}",
                      "alpha": alpha, "beta": beta})
    return (mats, *run_group(tmp_path_factory.mktemp("dist_mesh"), RANKS,
                             cases, arrays))


def _reference(case, a):
    ref_a = ref_formats.CSR(a.shape, a.indptr, a.indices, a.data)
    kind, *sizes = case["mesh"]
    if kind == "2d":
        return ref_par.Dist2DSpmvPlan(ref_a, ref_par.make_mesh2d(*sizes),
                                      local_method="ell") \
            if case["k"] is None else ref_par.Dist2DSpmmPlan(
                ref_a, ref_par.make_mesh2d(*sizes), local_method="ell")
    mesh = ref_par.make_mesh_hier(*sizes)
    strategy = case["kw"]["strategy"]
    if case["k"] is None:
        return ref_par.HierSpmvPlan(ref_a, mesh, strategy=strategy,
                                    local_method="ell")
    return ref_par.HierSpmmPlan(ref_a, mesh, strategy=strategy)


@pytest.mark.parametrize("cid", [c["id"] for c in CASES])
def test_mesh_plan_matches_reference(group, cid):
    mats, outs, infos = group
    case = CASE[cid]
    a = mats[case["matrix"]]
    for r in range(1, RANKS):
        assert infos[r][cid]["routes"] == infos[0][cid]["routes"], r
        assert outs[r][cid].tobytes() == outs[0][cid].tobytes(), r
    x, y, alpha, beta = _inputs(case, a)
    got = outs[0][cid]
    golden = spmv_golden if case["k"] is None else spmm_golden
    tol = default_tol(a.dtype)
    assert rel_err(got, golden(a, x, alpha, beta, y)) < tol
    want = np.asarray(_reference(case, a)(x, alpha, beta, y))
    assert rel_err(got, want) < tol
    if case["kw"].get("strategy") == "nnz_balanced":
        local = case["kw"]["local_method"]
        plan = SpmvPlan(a, local, device="cpu") if case["k"] is None \
            else SpmmPlan(a, local, k_hint=K, device="cpu")
        np.testing.assert_array_equal(got, plan(x, alpha, beta, y).numpy())
