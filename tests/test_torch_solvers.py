"""The port's Krylov solvers against the JAX package's, on the same inputs.

``sblas_torch.solvers`` (a Python loop over torch tensors, ``device="cpu"``:
the kernels' plain versions) against ``sblas.solvers`` (one jitted
``lax.while_loop``), both in f64 (conftest turns on ``jax_enable_x64``) and
in f32, at the sizes of ``tests/test_solvers.py``. Matrices are built with
the port's generators and handed to the reference as its own CSR of the
same arrays; ``b`` comes from ``np.random.default_rng``. Checks: the same
iteration count (within one for CG and BiCGSTAB, whose convergence test
reads a residual rounded another way; the same number of restart cycles
for GMRES), both reported residuals under ``tol``, and in f64 at ``tol =
1e-10`` solutions within 1e-6 of each other. The host factorizations (the
port's C++ and its numpy copies) are held to the reference's bit for bit.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sblas.formats as ref_formats
from sblas import native as ref_native
from sblas import solvers as ref
from sblas_torch import datasets, native, solvers
from sblas_torch.formats import CSR, tril
from sblas_torch.golden import rel_err
from sblas_torch.ops.spmv import SpmvPlan

TOL = {np.float64: 1e-10, np.float32: 1e-5}
# f32 BiCGSTAB on the badly scaled matrix converges unevenly, and the two
# loops' roundings part by a few iterations at 1e-5: held at the tolerance
# tests/test_solvers.py gives it (1e-4)
F32_TOL = {"bicgstab+jacobi": 1e-4}


def _ref(a):
    """The reference's CSR holding the same arrays."""
    return ref_formats.CSR(a.shape, a.indptr, a.indices, a.data)


def _badly_scaled_spd(n, seed, dtype):
    """``tests/test_solvers.py``'s SPD matrix with a wide-range diagonal,
    ``D^1/2 A D^1/2``, built in f64 and cast to ``dtype``."""
    a = datasets.poisson2d(int(np.sqrt(n)), dtype=np.float64)
    d = np.exp(np.random.default_rng(seed).uniform(-3, 3, a.shape[0]))
    dm = sp.diags(np.sqrt(d))
    return CSR.from_scipy((dm @ a.to_scipy() @ dm).tocsr()).astype(dtype)


MATRICES = {
    "poisson2d(24)": lambda dt: datasets.poisson2d(24, dtype=dt),
    "poisson2d(32)": lambda dt: datasets.poisson2d(32, dtype=dt),
    "poisson2d(48)": lambda dt: datasets.poisson2d(48, dtype=dt),
    "badly_scaled(900)": lambda dt: _badly_scaled_spd(900, 7, dt),
    "badly_scaled(1600)": lambda dt: _badly_scaled_spd(1600, 0, dt),
    "convection(12)": lambda dt: datasets.convection_diffusion(
        12, 0.05, dtype=dt),
    "convection(24)": lambda dt: datasets.convection_diffusion(
        24, 0.05, dtype=dt),
    "convection(32)": lambda dt: datasets.convection_diffusion(32,
                                                               dtype=dt),
}

# (solver, preconditioner, matrix, keywords)
CASES = {
    "cg": ("cg", None, "poisson2d(32)", {}),
    "cg+jacobi": ("cg", "jacobi", "badly_scaled(1600)", {}),
    "cg+ichol": ("cg", "ichol", "poisson2d(48)", {}),
    "cg+ichol(trsv_sweeps=3)": ("cg", "ichol3", "poisson2d(24)", {}),
    "bicgstab+jacobi": ("bicgstab", "jacobi", "badly_scaled(900)", {}),
    "bicgstab+ilu": ("bicgstab", "ilu", "convection(24)", {}),
    "gmres(10)": ("gmres", None, "convection(12)", {"restart": 10}),
    "gmres(30)": ("gmres", None, "convection(24)", {"restart": 30}),
    "gmres(10)+ilu": ("gmres", "ilu", "convection(32)", {"restart": 10}),
    "gmres(30)+ilu": ("gmres", "ilu", "convection(32)", {"restart": 30}),
}


def _preconditioners(kind, a):
    if kind is None:
        return None, None
    if kind == "jacobi":
        return ref.jacobi(_ref(a)), solvers.jacobi(a, device="cpu")
    if kind == "ichol":
        return ref.ichol(_ref(a)), solvers.ichol(a, device="cpu")
    if kind == "ichol3":
        return (ref.ichol(_ref(a), trsv_sweeps=3),
                solvers.ichol(a, trsv_sweeps=3, device="cpu"))
    return ref.ilu(_ref(a)), solvers.ilu(a, device="cpu")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", list(CASES))
def test_solver_vs_reference(case, dtype):
    solver, kind, mat, kw = CASES[case]
    a = MATRICES[mat](dtype)
    b = np.random.default_rng(13).standard_normal(a.shape[0]).astype(dtype)
    tol = F32_TOL.get(case, TOL[dtype]) if dtype == np.float32 \
        else TOL[dtype]
    ref_m, port_m = _preconditioners(kind, a)
    xr, ir = getattr(ref, solver)(_ref(a), b, tol=tol, maxiter=3000,
                                  M=ref_m, **kw)
    xp, ip = getattr(solvers, solver)(a, b, tol=tol, maxiter=3000, M=port_m,
                                      device="cpu", **kw)
    assert isinstance(xp, torch.Tensor) and xp.dtype == torch.from_numpy(
        b).dtype
    assert ir["rel_residual"] < tol and ip["rel_residual"] < tol
    if solver == "gmres":
        assert ip["iterations"] == ir["iterations"]
        assert ip["iterations"] % kw["restart"] == 0
    else:
        assert abs(ip["iterations"] - ir["iterations"]) <= 1
    true = np.linalg.norm(b - a.to_scipy() @ xp.numpy().astype(np.float64)) \
        / np.linalg.norm(b)
    if dtype == np.float64:
        assert rel_err(xp.numpy(), np.asarray(xr)) < 1e-6
        assert true < 2 * tol
    else:
        assert rel_err(xp.numpy(), np.asarray(xr)) < 1e-3


def test_solvers_accept_a_plan_a_csc_and_x0():
    a = datasets.poisson2d(24, dtype=np.float64)
    b = np.random.default_rng(3).standard_normal(a.shape[0])
    plan = SpmvPlan(a, "ell", device="cpu")
    x1, info1 = solvers.cg(plan, b, tol=1e-10)
    assert plan.method == "ell" and info1["rel_residual"] < 1e-10
    # warm start from the solution: converges at once
    _, info2 = solvers.cg(plan, b, tol=1e-10, x0=x1)
    assert info2["iterations"] <= 1
    x3, _ = solvers.bicgstab(a.tocsc(), b, tol=1e-10, device="cpu")
    x4, _ = solvers.gmres(a, b.astype(np.float32), tol=1e-10, device="cpu")
    assert x4.dtype == torch.float64           # cast to the plan's dtype
    # residuals of 1e-10 on a matrix of condition ~300
    assert rel_err(x3.numpy(), x1.numpy()) < 1e-6
    assert rel_err(x4.numpy(), x1.numpy()) < 1e-6


@pytest.mark.parametrize("solver", ["cg", "bicgstab", "gmres"])
def test_solvers_reject_rectangular(solver):
    a = datasets.random_csr(10, 20, 3, seed=4, dtype=np.float64)
    with pytest.raises(ValueError, match="square"):
        getattr(solvers, solver)(a, np.zeros(10), device="cpu")
    with pytest.raises(ValueError, match="square"):
        getattr(ref, solver)(_ref(a), np.zeros(10))


@pytest.mark.parametrize("entry", ["cg", "jacobi", "ichol", "ilu"])
def test_solvers_default_to_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("there is a card here")
    a = datasets.poisson2d(8, dtype=np.float64)
    args = (a, np.ones(64)) if entry == "cg" else (a,)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(solvers, entry)(*args)


def test_ichol_and_ilu_apply_the_syncfree_solves():
    a = datasets.poisson2d(16, dtype=np.float64)
    m = solvers.ichol(a, device="cpu")
    assert m.fwd.method == m.bwd.method == "syncfree"
    assert (m.fwd.lower, m.bwd.lower) == (True, False)
    c = datasets.convection_diffusion(16, dtype=np.float32)
    u = solvers.ilu(c, device="cpu")
    assert u.fwd.method == u.bwd.method == "syncfree"
    assert u.fwd.unit_diagonal and not u.bwd.unit_diagonal
    j = solvers.ichol(a, trsv_sweeps=2, device="cpu")
    assert j.fwd.method.startswith("jacobi+") and j.fwd.sweeps == 2
    # the reference's apply and the port's agree on the same r
    r = np.random.default_rng(4).standard_normal(256)
    for (arrs, apply), port in ((ref.ichol(_ref(a)), m),
                                (ref.ilu(_ref(c.astype(np.float64))),
                                 solvers.ilu(c.astype(np.float64),
                                             device="cpu"))):
        z = port(torch.from_numpy(r)).numpy()
        assert rel_err(z, np.asarray(apply(arrs, r))) < 1e-12


# the host factorizations -------------------------------------------------

FACTOR_MATRICES = {
    "spd_diag_dominant(400)": lambda: datasets.spd_diag_dominant(
        400, 6, seed=11, dtype=np.float64),
    "poisson2d(30)": lambda: datasets.poisson2d(30, dtype=np.float64),
    "convection(20)": lambda: datasets.convection_diffusion(
        20, dtype=np.float64),
}


@pytest.mark.parametrize("name", list(FACTOR_MATRICES))
def test_ic0_host_library_matches_the_reference(name):
    a = FACTOR_MATRICES[name]()
    lo = tril(a)
    port, theirs, plain = (lo.data.astype(np.float64).copy()
                           for _ in range(3))
    rc = native.ic0_inplace(lo.indptr, lo.indices, port)
    rc_ref = ref_native.ic0_inplace(lo.indptr, lo.indices, theirs)
    rc_plain = solvers._ic0_numpy(lo.indptr, lo.indices, plain)
    assert rc == rc_ref == rc_plain
    np.testing.assert_array_equal(port, theirs)
    np.testing.assert_allclose(port, plain, rtol=1e-13, atol=0)


@pytest.mark.parametrize("name", list(FACTOR_MATRICES))
def test_ilu0_host_library_matches_the_reference(name):
    a = FACTOR_MATRICES[name]()
    port, theirs, plain = (a.data.astype(np.float64).copy()
                           for _ in range(3))
    rc = native.ilu0_inplace(a.indptr, a.indices, port)
    rc_ref = ref_native.ilu0_inplace(a.indptr, a.indices, theirs)
    rc_plain = solvers._ilu0_numpy(a.indptr, a.indices, plain)
    assert rc == rc_ref == rc_plain == 0
    np.testing.assert_array_equal(port, theirs)
    np.testing.assert_allclose(port, plain, rtol=1e-13, atol=0)


def test_factor_breakdowns_report_the_row():
    # [[1, 2], [2, 1]] is indefinite: IC(0) breaks down at row 1
    lo = CSR((2, 2), np.array([0, 1, 3]), np.array([0, 0, 1]),
             np.array([1.0, 2.0, 1.0]))
    v1, v2 = lo.data.copy(), lo.data.copy()
    assert native.ic0_inplace(lo.indptr, lo.indices, v1) == \
        ref_native.ic0_inplace(lo.indptr, lo.indices, v2) == 2
    # [[1, 1], [1, 1]]: ILU(0)'s pivot of row 1 is zero
    a = CSR.from_scipy(sp.csr_matrix(np.ones((2, 2))))
    v1, v2 = a.data.copy(), a.data.copy()
    assert native.ilu0_inplace(a.indptr, a.indices, v1) == \
        ref_native.ilu0_inplace(a.indptr, a.indices, v2) == 2
    with pytest.raises(ValueError, match="f64"):
        native.ic0_inplace(lo.indptr, lo.indices, lo.data.astype(np.float32))


def test_host_library_is_keyed_on_the_host_cpu(tmp_path, monkeypatch):
    # -march=native builds for the CPU it runs on: a library built on
    # another host (a copied build/) must not be the one loaded here
    src = tmp_path / "factor.cpp"
    src.write_text("int x;\n")
    tag = native.host_tag()
    assert "-march=" in tag
    here = native.library_path([src], tmp_path)
    # the loaded library is the one keyed on this host
    assert native.build() == native.library_path()
    paths = {}
    for name, other in (("another", tag.replace("-march=", "-march=another-", 1)),
                        ("cpu a", "cpu a"), ("cpu b", "cpu b")):
        monkeypatch.setattr(native, "host_tag", lambda other=other: other)
        paths[name] = native.library_path([src], tmp_path)
    assert paths["another"] != here and paths["another"].parent == here.parent
    assert paths["cpu a"] != paths["cpu b"]
    monkeypatch.setattr(native, "host_tag", lambda: tag)
    assert native.library_path([src], tmp_path) == here


def test_shift_rescue_and_errors_match_the_reference():
    # [[1, 1], [1, 1]]: both break down unshifted (a zero pivot) and are
    # rescued by the doubling shift
    ones = CSR.from_scipy(sp.csr_matrix(np.ones((2, 2))))
    r = np.ones(2)
    for build_ref, build_port, a in ((ref.ilu, solvers.ilu, ones),
                                     (ref.ichol, solvers.ichol, ones)):
        arrs, apply = build_ref(_ref(a))
        z_ref = np.asarray(apply(arrs, r))
        z = build_port(a, device="cpu")(torch.from_numpy(r)).numpy()
        assert np.isfinite(z).all()
        np.testing.assert_allclose(z, z_ref, rtol=1e-12)
    # no full diagonal: both refuse, and ILU refuses a rectangle
    nd = CSR.from_scipy(sp.csr_matrix(np.array([[1.0, 1.0], [1.0, 0.0]])))
    for build_ref, build_port in ((ref.ilu, solvers.ilu),
                                  (ref.ichol, solvers.ichol)):
        with pytest.raises(ValueError, match="diagonal"):
            build_port(nd, device="cpu")
        with pytest.raises(ValueError, match="diagonal"):
            build_ref(_ref(nd))
    rect = datasets.random_csr(8, 6, 2, seed=0)
    with pytest.raises(ValueError, match="square"):
        solvers.ilu(rect, device="cpu")
    with pytest.raises(ValueError, match="square"):
        ref.ilu(_ref(rect))
    # a breakdown the shifts cannot rescue: both give up alike
    bad = CSR.from_scipy(sp.csr_matrix(np.array([[-1.0, 0.0],
                                                 [0.0, -1.0]])))
    with pytest.raises(ValueError, match="breakdown"):
        solvers.ichol(bad, max_shift_tries=2, device="cpu")
    with pytest.raises(ValueError, match="breakdown"):
        ref.ichol(_ref(bad), max_shift_tries=2)
