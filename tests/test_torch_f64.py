"""The f64 slice: the port's ``pallas_ds`` routes and its f64 ``auto`` against
the JAX package's double-single routes, its XLA f64 routes and scipy.

The JAX package's ``pallas_ds`` (``spmv_wsell_ds.py:_kernel_ds`` and the
solves of ``sptrsv_ds.py`` built on it) runs in interpret mode on the CPU,
as its own tests run it, with numpy f64 at its boundary; conftest turns on
``jax_enable_x64``, so its XLA routes compute in true f64. The port runs
with ``device="cpu"``: the f64 builds' plain torch versions. Inputs come
from ``np.random.default_rng``. Tolerances:

- port against scipy: 1e-13 for SpMV and SpMM (the reference's ds class),
  1e-12 on values spread over 28 decades (as ``tests/test_spmv_ds.py:53``
  holds the reference);
- port against the reference's ds route: 1e-12;
- solves: ``SOLVE_TOL[f64]`` = 1e-10, against the reference and scipy.
"""

import ctypes
import functools

import numpy as np
import pytest
import torch

from sblas import datasets
from sblas.formats import COO, csr_transpose
from sblas.golden import (rel_err, spmm_golden, spmv_golden, sptrsm_golden,
                          sptrsv_golden)
from sblas.ops.spmm import SpmmPlan as RefSpmmPlan
from sblas.ops.spmv import SpmvPlan as RefSpmvPlan
from sblas.ops.spmv import spmv as ref_spmv
from sblas.ops.sptrsm import sptrsm as ref_sptrsm
from sblas.ops.sptrsv import sptrsv as ref_sptrsv
from sblas_torch import (CSR, SpmmPlan, SpmvPlan, SptrsmPlan, SptrsvPlan,
                         spmm, spmv, sptrsm, sptrsv)
from sblas_torch.bench_lib import SOLVE_TOL
from sblas_torch.formats import from_reference, to_device
from sblas_torch.ops.kernels import spmm_csr as ckern
from sblas_torch.ops.kernels import spmv_csr as kern
from sblas_torch.ops.kernels import sptrsv_csr as skern
from sblas_torch.ops.spmm import X_GATHER_ROWS
from sblas_torch.ops.spmv import csr_bytes_per_iter, f32_rule
from sblas_torch.ops.sptrsv import syncfree_bytes
from sblas_torch.utils.timing import FP32_FLOPS, FP64_FLOPS, peak_flops

F64 = np.float64
SCIPY_TOL = 1e-13
DS_TOL = 1e-12
STOL = SOLVE_TOL[np.dtype(F64)]


def _rng(seed):
    return np.random.default_rng(seed)


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@functools.lru_cache(maxsize=None)
def _cant_ds():
    """cant at 5%, f64, with x, y and the reference's ds answer to
    ``A x / 3 - y / 2`` (its interpret-mode kernel runs once per file)."""
    a = datasets.emulate("cant", scale=0.05, dtype=F64)
    rng = _rng(0)
    x, y0 = rng.standard_normal(a.shape[1]), rng.standard_normal(a.shape[0])
    ref = RefSpmvPlan(a, "pallas_ds")(x, 1 / 3, -0.5, y0)
    return a, x, y0, ref


# SpMV -------------------------------------------------------------------

@pytest.mark.parametrize("method", ["pallas_ds", "auto"])
def test_pallas_ds_spmv_vs_reference(method):
    a, x, y0, ref = _cant_ds()
    plan = SpmvPlan(from_reference(a), method, device="cpu")
    assert plan.method == "csr" and plan.dtype == torch.float64
    assert method in plan.route_reason
    got = _np(plan(x, 1 / 3, -0.5, y0))
    assert got.dtype == F64 and np.asarray(ref).dtype == F64
    golden = spmv_golden(a, x, 1 / 3, -0.5, y0)
    assert rel_err(got, golden) < SCIPY_TOL
    assert rel_err(got, ref) < DS_TOL
    assert rel_err(ref, golden) < DS_TOL


def test_pallas_ds_spmv_trans_vs_reference():
    a = datasets.emulate("cant", scale=0.03, dtype=F64)
    x = _rng(1).standard_normal(a.shape[0])
    got = _np(spmv(from_reference(a), x, trans=True, method="pallas_ds",
                   device="cpu"))
    ref = ref_spmv(a, x, trans=True, method="pallas_ds")
    golden = spmv_golden(csr_transpose(a), x)
    assert rel_err(got, golden) < SCIPY_TOL
    assert rel_err(got, ref) < DS_TOL


def test_pallas_ds_spmv_wide_dynamic_range():
    # 28 decades of value magnitude: the reference's lo plane carries the
    # small entries, the port's f64 carries them whole
    a = datasets.emulate("cant", scale=0.03, dtype=F64)
    rng = _rng(2)
    data = a.data * np.exp(rng.uniform(-14, 14, a.nnz))
    a = type(a)(a.shape, a.indptr, a.indices, data)
    x = rng.standard_normal(a.shape[1])
    got = _np(spmv(from_reference(a), x, method="pallas_ds", device="cpu"))
    ref = RefSpmvPlan(a, "pallas_ds")(x)
    golden = spmv_golden(a, x)
    assert rel_err(got, golden) < DS_TOL
    assert rel_err(got, ref) < DS_TOL


def test_pallas_ds_spmv_scattered_matrix():
    # the reference refuses a matrix whose w-SELL fill is below 0.2 (a VMEM
    # limit); the port takes it
    a = datasets.random_csr(700, 650, 9, seed=3, dtype=F64)
    with pytest.raises(ValueError, match="fill"):
        RefSpmvPlan(a, "pallas_ds")
    x, y0 = _rng(3).standard_normal(650), _rng(4).standard_normal(700)
    for method in ("pallas_ds", "auto", "csr"):
        got = _np(spmv(from_reference(a), x, 1 / 3, -0.5, y0, method=method,
                       device="cpu"))
        assert rel_err(got, spmv_golden(a, x, 1 / 3, -0.5, y0)) < SCIPY_TOL


def test_f64_rcm_route():
    base = datasets.random_csr(600, 600, 12, bandwidth=30, seed=21,
                               dtype=F64)
    p = _rng(22).permutation(600)
    s = base.to_scipy().tocsr()[p][:, p].tocsr()
    a = from_reference(type(base).from_scipy(s))
    x, y0 = _rng(5).standard_normal(600), _rng(6).standard_normal(600)
    plan = SpmvPlan(a, "rcm", device="cpu")
    got = _np(plan(x, 1 / 3, -0.5, y0))
    assert got.dtype == F64
    assert rel_err(got, spmv_golden(a, x, 1 / 3, -0.5, y0)) < SCIPY_TOL


@pytest.mark.parametrize("entry", ["SpmvPlan", "SpmmPlan", "SptrsvPlan",
                                   "sptrsm"])
def test_pallas_ds_rejects_f32(entry):
    r = datasets.lower_triangular(40, 3, seed=1) if "trs" in entry.lower() \
        else datasets.random_csr(40, 40, 3, seed=1)
    p = from_reference(r)
    call = {"SpmvPlan": lambda: SpmvPlan(p, "pallas_ds", device="cpu"),
            "SpmmPlan": lambda: SpmmPlan(p, "pallas_ds", device="cpu"),
            "SptrsvPlan": lambda: SptrsvPlan(p, method="pallas_ds",
                                             device="cpu"),
            "sptrsm": lambda: sptrsm(p, np.ones((40, 2), np.float32),
                                     method="pallas_ds", device="cpu")}
    with pytest.raises(ValueError, match="f64 path"):
        call[entry]()


def test_f64_entry_point_passes_alpha_and_beta_as_doubles():
    # a c_float argtype would round alpha = 1/3 to f32 on the card without
    # an error; the f32 builds keep c_float
    for dtype, (symbol, argtypes) in kern._SYMBOLS.items():
        want = ctypes.c_double if dtype == torch.float64 else ctypes.c_float
        assert argtypes[7] is want and argtypes[8] is want, symbol
    assert kern._SYMBOLS[torch.float64][0] == "sblas_spmv_csr_f64"
    assert skern._SYMBOLS[torch.float64][0] == "sblas_sptrsv_csr_f64"
    # and the plain version keeps every bit of alpha and beta
    n = 16
    eye = CSR((n, n), np.arange(n + 1), np.arange(n), np.ones(n))
    plan = SpmvPlan(eye, "pallas_ds", device="cpu")
    one = np.ones(n)
    assert (_np(plan(one, 1 / 3)) == 1 / 3).all()
    assert (_np(plan(one, 0.0, 1 / 7, one)) == 1 / 7).all()


def test_f64_wrapper_checks_vectors_against_the_operand():
    a = from_reference(datasets.random_csr(20, 30, 3, seed=1, dtype=F64))
    op = kern.prepare(to_device(a, "cpu"))
    assert kern.vector_dtype(op["data"].dtype) == torch.float64
    with pytest.raises(ValueError, match="x must be f64"):
        kern.spmv_csr(op, torch.ones(30))
    with pytest.raises(ValueError, match="y must be f64"):
        kern.spmv_csr(op, torch.ones(30, dtype=torch.float64), 1.0, 1.0,
                      torch.ones(20))
    before = kern.LAUNCHES, kern.LAUNCHES_F64
    out = kern.spmv_csr(op, torch.ones(30, dtype=torch.float64))
    assert out.dtype == torch.float64
    # on CPU tensors the wrapper runs the plain version: no launch counted
    assert (kern.LAUNCHES, kern.LAUNCHES_F64) == before


@functools.lru_cache(maxsize=None)
def _graph64():
    """A power-law graph in f64 (longest row ~1,000 nonzeros), with x, y
    and the reference's XLA f64 bucket route's answer to A x / 3 - y / 2."""
    a = datasets.powerlaw_graph(6000, 14, seed=5, dtype=F64)
    rng = _rng(40)
    x, y0 = rng.standard_normal(a.shape[1]), rng.standard_normal(a.shape[0])
    ref = np.asarray(RefSpmvPlan(a, "bucket")(x, 1 / 3, -0.5, y0))
    return a, x, y0, ref


@pytest.mark.parametrize("method", ["merge", "auto"])
def test_f64_merge_spmv_vs_reference_bucket(method):
    # the nnz-balanced kernel's f64 build (its plain version here), and the
    # kernel's own partition emulated in f64, against the reference's f64
    # bucket route and scipy
    a, x, y0, ref = _graph64()
    p = from_reference(a)
    plan = SpmvPlan(p, method, device="cpu")
    assert plan.method == "merge" and plan.dtype == torch.float64
    got = _np(plan(x, 1 / 3, -0.5, y0))
    assert got.dtype == F64
    golden = spmv_golden(a, x, 1 / 3, -0.5, y0)
    assert rel_err(got, golden) < SCIPY_TOL
    assert rel_err(got, ref) < SCIPY_TOL
    op = ckern.prepare(to_device(p, "cpu"))
    assert op["data"].dtype == torch.float64 and op["fix"].numel() > 0
    emu = ckern.spmm_csr_emulate(op, torch.from_numpy(x)[:, None], 1 / 3,
                                 -0.5, torch.from_numpy(y0)[:, None])
    assert emu.dtype == torch.float64
    assert rel_err(_np(emu)[:, 0], got) < 1e-13


def test_f64_merge_spmm_vs_reference_bucket():
    a, *_ = _graph64()
    rng = _rng(41)
    x = rng.standard_normal((a.shape[1], 8))
    y0 = rng.standard_normal((a.shape[0], 8))
    ref = np.asarray(RefSpmmPlan(a, "bucket")(x, 1 / 3, -0.5, y0))
    golden = spmm_golden(a, x, 1 / 3, -0.5, y0)
    p = from_reference(a)
    for method in ("merge", "auto"):
        plan = SpmmPlan(p, method, k_hint=8, device="cpu")
        assert plan.method == "merge"
        got = _np(plan(x, 1 / 3, -0.5, y0))
        assert got.dtype == F64
        assert rel_err(got, golden) < SCIPY_TOL
        assert rel_err(got, ref) < SCIPY_TOL
    op = ckern.prepare(to_device(p, "cpu"), 256)
    emu = ckern.spmm_csr_emulate(op, torch.from_numpy(x), 1 / 3, -0.5,
                                 torch.from_numpy(y0))
    assert rel_err(_np(emu), golden) < SCIPY_TOL


def test_f64_auto_takes_merge_on_a_graph_and_csr_on_fem():
    # the longest-row rule at 8-byte values and vectors, stated in the
    # reason: merge on the graph's long rows, the csr kernel's f64 build on
    # the FEM matrix
    g = from_reference(_graph64()[0])
    plan = SpmvPlan(g, device="cpu")
    pick, why = f32_rule(g, 8, 8)
    assert plan.method == pick == "merge"
    assert plan.route_reason.startswith("auto: float64 values, longest row")
    assert why in plan.route_reason and "-> merge" in plan.route_reason
    assert "no f64 build" not in plan.route_reason
    fem = from_reference(datasets.emulate("cant", scale=0.05, dtype=F64))
    plan = SpmvPlan(fem, device="cpu")
    assert plan.method == "csr" and "-> csr" in plan.route_reason
    # SpMM: merge priced against spmv_passes at 8 bytes, both in the reason
    mm = SpmmPlan(g, k_hint=8, device="cpu")
    prices = SpmmPlan.prices(g, 8, val_bytes=8, vec_bytes=8)
    assert mm.method == "merge" == min(("merge", "spmv_passes"),
                                       key=prices.get)
    assert f"merge {prices['merge'] / 1e6:.1f} MB" in mm.route_reason
    assert "block" not in mm.route_reason.split("->")[0]


def test_f64_merge_symbol_passes_alpha_and_beta_as_doubles():
    for dtype, (symbol, argtypes) in ckern._SYMBOLS.items():
        want = ctypes.c_double if dtype == torch.float64 else ctypes.c_float
        assert argtypes[15] is want and argtypes[16] is want, symbol
        assert argtypes.count(ctypes.c_float) + argtypes.count(
            ctypes.c_double) == 2
    assert ckern._SYMBOLS[torch.float64][0] == "sblas_spmm_csr_f64"
    # the plain version keeps every bit of alpha and beta, and counts no
    # launch of either build
    n = 16
    eye = CSR((n, n), np.arange(n + 1), np.arange(n), np.ones(n))
    op = ckern.prepare(to_device(eye, "cpu"))
    one = torch.ones((n, 1), dtype=torch.float64)
    before = (ckern.LAUNCHES, ckern.LAUNCHES_F64)
    assert (_np(ckern.spmm_csr(op, one, 1 / 3)) == 1 / 3).all()
    assert (_np(ckern.spmm_csr(op, one, 0.0, 1 / 7, one)) == 1 / 7).all()
    assert (ckern.LAUNCHES, ckern.LAUNCHES_F64) == before
    with pytest.raises(ValueError, match="X must be f64"):
        ckern.spmm_csr(op, one.float())


# SpMM -------------------------------------------------------------------

def test_pallas_ds_spmm_vs_reference():
    # a band of 300 rows, half-width 15 (the reference's ds SpMM in
    # interpret mode is slow-marked at 800 rows)
    a = datasets.banded(300, 15, seed=3, dtype=F64)
    rng = _rng(7)
    x, y0 = rng.standard_normal((300, 3)), rng.standard_normal((300, 3))
    ref = RefSpmmPlan(a, "pallas_ds")(x, 1 / 3, -0.5, y0)
    golden = spmm_golden(a, x, 1 / 3, -0.5, y0)
    p = from_reference(a)
    prices = SpmmPlan.prices(p, 3, val_bytes=8, vec_bytes=8)
    for method in ("pallas_ds", "auto"):
        plan = SpmmPlan(p, method, k_hint=3, device="cpu")
        if method == "pallas_ds":
            assert plan.method == "spmv_passes"
            assert plan._spmv.method == "csr"
        else:
            # the cheaper by the bytes model, on the kernels' f64 builds
            assert plan.method == min(("merge", "spmv_passes"),
                                      key=prices.get)
        got = _np(plan(x, 1 / 3, -0.5, y0))
        assert got.dtype == F64
        assert rel_err(got, golden) < SCIPY_TOL
        assert rel_err(got, ref) < DS_TOL
    got = _np(spmm(p, x[:, :2], trans=True, method="pallas_ds",
                   device="cpu"))
    assert rel_err(got, spmm_golden(csr_transpose(a), x[:, :2])) < SCIPY_TOL


# SpTRSV / SpTRSM ----------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3])
def test_pallas_ds_solve_vs_reference(k):
    # the reference's f32 wavefront + double-single refinement runs once,
    # on a tiny factor (it is slow-marked in interpret mode)
    r = datasets.lower_triangular(200, 4, bandwidth=20, seed=2, dtype=F64)
    b = _rng(8).standard_normal(200 if k == 1 else (200, k))
    p = from_reference(r)
    if k == 1:
        got = _np(sptrsv(p, b, method="pallas_ds", device="cpu"))
        ref = ref_sptrsv(r, b, method="pallas_ds")
    else:
        got = _np(sptrsm(p, b, method="pallas_ds", device="cpu"))
        ref = ref_sptrsm(r, b, method="pallas_ds")
    golden = sptrsm_golden(r, b)
    assert got.dtype == F64 and got.shape == golden.shape
    assert rel_err(got, golden) < STOL
    assert rel_err(got, ref) < STOL
    assert rel_err(np.asarray(ref), golden) < STOL


def _factor(gen):
    if gen == "band":
        return datasets.lower_triangular(300, 5, bandwidth=12, seed=2,
                                         dtype=F64)
    if gen == "random":
        return datasets.lower_triangular(300, 6, seed=3, dtype=F64)
    if gen == "chol-spd":
        a = datasets.spd_diag_dominant(150, 5, bandwidth=12, seed=4,
                                       dtype=F64)
        return datasets.cholesky_factor(a, dtype=F64)
    return datasets.cholesky_factor(datasets.poisson2d_nd(24, dtype=F64),
                                    dtype=F64)


def _unit(r):
    """``r`` with each row's strict part scaled to an absolute sum of 1/2 and
    a stored diagonal of 3, which a unit-diagonal solve must ignore."""
    coo = r.tocoo()
    strict = coo.col < coo.row
    sums = np.bincount(coo.row[strict], np.abs(coo.data[strict]),
                       minlength=r.shape[0])
    data = np.where(strict, coo.data / (2 * sums[coo.row] + 1e-30), 3.0)
    return COO(r.shape, coo.row, coo.col, data).tocsr()


@pytest.mark.parametrize("case", ["lower", "upper", "trans", "unit", "csc",
                                  "trans-csc"])
@pytest.mark.parametrize("gen", ["band", "random", "chol-spd",
                                 "chol-nd-poisson2d-24"])
def test_f64_solves_vs_tiles_and_scipy(gen, case):
    # auto and pallas_ds (the kernel's f64 build) against the reference's
    # f64 tiles route and scipy, K = 1 and K = 3. ``src`` is what the caller
    # passes, ``op`` the CSR of the operator solved, ``side`` its triangle
    r = _factor(gen)
    n = r.shape[0]
    kw = {"lower": True, "unit_diagonal": False, "trans": False}
    src, op, side = r, r, True
    if case == "upper":
        src = op = csr_transpose(r)
        kw["lower"] = side = False
    elif case == "trans":
        kw["trans"], op, side = True, csr_transpose(r), False
    elif case == "unit":
        src = op = _unit(r)
        kw["unit_diagonal"] = True
    elif case == "csc":
        src = r.tocsc()
    elif case == "trans-csc":
        src, op, side = r.tocsc(), csr_transpose(r), False
        kw["trans"] = True
    b = _rng(9).standard_normal(n)
    bm = _rng(10).standard_normal((n, 3))
    unit = kw["unit_diagonal"]
    want = sptrsv_golden(op, b, lower=side, unit_diagonal=unit)
    want_m = sptrsm_golden(op, bm, lower=side, unit_diagonal=unit)
    ref = ref_sptrsv(src, b, method="tiles", **kw)
    ref_m = ref_sptrsm(src, bm, method="tiles", **kw)
    for method in ("auto", "pallas_ds"):
        x = _np(sptrsv(from_reference(src), b, method=method, device="cpu",
                       **kw))
        xm = _np(sptrsm(from_reference(src), bm, method=method,
                        device="cpu", **kw))
        assert x.dtype == xm.dtype == F64
        for got, gold, rf in ((x, want, ref), (xm, want_m, ref_m)):
            assert rel_err(got, gold) < STOL
            assert rel_err(got, np.asarray(rf)) < STOL


def test_sptrsm_pallas_ds_takes_any_k_in_one_call():
    # the reference splits K into solves of 8 columns; the port's plan is
    # the sync-free one of the f64 build, all K at once
    r = _factor("chol-nd-poisson2d-24")
    p = from_reference(r)
    plan = SptrsmPlan(p, method="pallas_ds", device="cpu")
    assert plan.method == "syncfree" and plan.dtype == torch.float64
    b = _rng(11).standard_normal((r.shape[0], 17))
    got = _np(plan(b))
    assert rel_err(got, sptrsm_golden(r, b)) < STOL
    assert plan.bytes_per_iter(17) == syncfree_bytes(r.shape[0], r.nnz, 17,
                                                     8)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("lower", [True, False])
def test_f64_emulate_vs_plain(lower, k):
    # the kernel's order of work (exact f64 FMAs, lane sums, the shuffle
    # tree) against the plain version's f64 row sums
    r = _factor("random")
    a = from_reference(r if lower else csr_transpose(r))
    op = skern.prepare(a, "cpu", lower=lower)
    assert op["inv_diag"].dtype == torch.float64
    b = torch.from_numpy(_rng(12).standard_normal((a.shape[0], k)))
    emu = skern.sptrsv_csr_emulate(op, b)
    plain = skern.sptrsv_csr_reference(op, b)
    assert emu.dtype == plain.dtype == torch.float64
    assert rel_err(emu.numpy(), plain.numpy()) < 1e-14
    assert rel_err(plain.numpy(), sptrsm_golden(
        r if lower else csr_transpose(r), b.numpy(), lower=lower)) < STOL


def test_emulated_fma_rounds_once():
    # 1 + 2^-30 squared less 1: one rounding keeps the 2^-60, two lose it
    a = 1.0 + 2.0 ** -30
    assert skern._fma(a, a, -1.0, np.float64) == 2.0 ** -29 + 2.0 ** -60
    assert a * a - 1.0 == 2.0 ** -29


# the bytes and bounds models, counted by hand on a tiny matrix -----------

def _tiny(dtype):
    # [[2, 0, 1], [0, 3, 0], [4, 0, 5]]: 5 nonzeros, 3 rows
    return CSR((3, 3), np.array([0, 2, 3, 5]), np.array([0, 2, 1, 0, 2]),
               np.array([2.0, 1.0, 3.0, 4.0, 5.0], dtype))


def test_csr_bytes_model_counts_f64_by_hand():
    # values 8 B and columns 4 B a nonzero, indptr 4 B a row + 1, x and y
    # 8 B an entry
    a = _tiny(F64)
    hand = 5 * (8 + 4) + 4 * 4 + 3 * 8 + 3 * 8
    assert csr_bytes_per_iter(3, 3, 5, 8, 8) == hand
    assert SpmvPlan(a, device="cpu").bytes_per_iter == hand
    assert SpmvPlan(a, "pallas_ds", device="cpu").bytes_per_iter == hand
    assert SpmvPlan(_tiny(np.float32), device="cpu").bytes_per_iter == \
        5 * 8 + 4 * 4 + 3 * 4 + 3 * 4
    # spmv_passes at K = 2: the matrix twice, X in and Y out in f64
    plan = SpmmPlan(a, "pallas_ds", device="cpu")
    assert plan.method == "spmv_passes"
    assert plan.bytes_per_call(2) == 2 * (5 * 12 + 4 * 4) + (3 + 3) * 2 * 8
    assert SpmmPlan.prices(a, 2, val_bytes=8, vec_bytes=8)["spmv_passes"] \
        == 2 * hand
    # merge (auto's pick at k_hint = 8): the matrix once, X in and Y out;
    # the rule prices its X gather (5 nonzeros x 2 columns) at the rows
    # kernel's share, which K = 2 runs on rows this short
    plan = SpmmPlan(a, device="cpu")
    assert plan.method == "merge"
    assert plan.bytes_per_call(2) == 5 * 12 + 4 * 4 + (3 + 3) * 2 * 8
    assert SpmmPlan.prices(a, 2, val_bytes=8, vec_bytes=8)["merge"] == \
        5 * 12 + 4 * 4 + int(X_GATHER_ROWS * 5 * 2 * 8) + (3 + 3) * 2 * 8


def test_syncfree_bytes_model_counts_f64_by_hand():
    # lower triangle of the tiny matrix: [[2], [0, 3], [4, 0, 5]], 4 nnz
    l = CSR((3, 3), np.array([0, 1, 2, 4]), np.array([0, 1, 0, 2]),
            np.array([2.0, 3.0, 4.0, 5.0]))
    hand = 4 * (8 + 4) + 4 * 4 + 2 * 3 * 8 * 1 + 3 * 4
    assert syncfree_bytes(3, 4, 1, 8) == hand
    assert SptrsvPlan(l, device="cpu").bytes_per_iter == hand
    assert SptrsmPlan(l, device="cpu").bytes_per_iter(5) == \
        4 * 12 + 4 * 4 + 2 * 3 * 8 * 5 + 3 * 4
    x = _np(sptrsv(l, np.array([2.0, 3.0, 9.0]), device="cpu"))
    np.testing.assert_allclose(x, [1.0, 1.0, 1.0], rtol=0, atol=1e-15)


def test_bounds_take_the_fp64_rate_for_f64():
    assert FP64_FLOPS == 34e12 and FP32_FLOPS == 67e12
    assert peak_flops(torch.float64) == peak_flops(F64) == FP64_FLOPS
    for dt in (torch.float32, torch.bfloat16, np.float32):
        assert peak_flops(dt) == FP32_FLOPS
