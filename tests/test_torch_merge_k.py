"""The merge kernel at K > 1, emulated on the CPU by ``spmm_csr_emulate``,
against the JAX package's scattered SpMM kernels and scipy: the columns
kernel (``csrc/spmm_csr.cu``, ``spmm_merge_kernel``: each warp stages its
share once, lanes own columns of K, one pass over the CSR stream) in its
own order, and the rows kernel (``spmm_rows_kernel``: each lane walks a
run of the merged path with its sums of K columns in registers, the runs'
open rows meet in a segmented scan) that the rule gives small K, in f32,
bf16 and f64.

The reference's PSEG kernels (TPU kernels #3 ``_kernel_kres`` and #4
``_kernel``) and its w-SELL kernel (#8) run in interpret mode once each, at
K = 64; every K of the suite holds the emulation to the first K columns of
that product (each column of an SpMM is computed alone, so the first K
columns of the K = 64 product are the product with the first K columns of
X). Matrices come from the JAX package's generators and reach the port
through ``from_reference``; X and Y come from ``np.random.default_rng``.
Shares are cut small, so that rows run over several shares; the PSEG
matrices hold empty rows. Tolerances (``default_tol``): f32 2e-5, port
against reference and each against scipy; f64 1e-11 against the
reference's f64 bucket route and scipy.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sblas import datasets
from sblas.formats import CSR as RefCSR
from sblas.golden import rel_err, spmm_golden
from sblas.ops.kernels.spmm_pseg import PallasSpmmScattered
from sblas.ops.spmm import SpmmPlan as RefSpmm
from sblas_torch.formats import from_reference, to_device
from sblas_torch.golden import KERNEL_TOL, KERNEL_TOL_F64, value_tol
from sblas_torch.ops.kernels import spmm_csr as ckern
from test_spmm_kres import GEO, _powerlaw
from test_torch_scattered import (_empty_rows, _long_rows,  # noqa: F401
                                  reference_native)

KS = [2, 3, 8, 16, 32, 33, 64]
TOL = 2e-5
TOL_F64 = 1e-11


def _dense(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _np(y):
    return y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


# each route: its matrix, the share size the port's partition takes there
# (a row then runs over several shares), and the reference's product
ROUTES = {
    "pseg_kres": (lambda: RefCSR.from_scipy(
        _powerlaw(np.random.default_rng(0), 4500, 4500, 6000)), 4),
    "pseg_whole_x": (lambda: RefCSR.from_scipy(
        _powerlaw(np.random.default_rng(1), 1200, 2400, 6000)), 6),
    "pallas": (lambda: datasets.emulate("cant", scale=0.01,
                                        dtype=np.float32), 40),
}


@functools.lru_cache(maxsize=None)
def _reference(route):
    """``(a, x, product)``: the route's matrix, X of 64 columns and the
    reference's ``A @ X`` (interpret mode)."""
    a = ROUTES[route][0]()
    x = _dense((a.shape[1], 64), 70)
    if route == "pallas":
        plan = RefSpmm(a, "pallas", k_hint=64)
        assert plan.method == "pallas"
        return a, x, np.asarray(plan(x))
    ref = PallasSpmmScattered(a, hybrid=True, k_hint=64, th=64,
                              kres=route == "pseg_kres", kres_geo=GEO)
    assert ref._kres == (route == "pseg_kres")
    return a, x, np.asarray(ref.apply_pure(ref.device_arrays(),
                                           jnp.asarray(x)))


@pytest.mark.usefixtures("reference_native")
@pytest.mark.parametrize("design", ["cols", "rows"])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("route", list(ROUTES))
def test_emulated_kernels_vs_reference_scattered_kernels(route, k, design):
    a, x64, prod = _reference(route)
    op = ckern.prepare(to_device(from_reference(a), "cpu"), ROUTES[route][1])
    op = {**op, "design": design}
    assert ckern.rows_kernel(op, k) == (design == "rows")
    # rows longer than a share: at least one row is cut into 3+ shares
    starts = op["part"][:, 0].numpy()
    assert np.bincount(starts, minlength=a.shape[0] + 1).max() >= 3
    if route != "pallas":
        assert (a.row_lengths == 0).any()
    x = x64[:, :k]
    got = _np(ckern.spmm_csr_emulate(op, torch.from_numpy(x)))
    golden = spmm_golden(a, x)
    assert got.dtype == np.float32 and got.shape == golden.shape
    assert rel_err(got, prod[:, :k]) < TOL
    assert rel_err(got, golden) < TOL
    assert rel_err(prod[:, :k], golden) < TOL
    # alpha, beta and Y: the emulation against the plain version
    y = torch.from_numpy(_dense((a.shape[0], k), 71))
    args = (torch.from_numpy(x), 2.5, -0.5, y)
    assert rel_err(_np(ckern.spmm_csr_emulate(op, *args)),
                   _np(ckern.spmm_csr_reference(op, *args))) <= KERNEL_TOL


@functools.lru_cache(maxsize=None)
def _f64_case(name):
    if name == "long rows":
        a32 = _long_rows()
    else:
        a32 = datasets.powerlaw_graph(3000, 12, seed=5)
    a = RefCSR(a32.shape, a32.indptr, a32.indices,
               a32.data.astype(np.float64))
    x = np.random.default_rng(72).standard_normal((a.shape[1], 64))
    y = np.random.default_rng(73).standard_normal((a.shape[0], 64))
    return a, x, y, np.asarray(RefSpmm(a, "bucket")(x, 1 / 3, -0.5, y))


@pytest.mark.parametrize("design", ["cols", "rows"])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", ["long rows", "powerlaw"])
def test_emulated_steps_f64_vs_reference_bucket(name, k, design):
    # each f64 kernel's order (the design named), alpha = 1/3: the
    # reference's f64 route is its XLA bucket route (Mosaic has no f64)
    a, x64, y64, ref = _f64_case(name)
    base = ckern.prepare(to_device(from_reference(a), "cpu"),
                         None if name == "long rows" else 7)
    op = {**base, "design": design}
    assert op["data"].dtype == torch.float64
    # the rule: the f64 build's rows kernel to K = ROWS_MAX_K_F64 = 4
    # where rows hold at most ROWS_MEAN_F64 = 40 nonzeros on average (the
    # power-law graph's 12, the long rows' 35), then the columns kernel
    assert a.nnz <= ckern.ROWS_MEAN_F64 * a.shape[0]
    assert ckern.rows_kernel(base, k) == (k <= 4)
    if name == "long rows":
        # rows of 20,000+ nonzeros over 40+ shares: the warp-wide fix-up
        sh = ckern.shares(op, k)
        assert sh["unit"] == (ckern.UNIT if design == "rows"
                              else ckern.UNIT_COLS)
        assert (sh["fix"] - sh["fix_lo"]).max() > ckern.SHORT_FIX
        assert (a.row_lengths == 0).any()
    x, y = x64[:, :k], y64[:, :k]
    got = _np(ckern.spmm_csr_emulate(op, torch.from_numpy(x), 1 / 3, -0.5,
                                     torch.from_numpy(y)))
    assert got.dtype == np.float64
    assert rel_err(got, ref[:, :k]) < TOL_F64
    assert rel_err(got, spmm_golden(a, x, 1 / 3, -0.5, y)) < TOL_F64


@pytest.mark.parametrize("design", ["cols", "rows"])
@pytest.mark.parametrize("k", [2, 8, 32, 33, 64])
def test_emulated_kernels_on_long_rows_vs_reference_bucket(k, design):
    a = _long_rows()
    op = {**ckern.prepare(to_device(from_reference(a), "cpu")),
          "design": design}
    assert a.row_lengths.max() > 20 * ckern.UNIT
    x = _dense((a.shape[1], k), 74)
    y = _dense((a.shape[0], k), 75)
    got = _np(ckern.spmm_csr_emulate(op, torch.from_numpy(x), 1.5, 0.25,
                                     torch.from_numpy(y)))
    golden = spmm_golden(a, x, 1.5, 0.25, y)
    assert rel_err(got, RefSpmm(a, "bucket")(x, 1.5, 0.25, y)) < TOL
    assert rel_err(got, golden) < TOL
    empty = np.flatnonzero(a.row_lengths == 0)
    np.testing.assert_array_equal(got[empty], (0.25 * y)[empty])


# the rows kernel at K = 2 to 16: shares of only short rows, runs of empty
# rows, rows longer than a share
SMALL = {
    "banded(300,5)": lambda: datasets.banded(300, 5),
    "empty rows": _empty_rows,
    "long rows": _long_rows,
}
SMALL_KS = [2, 3, 5, 8, 13, 16]


@functools.lru_cache(maxsize=None)
def _small_case(name, vdt):
    """``(a, x, y, with_y, without_y)``: the matrix in ``vdt`` (f32 values
    for bf16), X and Y of 16 columns, and the reference's XLA bucket
    product ``1/3 A X - Y / 2`` and ``2.5 A X`` (None for bf16 values,
    which it has no route for)."""
    a = SMALL[name]()
    dt = np.float64 if vdt == "f64" else np.float32
    a = RefCSR(a.shape, a.indptr, a.indices, a.data.astype(dt))
    x, y = _dense((a.shape[1], 16), 77, dt), _dense((a.shape[0], 16), 78, dt)
    if vdt == "bf16":
        return a, x, y, None, None
    plan = RefSpmm(a, "bucket")
    return a, x, y, np.asarray(plan(x, 1 / 3, -0.5, y)), np.asarray(
        plan(x, 2.5))


@pytest.mark.parametrize("vdt", ["f32", "bf16", "f64"])
@pytest.mark.parametrize("k", SMALL_KS)
@pytest.mark.parametrize("name", list(SMALL))
def test_emulated_rows_kernel_at_small_k(name, k, vdt):
    a, x16, y16, ref_y, ref = _small_case(name, vdt)
    t = to_device(from_reference(a), "cpu",
                  torch.bfloat16 if vdt == "bf16" else None)
    x, y = torch.from_numpy(x16[:, :k]), torch.from_numpy(y16[:, :k])
    kt = KERNEL_TOL_F64 if vdt == "f64" else KERNEL_TOL
    st = {"f32": TOL, "bf16": value_tol(torch.bfloat16), "f64": TOL_F64}[vdt]
    # the rule's shares, and shares of 40 items (rows cut across shares);
    # the rows kernel by name (f64 past K = 4 takes the columns kernel by
    # the rule)
    for op in (ckern.prepare(t), ckern.prepare(t, 40)):
        op = {**op, "design": "rows"}
        for args, want in (((1 / 3, -0.5, y), ref_y), ((2.5, 0.0, None),
                                                        ref)):
            got = _np(ckern.spmm_csr_emulate(op, x, *args))
            assert got.dtype == x16.dtype
            assert rel_err(got, _np(ckern.spmm_csr_reference(op, x, *args))
                           ) <= kt
            yy = None if args[2] is None else y16[:, :k]
            assert rel_err(got, spmm_golden(a, x16[:, :k], args[0], args[1],
                                            yy)) < st
            if want is not None:
                assert rel_err(got, want[:, :k]) < st
            empty = np.flatnonzero(a.row_lengths == 0)
            want_empty = 0 if yy is None else (-0.5 * yy)[empty]
            np.testing.assert_array_equal(got[empty], want_empty)
    if name == "long rows":
        assert a.row_lengths.max() > ckern.UNIT


def _lane_runs_loop(op, sh, x, dt, fused):
    """The lanes' runs of the merged path and their segmented scan, one
    share, lane and item at a time, as ``spmv_merge_kernel`` (K = 1: the
    staged product rounded, then added) and ``spmm_rows_kernel`` (K > 1:
    one multiply-add, formed in f64 and rounded once) walk them: the loop
    ``ckern._emulate_lanes`` vectorises."""
    m, _ = op["shape"]
    part = sh["part"].numpy().astype(np.int64)
    indptr = op["indptr"].numpy().astype(np.int64)
    cols = op["indices"].numpy().astype(np.int64)
    vals = op["data"].to(x.dtype).numpy()
    xs = x.numpy()
    k = xs.shape[1]
    ipt = -(-sh["unit"] // ckern.WARP)
    sums = np.zeros((m, k), dtype=dt)
    raw = np.zeros(m, dtype=bool)
    carry = np.zeros((len(part) - 1, k), dtype=dt)

    def term(run, j):
        if fused:
            return (np.float64(vals[j]) * xs[cols[j]] + run).astype(dt)
        return (run + (vals[j] * xs[cols[j]]).astype(dt)).astype(dt)

    for u in range(len(part) - 1):
        (r0, j0), (r1, j1) = part[u], part[u + 1]
        rows, nnz = r1 - r0, j1 - j0
        total = rows + nnz
        ends = indptr[r0 + 1:r1 + 1]
        keys, runs, firsts = [], [], []
        for lane in range(ckern.WARP):
            d0 = min(lane * ipt, total)
            d1 = min(d0 + ipt, total)
            lo, hi = max(d0 - nnz, 0), min(d0, rows)
            while lo < hi:
                mid = (lo + hi) // 2
                if ends[mid] <= j0 + d0 - mid - 1:
                    lo = mid + 1
                else:
                    hi = mid
            ri, ni, ri0 = lo, d0 - lo, lo
            run, first = np.zeros(k, dtype=dt), None
            for _ in range(d0, d1):
                if ri < rows and ends[ri] <= j0 + ni:
                    if first is None:
                        first = run
                    else:
                        sums[r0 + ri] = run
                    run = np.zeros(k, dtype=dt)
                    ri += 1
                else:
                    run = term(run, j0 + ni)
                    ni += 1
            keys.append(ri)
            runs.append(run)
            firsts.append((ri0, first))
        off = 1
        while off < ckern.WARP:
            runs = [(runs[i - off] + runs[i]).astype(dt)
                    if i >= off and keys[i - off] == keys[i] else runs[i]
                    for i in range(ckern.WARP)]
            off *= 2
        for lane, (ri0, first) in enumerate(firsts):
            if first is not None:
                sums[r0 + ri0] = (runs[lane - 1] + first).astype(dt) \
                    if lane else first
                raw[r0 + ri0] = ri0 == 0 and indptr[r0] < j0
        if r1 < m:
            carry[u] = runs[ckern.WARP - 1]
    return sums, raw, carry


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("name,unit", [("banded(300,5)", 40),
                                       ("powerlaw", None),
                                       ("empty rows", 5)])
def test_vectorised_lane_runs_match_the_loop(name, unit, k, dt):
    # the emulation of the K = 1 kernel and the rows kernel, all runs a
    # step at a time, against the loop over shares, lanes and items: the
    # same bits (the same arithmetic in the same order)
    a = {"banded(300,5)": lambda: datasets.banded(300, 5),
         "powerlaw": lambda: datasets.powerlaw_graph(300, 12, seed=5),
         "empty rows": _empty_rows}[name]()
    op = ckern.prepare(to_device(from_reference(RefCSR(
        a.shape, a.indptr, a.indices, a.data.astype(dt))), "cpu"), unit)
    sh = ckern.shares({**op, "design": "rows"}, k)
    x = torch.from_numpy(_dense((a.shape[1], k), 79, dt))
    got = ckern._emulate_lanes(op, sh, x, dt, fused=k > 1)
    want = _lane_runs_loop(op, sh, x, dt, fused=k > 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_the_rule_takes_rows_up_to_16_columns_in_f32():
    a = datasets.powerlaw_graph(300, 12, seed=5)
    op = ckern.prepare(to_device(from_reference(a), "cpu"))
    assert [k for k in KS if ckern.rows_kernel(op, k)] == [2, 3, 8, 16]
    assert ckern.shares(op, 8)["unit"] == ckern.UNIT
    assert ckern.shares(op, 32)["unit"] == ckern.UNIT_COLS
    assert ckern.shares(op, 1)["unit"] == ckern.UNIT_SPMV
    op64 = ckern.prepare(to_device(from_reference(
        RefCSR(a.shape, a.indptr, a.indices, a.data.astype(np.float64))),
        "cpu"))
    assert [k for k in KS if ckern.rows_kernel(op64, k)] == [2, 3]
    assert ckern.ROWS_MAX_K == 16 and ckern.ROWS_MAX_K_F64 == 4
    # f64 on rows of more than ROWS_MEAN_F64 nonzeros on average: the
    # columns kernel at every K
    dense = datasets.banded(300, 25, dtype=np.float64)
    assert dense.nnz > ckern.ROWS_MEAN_F64 * 300
    op_dense = ckern.prepare(to_device(from_reference(dense), "cpu"))
    assert not any(ckern.rows_kernel(op_dense, k) for k in KS)


@pytest.mark.parametrize("k", [2, 3, 8, 16, 32, 33, 64])
def test_slot_lanes_follow_the_launch(k):
    # lanes a slot: the power of two that holds K (2 to 32); past 32 every
    # lane takes 2 or 4 columns
    w, cpl = ckern.slot_lanes(k)
    assert w * cpl >= k and w in (2, 4, 8, 16, 32) and cpl in (1, 2, 4)
    assert w == 32 or w // 2 < k
    assert cpl == 1 or w == 32


def test_columns_kernel_past_128_columns():
    # K = 200: 4 columns a lane, the grid's second chunk of 128 columns
    # takes the last 72; each column's sum as at any other K
    assert ckern.slot_lanes(200) == (32, 4)
    a = datasets.powerlaw_graph(3000, 12, seed=5)
    op = ckern.prepare(to_device(from_reference(a), "cpu"), 9)
    assert not ckern.rows_kernel(op, 200)
    x = torch.from_numpy(_dense((a.shape[1], 200), 76))
    got = _np(ckern.spmm_csr_emulate(op, x))
    assert rel_err(got, _np(ckern.spmm_csr_reference(op, x))) <= KERNEL_TOL
    assert rel_err(got, spmm_golden(a, x.numpy())) < TOL
    narrow = _np(ckern.spmm_csr_emulate(op, x[:, 128:].contiguous()))
    np.testing.assert_array_equal(got[:, 128:], narrow)
