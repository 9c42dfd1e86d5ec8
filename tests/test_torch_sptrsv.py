"""The triangular-solve slice: the port's ``sptrsv``/``sptrsm``, their plans
and the Jacobi plans against the JAX package's on the same inputs.

On the CPU the port's ``syncfree`` route runs the kernel's plain version
(``sptrsv_csr_reference``, level by level) and ``tiles`` its torch tile
scan; the reference runs its XLA ``tiles`` route (its ``auto`` on the CPU).
Matrices come from the JAX package's generators and reach the port through
``from_reference``; ``b`` comes from ``np.random.default_rng``. Tolerances,
as the JAX package's own tests (``tests/test_sptrsv.py:55``): 2e-4 for f32
and 1e-10 for f64, port against reference and each against scipy.
``sptrsv_csr_emulate`` (the kernel's own order of work) is held to the
plain version on lower and upper factors.
"""

import numpy as np
import pytest
import torch

from sblas import datasets
from sblas.formats import COO, csr_transpose
from sblas.golden import rel_err, sptrsm_golden, sptrsv_golden
from sblas.ops.sptrsm import sptrsm as ref_sptrsm
from sblas.ops.sptrsv import SptrsvPlan as RefSptrsvPlan
from sblas.ops.sptrsv import sptrsv as ref_sptrsv
from sblas_torch import CSR, SptrsmPlan, SptrsvPlan, sptrsm, sptrsv
from sblas_torch.formats import from_reference
from sblas_torch.ops.kernels import sptrsv_csr as skern
from sblas_torch.ops.spmv import _PLAN_CACHE
from sblas_torch.ops.sptrsv import syncfree_bytes

TOL = {np.float32: 2e-4, np.float64: 1e-10}


def _factor(gen, dtype):
    if gen == "band":
        return datasets.lower_triangular(200, 4, bandwidth=8, seed=2,
                                         dtype=dtype)
    if gen == "random":
        return datasets.lower_triangular(300, 6, seed=3, dtype=dtype)
    if gen == "chol-spd":
        a = datasets.spd_diag_dominant(150, 5, bandwidth=12, seed=4,
                                       dtype=np.float64)
        return datasets.cholesky_factor(a, dtype=dtype)
    return datasets.cholesky_factor(datasets.poisson2d_nd(24,
                                                          dtype=np.float64),
                                    dtype=dtype)


GENS = ["band", "random", "chol-spd", "chol-nd-poisson2d-24"]


def _rhs(shape, dtype, seed=5):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _held(port, ref, golden, dtype):
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape == golden.shape
    assert port.dtype == dtype
    tol = TOL[dtype]
    assert rel_err(port, ref) < tol
    assert rel_err(port, golden) < tol
    assert rel_err(ref, golden) < tol


@pytest.mark.parametrize("method", ["auto", "tiles"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("gen", GENS)
def test_sptrsv_vs_reference(gen, dtype, method):
    # auto: the sync-free route, its f32 or f64 build
    r = _factor(gen, dtype)
    b = _rhs(r.shape[0], dtype)
    x = sptrsv(from_reference(r), b, method=method, device="cpu")
    _held(x, ref_sptrsv(r, b), sptrsv_golden(r, b), dtype)


@pytest.mark.parametrize("method", ["syncfree", "tiles"])
@pytest.mark.parametrize("gen", ["band", "chol-nd-poisson2d-24"])
def test_sptrsv_upper_and_trans(gen, method):
    r = _factor(gen, np.float32)
    u = csr_transpose(r)
    b = _rhs(r.shape[0], np.float32, 9)
    want = sptrsv_golden(u, b, lower=False)
    p = from_reference(r)
    pu = from_reference(u)
    up = sptrsv(pu, b, lower=False, method=method, device="cpu")
    _held(up, ref_sptrsv(u, b, lower=False), want, np.float32)
    # the Cholesky backsolve L^T x = b, from L as CSR and as CSC
    tr = sptrsv(p, b, trans=True, method=method, device="cpu")
    _held(tr, ref_sptrsv(r, b, trans=True), want, np.float32)
    csc = sptrsv(from_reference(u.tocsc()), b, lower=False, method=method,
                 device="cpu")
    _held(csc, ref_sptrsv(u.tocsc(), b, lower=False), want, np.float32)
    csc_t = sptrsv(p.tocsc(), b, trans=True, method=method, device="cpu")
    _held(csc_t, ref_sptrsv(r.tocsc(), b, trans=True), want, np.float32)


@pytest.mark.parametrize("method", ["auto", "tiles"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sptrsv_unit_diagonal(dtype, method):
    r = datasets.lower_triangular(100, 5, seed=6, dtype=dtype,
                                  unit_diagonal=True)
    b = _rhs(100, dtype, 7)
    # the stored diagonal is ignored: scale it to show that
    coo = r.tocoo()
    data = np.where(coo.row == coo.col, 3.0, coo.data).astype(dtype)
    scaled = COO(r.shape, coo.row, coo.col, data).tocsr()
    x = sptrsv(from_reference(scaled), b, unit_diagonal=True, method=method,
               device="cpu")
    _held(x, ref_sptrsv(scaled, b, unit_diagonal=True),
          sptrsv_golden(r, b, unit_diagonal=True), dtype)


@pytest.mark.parametrize("method", ["syncfree", "tiles"])
@pytest.mark.parametrize("lower", [True, False])
def test_stray_entries_across_the_diagonal_are_ignored(lower, method):
    base = datasets.lower_triangular(150, 5, seed=8)
    if not lower:
        base = csr_transpose(base)
    rng = np.random.default_rng(10)
    i, j = rng.integers(0, 150, 60), rng.integers(0, 150, 60)
    far = (j > i) if lower else (j < i)
    coo = base.tocoo()
    stray = COO(base.shape, np.concatenate([coo.row, i[far]]),
                np.concatenate([coo.col, j[far]]),
                np.concatenate([coo.data, rng.standard_normal(far.sum())
                                .astype(np.float32)])).tocsr()
    assert stray.nnz > base.nnz
    b = _rhs(150, np.float32, 11)
    x = sptrsv(from_reference(stray), b, lower=lower, method=method,
               device="cpu")
    _held(x, ref_sptrsv(stray, b, lower=lower),
          sptrsv_golden(base, b, lower=lower), np.float32)
    op = SptrsvPlan(from_reference(stray), lower=lower, method="syncfree",
                    device="cpu")._op
    bt = torch.from_numpy(b)
    assert rel_err(skern.sptrsv_csr_emulate(op, bt).numpy(),
                   skern.sptrsv_csr_reference(op, bt).numpy()) < 1e-6


@pytest.mark.parametrize("method", ["auto", "tiles", "jacobi"])
def test_missing_or_zero_diagonal_raises(method):
    missing = from_reference(COO((3, 3), [1, 2], [0, 1], [1.0, 1.0]).tocsr())
    zero = CSR((3, 3), np.array([0, 1, 3, 5], np.int32),
               np.array([0, 0, 1, 1, 2], np.int32),
               np.array([2.0, 1.0, 0.0, 1.0, 4.0], np.float32))
    for bad in (missing, zero):
        with pytest.raises(ValueError):
            sptrsv(bad, np.ones(3, np.float32), method=method, device="cpu")
    with pytest.raises(ValueError, match="diagonal"):
        RefSptrsvPlan(COO((3, 3), [1, 2], [0, 1], [1.0, 1.0]).tocsr())


@pytest.mark.parametrize("k", [1, 3, 8, 11])
@pytest.mark.parametrize("method", ["auto", "tiles"])
@pytest.mark.parametrize("gen", ["random", "chol-nd-poisson2d-24"])
def test_sptrsm_vs_reference(gen, method, k):
    r = _factor(gen, np.float32)
    b = _rhs((r.shape[0], k), np.float32, 12)
    x = sptrsm(from_reference(r), b, method=method, device="cpu")
    _held(x, ref_sptrsm(r, b), sptrsm_golden(r, b), np.float32)
    xt = sptrsm(from_reference(r), b, trans=True, method=method,
                device="cpu")
    _held(xt, ref_sptrsm(r, b, trans=True),
          sptrsm_golden(csr_transpose(r), b, lower=False), np.float32)


@pytest.mark.parametrize("sweeps", [None, 3])
@pytest.mark.parametrize("lower", [True, False])
def test_jacobi_vs_reference(lower, sweeps):
    r = _factor("band", np.float32)
    if not lower:
        r = csr_transpose(r)
    p = from_reference(r)
    b = _rhs(r.shape[0], np.float32, 13)
    bm = _rhs((r.shape[0], 4), np.float32, 14)
    x = sptrsv(p, b, lower=lower, method="jacobi", sweeps=sweeps,
               device="cpu")
    want = ref_sptrsv(r, b, lower=lower, method="jacobi", sweeps=sweeps)
    xm = sptrsm(p, bm, lower=lower, method="jacobi", sweeps=sweeps,
                device="cpu")
    want_m = ref_sptrsm(r, bm, lower=lower, method="jacobi", sweeps=sweeps)
    # the same sweeps in another summation order: f32 sums of the same terms
    assert rel_err(x.numpy(), np.asarray(want)) < 2e-5
    assert rel_err(xm.numpy(), np.asarray(want_m)) < 2e-5
    if sweeps is None:     # exact
        _held(x, want, sptrsv_golden(r, b, lower=lower), np.float32)
        _held(xm, want_m, sptrsm_golden(r, bm, lower=lower), np.float32)
    plan = _PLAN_CACHE[p][("sptrsv", lower, False, "jacobi",
                           tuple(sorted({"sweeps": sweeps,
                                         "device": "cpu"}.items())))]
    ref_plan = _ref_jacobi(r, lower, sweeps)
    assert plan.nlevels == ref_plan.nlevels
    assert plan.sweeps == ref_plan.sweeps
    assert plan.method == "jacobi+csr"


def _ref_jacobi(r, lower, sweeps):
    from sblas.ops.sptrsv_iter import SptrsvJacobiPlan

    return SptrsvJacobiPlan(r, lower=lower, sweeps=sweeps)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("gen", ["random", "chol-nd-poisson2d-24"])
def test_emulate_vs_plain(gen, lower, k):
    r = _factor(gen, np.float32)
    a = from_reference(r if lower else csr_transpose(r))
    op = skern.prepare(a, "cpu", lower=lower)
    b = torch.from_numpy(_rhs((a.shape[0], k), np.float32, 15))
    emu = skern.sptrsv_csr_emulate(op, b)
    plain = skern.sptrsv_csr_reference(op, b)
    assert emu.shape == plain.shape == (a.shape[0], k)
    # f32 lane sums against f64 row sums, rounded once
    assert rel_err(emu.numpy(), plain.numpy()) < 1e-6
    assert rel_err(plain.numpy(), sptrsv_golden(
        r if lower else csr_transpose(r), b.numpy(), lower=lower)) < 2e-4


def _grid_factor(dtype):
    """The lower triangle of a natural-order 5-point grid: the IC(0)
    pattern, whose levels are the grid's antidiagonals."""
    import scipy.sparse as sps
    a = datasets.poisson2d(16, dtype=np.float64).to_scipy()
    low = sps.tril(a).tocsr()
    low.sort_indices()
    return CSR(low.shape, low.indptr.astype(np.int32),
               low.indices.astype(np.int32), low.data.astype(dtype))


def _sided(gen, dtype, lower):
    if gen == "grid":
        p = _grid_factor(dtype)
        return p if lower else CSR.from_scipy(p.to_scipy().T.tocsr())
    r = _factor(gen, dtype)
    return from_reference(r if lower else csr_transpose(r))


def _groups_by_hand(levels, group_rows):
    """The ticket order's groups, level by level in a loop: a level of
    more than group_rows rows alone, else with the levels after it while
    the rows before each stay in the same multiple of group_rows."""
    sizes = np.bincount(levels)
    out, before, prev = [], 0, None
    for lvl, size in enumerate(sizes):
        key = before // group_rows
        if not out or size > group_rows or prev[1] > group_rows \
                or key != prev[0]:
            out.append([])
        out[-1].append(lvl)
        prev, before = (key, size), before + size
    return out


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("gen", ["random", "grid", "chol-nd-poisson2d-24"])
def test_ticket_order_is_topological(gen, lower):
    # every strict entry's column (a dependency) is solved before its row,
    # in the order prepare builds and at other group sizes
    a = _sided(gen, np.float32, lower)
    op = skern.prepare(a, "cpu", lower=lower)
    n = a.shape[0]
    rows = np.repeat(np.arange(n), np.diff(a.indptr))
    strict = a.indices < rows if lower else a.indices > rows
    assert strict.any()
    levels = op["levels"]
    built = op["perm"].numpy()
    np.testing.assert_array_equal(built, skern.ticket_order(levels, lower))
    for g in (0, 4, 16, skern.GROUP_ROWS):
        perm = skern.ticket_order(levels, lower, g)
        assert perm.dtype == np.int32
        np.testing.assert_array_equal(np.sort(perm), np.arange(n))
        rank = np.empty(n, np.int64)
        rank[perm] = np.arange(n)
        assert (rank[a.indices[strict]] < rank[rows[strict]]).all()
        if g == 0:
            # plain level order: level by level, by row inside a level
            # (descending for upper, as row order runs), and not row order
            # on these factors
            lv = levels[perm]
            assert (np.diff(lv) >= 0).all()
            step = np.diff(perm)[np.diff(lv) == 0]
            assert (step > 0 if lower else step < 0).all()
            assert not np.array_equal(perm,
                                      skern.row_order(op)["perm"].numpy())
            continue
        # groups of whole levels, in turn, each by row index
        want = []
        for group in _groups_by_hand(levels, g):
            members = np.flatnonzero(np.isin(levels, group))
            want.extend(members if lower else members[::-1])
        np.testing.assert_array_equal(perm, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("gen", ["random", "grid", "chol-nd-poisson2d-24"])
def test_emulate_is_bit_equal_in_level_and_row_order(gen, lower, dtype):
    # each row's sum runs in the same order whatever the ticket order, so
    # level order gives the row order's bits
    a = _sided(gen, dtype, lower)
    op = skern.prepare(a, "cpu", lower=lower)
    b = torch.from_numpy(_rhs((a.shape[0], 2 if dtype == np.float32 else 1),
                              dtype, 17))
    level = skern.sptrsv_csr_emulate(op, b)
    rows = skern.sptrsv_csr_emulate(skern.row_order(op), b)
    assert torch.equal(level, rows)
    plain_order = skern.ticket_order(op["levels"], lower, 0)
    assert torch.equal(skern.sptrsv_csr_emulate(
        {**op, "perm": torch.from_numpy(plain_order)}, b), rows)
    plain = skern.sptrsv_csr_reference(op, b)
    assert rel_err(level.numpy(), plain.numpy()) < \
        (1e-6 if dtype == np.float32 else 1e-14)


def test_plan_routes_and_attributes():
    r = _factor("chol-nd-poisson2d-24", np.float32)
    p = from_reference(r)
    ref = RefSptrsvPlan(r)
    plan = SptrsvPlan(p, device="cpu")
    assert plan.method == "syncfree" and "auto" in plan.route_reason
    assert plan.nlevels == ref.nlevels
    n = r.shape[0]
    assert plan.bytes_per_iter == syncfree_bytes(n, r.nnz) == \
        r.nnz * 8 + (n + 1) * 4 + 3 * n * 4
    assert not hasattr(plan, "padding_ratio")
    pallas = SptrsvPlan(p, method="pallas", device="cpu")
    assert pallas.method == "syncfree" and "pallas" in pallas.route_reason
    r64 = _factor("chol-nd-poisson2d-24", np.float64)
    p64 = from_reference(r64)
    auto64 = SptrsvPlan(p64, device="cpu")
    assert auto64.method == "syncfree" and "float64" in auto64.route_reason
    ds = SptrsvPlan(p64, method="pallas_ds", device="cpu")
    assert ds.method == "syncfree" and "pallas_ds" in ds.route_reason
    assert ds.bytes_per_iter == syncfree_bytes(n, r64.nnz, 1, 8)
    tiles = SptrsvPlan(p64, method="tiles", device="cpu")
    ref64 = RefSptrsvPlan(r64)
    assert tiles.method == "tiles"
    assert (tiles.nlevels, tiles.tile_rows, tiles.num_tiles,
            tiles.bytes_per_iter) == (ref64.nlevels, ref64.tile_rows,
                                      ref64.num_tiles, ref64.bytes_per_iter)
    assert tiles.padding_ratio == ref64.padding_ratio
    # pallas_ds is the f64 path, here as in the JAX package
    with pytest.raises(ValueError, match="f64 path"):
        SptrsvPlan(p, method="pallas_ds", device="cpu")
    with pytest.raises(ValueError, match="f64 path"):
        sptrsm(p, np.ones((n, 2), np.float32), method="pallas_ds",
               device="cpu")
    with pytest.raises(ValueError, match="f64 path"):
        RefSptrsvPlan(r, method="pallas_ds")
    with pytest.raises(ValueError, match="unknown"):
        SptrsvPlan(p, method="wavefront", device="cpu")
    cplx = CSR(p.shape, p.indptr, p.indices, p.data.astype(np.complex64))
    with pytest.raises(ValueError, match="complex"):
        SptrsvPlan(cplx, method="syncfree", device="cpu")
    with pytest.raises(ValueError, match="square"):
        SptrsvPlan(from_reference(datasets.random_csr(5, 4, 2, seed=1)),
                   device="cpu")
    with pytest.raises(ValueError, match="shape"):
        plan(np.ones((n, 2), np.float32))
    with pytest.raises(ValueError, match="shape"):
        SptrsmPlan(p, device="cpu")(np.ones(n, np.float32))


@pytest.mark.parametrize("tile_rows", [8, 32, 128])
def test_tiles_tile_sizes(tile_rows):
    r = datasets.lower_triangular(256, 6, seed=10, dtype=np.float64)
    b = _rhs(256, np.float64, 11)
    x = sptrsv(from_reference(r), b, method="tiles", tile_rows=tile_rows,
               validate=True, device="cpu")
    want = ref_sptrsv(r, b, tile_rows=tile_rows, validate=True)
    _held(x, want, sptrsv_golden(r, b), np.float64)


def test_sptrsv_and_sptrsm_share_one_analysis():
    p = from_reference(_factor("band", np.float32))
    n = p.shape[0]
    sptrsv(p, np.ones(n, np.float32), device="cpu")
    sptrsm(p, np.ones((n, 3), np.float32), device="cpu")
    sptrsm(p, np.ones((n, 5), np.float32), device="cpu")
    plans = _PLAN_CACHE[p]
    sv = plans[("sptrsv", True, False, "auto", (("device", "cpu"),))]
    sm = plans[("sptrsm", True, False, "auto", (("device", "cpu"),))]
    assert sm._sv is sv and len(plans) == 2
    assert sm.bytes_per_iter(5) == syncfree_bytes(n, p.nnz, 5)


def test_diagonal_only_and_empty_matrices():
    d = CSR((4, 4), np.arange(5, dtype=np.int32), np.arange(4, dtype=np.int32),
            np.array([2.0, -4.0, 0.5, 8.0], np.float32))
    b = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    for method in ("auto", "tiles", "jacobi"):
        x = sptrsv(d, b, method=method, device="cpu")
        np.testing.assert_allclose(x.numpy(), b / d.data, rtol=1e-7)
    plan = SptrsvPlan(d, device="cpu")
    assert plan.nlevels == 1
    e = CSR((0, 0), np.zeros(1, np.int32), np.zeros(0, np.int32),
            np.zeros(0, np.float32))
    plan = SptrsvPlan(e, device="cpu")
    assert plan.nlevels == 0
    assert plan(np.zeros(0, np.float32)).shape == (0,)
    assert sptrsm(e, np.zeros((0, 3), np.float32), device="cpu").shape == \
        (0, 3)


def test_wrapper_checks_b():
    p = from_reference(_factor("band", np.float32))
    op = skern.prepare(p, "cpu")
    n = p.shape[0]
    with pytest.raises(ValueError, match="f32"):
        skern.sptrsv_csr(op, torch.ones(n, dtype=torch.float64))
    with pytest.raises(ValueError, match="shape"):
        skern.sptrsv_csr(op, torch.ones(n + 1))
    with pytest.raises(ValueError, match="contiguous"):
        skern.sptrsv_csr(op, torch.ones((3, n)).t())


@pytest.mark.parametrize("entry", ["SptrsvPlan", "SptrsmPlan", "sptrsv",
                                   "sptrsm"])
def test_the_card_is_the_default(entry):
    if torch.cuda.is_available():
        pytest.skip("there is a card here")
    import sblas_torch

    p = from_reference(_factor("band", np.float32))
    n = p.shape[0]
    call = getattr(sblas_torch, entry)
    args = (p,) if entry[0] == "S" else (
        p, np.ones((n, 2) if entry == "sptrsm" else n, np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(*args)
