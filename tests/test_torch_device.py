"""What runs on the card: the CUDA kernels against their plain versions,
the main paths through them, and the timing harness that refuses to time a
CPU.

The ``cuda`` tests skip where torch sees no card. This file imports no JAX,
so on a machine with a card it runs on its own:

    python -m pytest --noconftest tests/test_torch_device.py -q
"""

import numpy as np
import pytest
import torch

import sblas_torch
from sblas_torch import datasets
from sblas_torch.formats import COO, CSR, to_device
from sblas_torch.formats import csr_transpose
from sblas_torch.golden import (KERNEL_TOL, KERNEL_TOL_F64, rel_err,
                                spmm_golden, spmv_golden, sptrsm_golden,
                                sptrsv_golden)
from sblas_torch.ops.kernels import spmm_bsr as bkern
from sblas_torch.ops.kernels import spmm_csr as ckern
from sblas_torch.ops.kernels import sptrsv_csr as skern
from sblas_torch.ops.kernels import spmv_csr as kern
from sblas_torch.retile_bsr import pack_bsr
from sblas_torch.utils.timing import measure_seconds_per_iter

MATRICES = {
    "banded": lambda: datasets.banded(300, 5, seed=1),
    "empty_rows": lambda: datasets.random_csr(100, 90, 2, seed=4),
    "skewed": lambda: datasets.random_csr(400, 400, 12, skew=1.2, seed=3),
    "long_rows": lambda: datasets.random_csr(64, 5000, 900, seed=5),
    "no_entries": lambda: CSR((5, 7), np.zeros(6, np.int32),
                              np.zeros(0, np.int32), np.zeros(0, np.float32)),
}


@pytest.fixture
def cuda():
    # decided here, not at import: every test worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _vec(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("vdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(MATRICES))
def test_kernel_vs_plain_on_card(cuda, name, vdt):
    a = MATRICES[name]()
    t = kern.prepare(to_device(a, cuda, vdt))
    x = torch.from_numpy(_vec(a.shape[1], 1)).to(cuda)
    y = torch.from_numpy(_vec(a.shape[0], 2)).to(cuda)
    for group, args in [(t["group"], (2.5, -0.5, y)),
                        (t["group"], (1.0, 0.0, None)),
                        *[(g, (2.5, -0.5, y)) for g in kern.GROUPS]]:
        before = kern.LAUNCHES
        got = kern.spmv_csr({**t, "group": group}, x, *args)
        torch.cuda.synchronize()
        assert kern.LAUNCHES == before + (a.shape[0] > 0)
        want = kern.spmv_csr_reference(t, x, *args)
        assert got.shape == (a.shape[0],) and torch.isfinite(got).all()
        assert rel_err(got.cpu().numpy(), want.cpu().numpy()) <= KERNEL_TOL


@pytest.mark.cuda
def test_main_path_goes_through_the_kernel(cuda):
    a = datasets.emulate("cant", scale=0.05)
    x, y0 = _vec(a.shape[1], 3), _vec(a.shape[0], 4)
    before = kern.LAUNCHES
    out = sblas_torch.spmv(a, x, 2.5, -0.5, y0, device=cuda)
    torch.cuda.synchronize()
    assert out.device.type == "cuda"
    assert kern.LAUNCHES == before + 1
    assert rel_err(out.cpu().numpy(),
                   spmv_golden(a, x, 2.5, -0.5, y0)) < 2e-5


BLOCK_MATRICES = {
    "banded": lambda: datasets.banded(300, 5, seed=1),
    "m!=n": lambda: datasets.random_csr(300, 200, 6, seed=2),
    "empty_block_rows": lambda: _with_empty_block_rows(),
    "no_entries": MATRICES["no_entries"],
    "cant_0.05": lambda: datasets.emulate("cant", scale=0.05),
}


def _with_empty_block_rows():
    # rows 64..319 hold nothing: block-rows 1 (br=128) and 1..4 (br=64) are
    # empty, and so are the last rows
    return _drop_rows(datasets.random_csr(450, 400, 7, seed=6), (64, 320),
                      (420, 450))


def _drop_rows(a, *spans):
    coo = a.tocoo()
    keep = np.ones(a.nnz, bool)
    for lo, hi in spans:
        keep &= (coo.row < lo) | (coo.row >= hi)
    return COO(a.shape, coo.row[keep], coo.col[keep], coo.data[keep]).tocsr()


@pytest.mark.cuda
@pytest.mark.parametrize("br", [128, 64])
@pytest.mark.parametrize("vdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(BLOCK_MATRICES))
def test_block_kernel_vs_plain_on_card(cuda, name, vdt, br):
    a = BLOCK_MATRICES[name]()
    op = bkern.prepare(bkern.bsr_to_device(pack_bsr(a, br=br), cuda, vdt))
    m, n = a.shape
    for k in (1, 3, 8, 32, 40):
        x = torch.from_numpy(np.random.default_rng(k).standard_normal(
            (n, k)).astype(np.float32)).to(cuda)
        y = torch.from_numpy(np.random.default_rng(k + 1).standard_normal(
            (m, k)).astype(np.float32)).to(cuda)
        for args in ((2.5, -0.5, y), (1.0, 0.0, None)):
            before = bkern.LAUNCHES
            got = bkern.spmm_bsr(op, x, *args)
            torch.cuda.synchronize()
            assert bkern.LAUNCHES == before + 1
            want = bkern.spmm_bsr_reference(op, x, *args)
            assert got.shape == (m, k) and torch.isfinite(got).all()
            assert rel_err(got.cpu().numpy(),
                           want.cpu().numpy()) <= KERNEL_TOL


@pytest.mark.cuda
def test_spmm_main_path_goes_through_the_block_kernel(cuda):
    # at K = 32 the bytes rule picks the block route on cant (at K = 8 the
    # nnz-balanced kernel)
    a = datasets.emulate("cant", scale=0.05)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((a.shape[1], 32)).astype(np.float32)
    y0 = rng.standard_normal((a.shape[0], 32)).astype(np.float32)
    before = bkern.LAUNCHES
    out = sblas_torch.spmm(a, x, 2.5, -0.5, y0, k_hint=32, device=cuda)
    torch.cuda.synchronize()
    assert out.device.type == "cuda"
    assert bkern.LAUNCHES == before + 1
    assert rel_err(out.cpu().numpy(),
                   spmm_golden(a, x, 2.5, -0.5, y0)) < 2e-5


def _csr_launches(f64=False):
    """Launches so far of the nnz-balanced kernel's f32/bf16 (or f64)
    build, each counted under the one kernel it launched."""
    if f64:
        return ckern.LAUNCHES_F64 + ckern.LAUNCHES_COLS_F64
    return ckern.LAUNCHES + ckern.LAUNCHES_ROWS + ckern.LAUNCHES_COLS


def _long_rows():
    # rows of 20,000+ nonzeros, many empty rows (the last ones too), m != n
    rng = np.random.default_rng(11)
    rows = np.concatenate([np.zeros(21000), np.full(24000, 9),
                           rng.integers(0, 300, 3000)])
    cols = np.concatenate([rng.permutation(30000)[:21000],
                           rng.permutation(30000)[:24000],
                           rng.integers(0, 30000, 3000)])
    return COO((400, 30000), rows, cols,
               rng.standard_normal(len(rows)).astype(np.float32)).tocsr()


CSR_MATRICES = {
    "banded": MATRICES["banded"],
    "empty_rows": MATRICES["empty_rows"],
    "no_entries": MATRICES["no_entries"],
    "long_rows": _long_rows,
    "powerlaw": lambda: datasets.powerlaw_graph(3000, 12, seed=5),
}


@pytest.mark.cuda
@pytest.mark.parametrize("unit", [None, 5])
@pytest.mark.parametrize("vdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(CSR_MATRICES))
def test_spmm_csr_vs_plain_on_card(cuda, name, vdt, unit):
    # unit=5: many more shares than rows, rows cut across many shares
    a = CSR_MATRICES[name]()
    raw = to_device(a, cuda, vdt)
    op = ckern.prepare(raw) if unit is None else ckern.prepare(raw, unit)
    m, n = a.shape
    for k in (1, 3, 8, 32, 40):
        x = torch.from_numpy(np.random.default_rng(k).standard_normal(
            (n, k)).astype(np.float32)).to(cuda)
        y = torch.from_numpy(np.random.default_rng(k + 1).standard_normal(
            (m, k)).astype(np.float32)).to(cuda)
        for args in ((2.5, -0.5, y), (1.0, 0.0, None)):
            before = _csr_launches()
            got = ckern.spmm_csr(op, x, *args)
            torch.cuda.synchronize()
            assert _csr_launches() == before + 1
            want = ckern.spmm_csr_reference(op, x, *args)
            assert got.shape == (m, k) and torch.isfinite(got).all()
            assert rel_err(got.cpu().numpy(),
                           want.cpu().numpy()) <= KERNEL_TOL
            # no atomics: the same bits from run to run
            assert torch.equal(got, ckern.spmm_csr(op, x, *args))


@pytest.mark.cuda
@pytest.mark.parametrize("unit", [None, 5, 2048])
@pytest.mark.parametrize("name", list(CSR_MATRICES))
def test_f64_spmm_csr_vs_plain_on_card(cuda, name, unit):
    # the f64 build (unit 2048: more than 48 KB of shared memory a block at
    # K = 1), alpha = 1/3, against its plain version and scipy
    a = CSR_MATRICES[name]().astype(np.float64)
    raw = to_device(a, cuda)
    op = ckern.prepare(raw) if unit is None else ckern.prepare(raw, unit)
    m, n = a.shape
    for k in (1, 3, 8, 32):
        rng = np.random.default_rng(k)
        x = torch.from_numpy(rng.standard_normal((n, k))).to(cuda)
        y = torch.from_numpy(rng.standard_normal((m, k))).to(cuda)
        for args in ((1 / 3, -0.5, y), (1.0, 0.0, None)):
            before, before32 = _csr_launches(True), _csr_launches()
            got = ckern.spmm_csr(op, x, *args)
            torch.cuda.synchronize()
            assert _csr_launches(True) == before + 1
            assert _csr_launches() == before32
            assert got.dtype == torch.float64 and got.shape == (m, k)
            want = ckern.spmm_csr_reference(op, x, *args)
            assert rel_err(got.cpu().numpy(), want.cpu().numpy()) <= \
                KERNEL_TOL_F64
            yy = None if args[2] is None else args[2].cpu().numpy()
            assert rel_err(got.cpu().numpy(), spmm_golden(
                a, x.cpu().numpy(), args[0], args[1], yy)) < 1e-13
            assert torch.equal(got, ckern.spmm_csr(op, x, *args))


KS = (2, 3, 8, 16, 32, 33, 64)


def _card_pair(n, m, k, dtype, cuda):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((n, k)).astype(dtype)
    y = rng.standard_normal((m, k)).astype(dtype)
    return torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["cols", "rows"])
@pytest.mark.parametrize("vdt", [torch.float32, torch.bfloat16,
                                 torch.float64])
@pytest.mark.parametrize("name", ["long_rows", "powerlaw", "empty_rows"])
def test_merge_kernels_at_every_k_on_card(cuda, name, vdt, design):
    # both K > 1 kernels of csrc/spmm_csr.cu (f64 takes the columns kernel
    # whatever the operand names) at every K, shares of the rule's size and
    # of 5 items; the same bits on a second call
    a = CSR_MATRICES[name]()
    f64 = vdt == torch.float64
    if f64:
        a = a.astype(np.float64)
    m, n = a.shape
    raw = to_device(a, cuda, None if f64 else vdt)
    for op in (ckern.prepare(raw), ckern.prepare(raw, 5)):
        op = {**op, "design": design}
        for k in KS:
            cols = not ckern.rows_kernel(op, k)
            assert cols == (f64 or design == "cols")
            x, y = _card_pair(n, m, k, np.float64 if f64 else np.float32,
                              cuda)
            for args in (((1 / 3) if f64 else 2.5, -0.5, y),
                         (1.0, 0.0, None)):
                counter = ("LAUNCHES_ROWS" if not cols else
                           "LAUNCHES_COLS_F64" if f64 else "LAUNCHES_COLS")
                before = _csr_launches(f64)
                before_k = getattr(ckern, counter)
                got = ckern.spmm_csr(op, x, *args)
                torch.cuda.synchronize()
                assert getattr(ckern, counter) == before_k + 1
                assert _csr_launches(f64) == before + 1
                want = ckern.spmm_csr_reference(op, x, *args)
                assert got.shape == (m, k) and torch.isfinite(got).all()
                assert rel_err(got.cpu().numpy(), want.cpu().numpy()) <= (
                    KERNEL_TOL_F64 if f64 else KERNEL_TOL)
                assert torch.equal(got, ckern.spmm_csr(op, x, *args))
        if design == "cols":
            # past 128 columns: the grid's second chunk
            x, _ = _card_pair(n, m, 200, np.float64 if f64 else np.float32,
                              cuda)
            got = ckern.spmm_csr(op, x)
            assert rel_err(got.cpu().numpy(), ckern.spmm_csr_reference(
                op, x).cpu().numpy()) <= (KERNEL_TOL_F64 if f64
                                          else KERNEL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("br", [128, 64])
@pytest.mark.parametrize("vdt", [torch.float32, torch.bfloat16])
def test_block_tensor_cores_at_every_k_on_card(cuda, vdt, br):
    # the 3xTF32 block kernel at every K (one CTA a block-row and chunk of
    # up to 32 columns), against its plain version and scipy; the same bits
    # on a second call
    for name in ("cant_0.05", "empty_block_rows", "m!=n"):
        a = BLOCK_MATRICES[name]()
        op = bkern.prepare(bkern.bsr_to_device(pack_bsr(a, br=br), cuda,
                                               vdt))
        m, n = a.shape
        for k in KS:
            x, y = _card_pair(n, m, k, np.float32, cuda)
            got = bkern.spmm_bsr(op, x, 2.5, -0.5, y)
            want = bkern.spmm_bsr_reference(op, x, 2.5, -0.5, y)
            assert rel_err(got.cpu().numpy(),
                           want.cpu().numpy()) <= KERNEL_TOL
            assert torch.equal(got, bkern.spmm_bsr(op, x, 2.5, -0.5, y))
            golden = spmm_golden(a, x.cpu().numpy(), 2.5, -0.5,
                                 y.cpu().numpy())
            assert rel_err(got.cpu().numpy(), golden) < (
                2e-2 if vdt == torch.bfloat16 else 2e-5)


@pytest.mark.cuda
def test_redesigned_kernels_do_not_spill(cuda):
    # the columns kernel and the tensor-core block kernel, every
    # instantiation, from the compiler's own report
    from sblas_torch.ops.kernels import _build

    lib = _build.build()
    report = _build.ptxas_report(lib.with_suffix(".log").read_text())
    new = [r for r in report if "spmm_merge_kernel" in r["kernel"]
           or "spmm_bsr_tc" in r["kernel"]]
    assert len(new) == 3 * 7 + 2 * 2 * 3
    assert all(r["spill_stores"] == r["spill_loads"] == 0 for r in new), new


@pytest.mark.cuda
@pytest.mark.parametrize("vdt", [torch.float32, torch.bfloat16])
def test_spmm_csr_permutations_on_card(cuda, vdt):
    # the pseg plan permutes X and Y around the kernel on the relabeled
    # operand: the drop-in call in the graph's own order, and the
    # permuted space as is
    g = datasets.powerlaw_graph(3000, 12, seed=5)
    plan = sblas_torch.SpmmPlan(g, "pseg", value_dtype=vdt, device=cuda)
    assert plan._perms is not None
    cols = torch.from_numpy(plan.colperm).to(cuda)
    rows = torch.from_numpy(plan.rowperm).to(cuda)
    m, n = g.shape
    for k in (1, 3, 8, 32):
        x = torch.from_numpy(np.random.default_rng(k).standard_normal(
            (n, k)).astype(np.float32)).to(cuda)
        y = torch.from_numpy(np.random.default_rng(k + 1).standard_normal(
            (m, k)).astype(np.float32)).to(cuda)
        for args in ((2.5, -0.5, y), (1.0, 0.0, None)):
            before = _csr_launches()
            got = plan(x, *args)
            yp = None if args[2] is None else args[2][rows]
            got_p = plan.apply_permuted(x[cols], args[0], args[1], yp)
            torch.cuda.synchronize()
            assert _csr_launches() == before + 2
            want = ckern.spmm_csr_reference(plan._op, x[cols], args[0],
                                            args[1], yp)
            assert rel_err(got_p.cpu().numpy(),
                           want.cpu().numpy()) <= KERNEL_TOL
            assert torch.equal(got[rows], got_p)
            if vdt == torch.float32:
                yy = None if args[2] is None else args[2].cpu().numpy()
                assert rel_err(got.cpu().numpy(), spmm_golden(
                    g, x.cpu().numpy(), args[0], args[1], yy)) < 2e-5


@pytest.mark.cuda
def test_scattered_main_paths_go_through_the_kernel(cuda):
    a = datasets.powerlaw_graph(20000, 16, seed=3)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((a.shape[1], 8)).astype(np.float32)
    y0 = rng.standard_normal((a.shape[0], 8)).astype(np.float32)
    before = ckern.LAUNCHES, ckern.LAUNCHES_ROWS
    out = sblas_torch.spmv(a, x[:, 0], 2.5, -0.5, y0[:, 0], method="pseg",
                           device=cuda)
    outm = sblas_torch.spmm(a, x, 2.5, -0.5, y0, method="pseg", device=cuda)
    outp = sblas_torch.spmm(a, x, method="pallas", device=cuda)
    outa = sblas_torch.spmv(a, x[:, 0], device=cuda)     # auto: merge
    torch.cuda.synchronize()
    # two SpMVs (K = 1) and two SpMMs at K = 8 (the rows kernel)
    assert (ckern.LAUNCHES, ckern.LAUNCHES_ROWS) == (before[0] + 2,
                                                      before[1] + 2)
    assert rel_err(out.cpu().numpy(),
                   spmv_golden(a, x[:, 0], 2.5, -0.5, y0[:, 0])) < 2e-5
    assert rel_err(outa.cpu().numpy(), spmv_golden(a, x[:, 0])) < 2e-5
    assert rel_err(outm.cpu().numpy(),
                   spmm_golden(a, x, 2.5, -0.5, y0)) < 2e-5
    assert rel_err(outp.cpu().numpy(), spmm_golden(a, x)) < 2e-5


@pytest.mark.cuda
def test_csr_kernel_keeps_f32_accuracy_on_a_long_row(cuda):
    # one row of 400,000 nonzeros: G = 2 lanes each sum 200,000 products
    # (50,000 at G = 8, the csr route's pick on twitter7@0.02, where a lane
    # summing them one after the other missed 2e-5)
    rng = np.random.default_rng(21)
    n, long = 1_000_000, 400_000
    rows = np.concatenate([np.zeros(long, np.int64),
                           np.repeat(np.arange(1, 2000), 3)])
    cols = np.concatenate([rng.permutation(n)[:long],
                           rng.integers(0, n, 3 * 1999)])
    a = COO((2000, n), rows, cols,
            rng.standard_normal(len(rows)).astype(np.float32)).tocsr()
    assert a.row_lengths.max() >= 400_000
    x = rng.standard_normal(n).astype(np.float32)
    want = a.to_scipy().astype(np.float64) @ x.astype(np.float64)
    xd = torch.from_numpy(x).to(cuda)
    t = kern.prepare(to_device(a, cuda))
    for g in kern.GROUPS:
        got = kern.spmv_csr({**t, "group": g}, xd).cpu().numpy()
        assert rel_err(got, want) < 2e-5, g


def _sptrsv_cases():
    return {
        "band": lambda: datasets.lower_triangular(400, 6, bandwidth=30,
                                                  seed=2),
        "random": lambda: datasets.lower_triangular(300, 5, seed=3),
        "chol-nd": lambda: datasets.cholesky_factor(
            datasets.poisson2d_nd(30, dtype=np.float64)),
        # rows 0..199 hold only their diagonal: no dependencies
        "empty_strict_rows": lambda: _drop_strict(
            datasets.lower_triangular(300, 5, seed=4), 200),
        "long_rows": lambda: datasets.lower_triangular(600, 300, seed=5),
    }


def _unit(a, lower):
    """``a`` with each row's strict entries scaled to an absolute sum of at
    most 1/2 and the diagonal set to 1: a unit-diagonal factor whose solve
    stays bounded (a random one grows without limit with its depth)."""
    coo = a.tocoo()
    strict = coo.col < coo.row if lower else coo.col > coo.row
    sums = np.bincount(coo.row[strict], np.abs(coo.data[strict]),
                       minlength=a.shape[0])
    data = np.where(strict, coo.data / (2 * sums[coo.row] + 1e-30), 1.0)
    return COO(a.shape, coo.row, coo.col, data.astype(np.float32)).tocsr()


def _drop_strict(l, upto):
    coo = l.tocoo()
    keep = (coo.row >= upto) | (coo.row == coo.col)
    return COO(l.shape, coo.row[keep], coo.col[keep], coo.data[keep]).tocsr()


@pytest.mark.cuda
@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("name", list(_sptrsv_cases()))
def test_sptrsv_kernel_vs_plain_on_card(cuda, name, lower, unit):
    l = _sptrsv_cases()[name]()
    a = l if lower else csr_transpose(l)
    if unit:
        a = _unit(a, lower)
    op = skern.prepare(a, cuda, lower=lower, unit_diagonal=unit)
    n = a.shape[0]
    for k in (1, 3, 8, 11, 16, 20):
        b = torch.from_numpy(np.random.default_rng(k).standard_normal(
            (n, k)).astype(np.float32)).to(cuda)
        before = skern.LAUNCHES
        got = skern.sptrsv_csr(op, b if k > 1 else b[:, 0].contiguous())
        torch.cuda.synchronize()
        assert skern.LAUNCHES == before + 1
        got = got.view(n, k)
        assert torch.isfinite(got).all()
        want = skern.sptrsv_csr_reference(op, b)
        assert rel_err(got.cpu().numpy(), want.cpu().numpy()) <= KERNEL_TOL
        assert rel_err(got.cpu().numpy(), sptrsm_golden(
            a, b.cpu().numpy(), lower=lower, unit_diagonal=unit)) < 1e-3
        if k <= 3 and n <= 400:
            # the kernel's own order of work, emulated on the CPU
            emu = skern.sptrsv_csr_emulate(op, b)
            assert rel_err(got.cpu().numpy(), emu.cpu().numpy()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8])
def test_sptrsv_kernel_repeats_bit_for_bit(cuda, k):
    l = datasets.cholesky_factor(datasets.poisson2d_nd(60, dtype=np.float64))
    for lower, a in ((True, l), (False, csr_transpose(l))):
        op = skern.prepare(a, cuda, lower=lower)
        b = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (a.shape[0], k)).astype(np.float32)).to(cuda)
        first = skern.sptrsv_csr(op, b)
        for _ in range(20):
            assert torch.equal(skern.sptrsv_csr(op, b), first)


def _ic0_grid():
    """The lower triangle of a natural-order 5-point grid (the IC(0)
    pattern): its levels are the antidiagonals."""
    import scipy.sparse as sp
    low = sp.tril(datasets.poisson2d(90, dtype=np.float64).to_scipy()).tocsr()
    low.sort_indices()
    return CSR.from_scipy(low)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", ["chol-nd", "band", "ic0-grid"])
def test_sptrsv_level_order_is_bit_equal_to_row_order(cuda, name, dtype):
    # tickets in the kernel's order (levels, small ones grouped) and in
    # plain level order give the row order's bits (each row's sum runs in
    # the same order), and repeat them 20 times
    l = _ic0_grid() if name == "ic0-grid" else _sptrsv_cases()[name]()
    l = l.astype(dtype)
    for lower, a in ((True, l), (False, csr_transpose(l))):
        op = skern.prepare(a, cuda, lower=lower)
        rows = skern.row_order(op)
        levels = {**op, "perm": torch.from_numpy(skern.ticket_order(
            op["levels"], lower, 0)).to(cuda)}
        assert not torch.equal(levels["perm"], rows["perm"])
        for k in (1, 8):
            b = torch.from_numpy(np.random.default_rng(k).standard_normal(
                (a.shape[0], k)).astype(dtype)).to(cuda)
            got = skern.sptrsv_csr(op, b)
            assert torch.equal(got, skern.sptrsv_csr(rows, b))
            assert torch.equal(got, skern.sptrsv_csr(levels, b))
            for _ in range(20):
                assert torch.equal(skern.sptrsv_csr(op, b), got)
            assert rel_err(got.cpu().numpy(), sptrsm_golden(
                a, b.cpu().numpy(), lower=lower)) < \
                (1e-3 if dtype == np.float32 else 1e-10)


@pytest.mark.cuda
def test_sptrsv_kernel_edges_on_card(cuda):
    e = CSR((0, 0), np.zeros(1, np.int32), np.zeros(0, np.int32),
            np.zeros(0, np.float32))
    op = skern.prepare(e, cuda)
    before = skern.LAUNCHES
    assert skern.sptrsv_csr(op, torch.zeros(0, device=cuda)).shape == (0,)
    assert skern.sptrsv_csr(op, torch.zeros((0, 4), device=cuda)).shape == \
        (0, 4)
    l = datasets.lower_triangular(50, 4, seed=1)
    op = skern.prepare(l, cuda)
    assert skern.sptrsv_csr(op, torch.zeros((50, 0), device=cuda)).shape == \
        (50, 0)
    assert skern.LAUNCHES == before
    with pytest.raises(ValueError, match="is on"):
        skern.sptrsv_csr(op, torch.zeros(50))


@pytest.mark.cuda
def test_sptrsv_main_paths_go_through_the_kernel(cuda):
    l = datasets.cholesky_factor(datasets.poisson2d_nd(40, dtype=np.float64))
    n = l.shape[0]
    rng = np.random.default_rng(9)
    b, bm = rng.standard_normal(n).astype(np.float32), \
        rng.standard_normal((n, 8)).astype(np.float32)
    before = skern.LAUNCHES
    x = sblas_torch.sptrsv(l, b)
    xt = sblas_torch.sptrsv(l, b, trans=True)
    xm = sblas_torch.sptrsm(l, bm)
    xc = sblas_torch.sptrsv(l.tocsc(), b, method="pallas")
    torch.cuda.synchronize()
    assert skern.LAUNCHES == before + 4
    assert x.device.type == "cuda"
    lt = csr_transpose(l)
    assert rel_err(x.cpu().numpy(), sptrsv_golden(l, b)) < 1e-3
    assert rel_err(xt.cpu().numpy(), sptrsv_golden(lt, b, lower=False)) < 1e-3
    assert rel_err(xm.cpu().numpy(), sptrsm_golden(l, bm)) < 1e-3
    assert rel_err(xc.cpu().numpy(), sptrsv_golden(l, b)) < 1e-3
    # the Jacobi sweeps run the SpMV route its rule picks for E
    before = kern.LAUNCHES + ckern.LAUNCHES
    xj = sblas_torch.sptrsv(l, b, method="jacobi")
    torch.cuda.synchronize()
    assert kern.LAUNCHES + ckern.LAUNCHES > before
    assert rel_err(xj.cpu().numpy(), sptrsv_golden(l, b)) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MATRICES))
def test_f64_kernel_vs_plain_on_card(cuda, name):
    # the f64 build at every lanes-per-row width, alpha = 1/3
    a = MATRICES[name]().astype(np.float64)
    t = kern.prepare(to_device(a, cuda))
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.standard_normal(a.shape[1])).to(cuda)
    y = torch.from_numpy(rng.standard_normal(a.shape[0])).to(cuda)
    want_golden = spmv_golden(a, x.cpu().numpy(), 1 / 3, -0.5,
                              y.cpu().numpy())
    for g in kern.GROUPS:
        before, before32 = kern.LAUNCHES_F64, kern.LAUNCHES
        got = kern.spmv_csr({**t, "group": g}, x, 1 / 3, -0.5, y)
        torch.cuda.synchronize()
        assert kern.LAUNCHES_F64 == before + (a.shape[0] > 0)
        assert kern.LAUNCHES == before32
        assert got.dtype == torch.float64 and torch.isfinite(got).all()
        want = kern.spmv_csr_reference(t, x, 1 / 3, -0.5, y)
        assert rel_err(got.cpu().numpy(), want.cpu().numpy()) <= \
            KERNEL_TOL_F64
        assert rel_err(got.cpu().numpy(), want_golden) < 1e-13


@pytest.mark.cuda
def test_f64_alpha_and_beta_keep_every_bit(cuda):
    # y = alpha * I @ 1 + beta * 1: a c_float argument would give
    # 0.3333333432674408 for 1/3
    n = 64
    eye = CSR((n, n), np.arange(n + 1, dtype=np.int32),
              np.arange(n, dtype=np.int32), np.ones(n))
    t = kern.prepare(to_device(eye, cuda))
    one = torch.ones(n, dtype=torch.float64, device=cuda)
    got = kern.spmv_csr(t, one, 1 / 3, 0.0).cpu().numpy()
    assert (got == 1 / 3).all()
    got = kern.spmv_csr(t, one, 0.0, 1 / 7, one).cpu().numpy()
    assert (got == 1 / 7).all()


@pytest.mark.cuda
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("name", list(_sptrsv_cases()))
def test_f64_sptrsv_kernel_vs_plain_on_card(cuda, name, lower):
    l = _sptrsv_cases()[name]().astype(np.float64)
    a = l if lower else csr_transpose(l)
    op = skern.prepare(a, cuda, lower=lower)
    n = a.shape[0]
    for k in (1, 3, 8, 17):
        b = torch.from_numpy(np.random.default_rng(k).standard_normal(
            (n, k))).to(cuda)
        before, before32 = skern.LAUNCHES_F64, skern.LAUNCHES
        got = skern.sptrsv_csr(op, b)
        torch.cuda.synchronize()
        assert skern.LAUNCHES_F64 == before + 1
        assert skern.LAUNCHES == before32
        assert got.dtype == torch.float64 and torch.isfinite(got).all()
        want = skern.sptrsv_csr_reference(op, b)
        assert rel_err(got.cpu().numpy(), want.cpu().numpy()) <= \
            KERNEL_TOL_F64
        assert rel_err(got.cpu().numpy(), sptrsm_golden(
            a, b.cpu().numpy(), lower=lower)) < 1e-10
        for _ in range(20):
            assert torch.equal(skern.sptrsv_csr(op, b), got)
        if k == 1 and n <= 400:
            # the kernel's own order of work, emulated on the CPU
            emu = skern.sptrsv_csr_emulate(op, b)
            assert rel_err(got.cpu().numpy(), emu.cpu().numpy()) <= 1e-14


@pytest.mark.cuda
def test_f64_solvers_on_card(cuda):
    from sblas_torch import solvers

    a = datasets.poisson2d(40, dtype=np.float64)
    b = np.random.default_rng(5).standard_normal(a.shape[0])
    before = kern.LAUNCHES_F64, skern.LAUNCHES_F64
    for m in (None, solvers.jacobi(a), solvers.ichol(a)):
        x, info = solvers.cg(a, b, tol=1e-10, M=m)
        assert x.device.type == "cuda" and x.dtype == torch.float64
        assert info["rel_residual"] < 1e-10
        true = np.linalg.norm(b - a.to_scipy() @ x.cpu().numpy()) / \
            np.linalg.norm(b)
        assert true < 2e-10
    c = datasets.convection_diffusion(40, dtype=np.float64)
    for solve in (solvers.bicgstab, solvers.gmres):
        x, info = solve(c, b, tol=1e-10, M=solvers.ilu(c))
        true = np.linalg.norm(b - c.to_scipy() @ x.cpu().numpy()) / \
            np.linalg.norm(b)
        assert info["rel_residual"] < 1e-10 and true < 2e-10
    torch.cuda.synchronize()
    assert kern.LAUNCHES_F64 > before[0] and skern.LAUNCHES_F64 > before[1]


def test_timing_refuses_a_cpu_carry():
    x = torch.zeros(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        measure_seconds_per_iter(lambda c: c + 1, x)


def test_bench_refuses_to_run_without_a_card():
    # the benches run on the card unless the caller names the CPU
    if torch.cuda.is_available():
        pytest.skip("there is a card here")
    from sblas_torch.bench_lib import bench_spmv

    with pytest.raises(RuntimeError, match="CUDA"):
        bench_spmv(datasets.banded(32, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("argv,tol", [
    (["spmv", "--matrix", "cant", "--scale", "0.05"], 2e-5),
    (["sptrsv", "--matrix", "chol:poisson:40"], 1e-3)])
def test_cli_records_on_card(cuda, argv, tol, tmp_path):
    import json

    from sblas_torch import cli

    out = tmp_path / "r.jsonl"
    assert cli.main([*argv, "--json", str(out)]) == 0
    rec = json.loads(out.read_text().splitlines()[-1])
    assert rec["device"] == torch.cuda.get_device_name(cuda)
    assert rec["bound_us"] > 0 and rec["baseline_us"] > 0
    assert rec["rel_err"] < tol and "timer" not in rec
    assert rec["seconds_per_iter"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name,argv", [("cg", ["24"]),
                                       ("convection_ilu", ["24", "0.02"]),
                                       ("pagerank", ["3000"])])
def test_example_main_on_card(cuda, name, argv, capsys):
    import importlib

    mod = importlib.import_module(f"sblas_torch.examples.{name}")
    assert mod.main(argv) == 0
    assert len(capsys.readouterr().out.splitlines()) >= 2


@pytest.mark.cuda
def test_dist_world_of_one_on_card(cuda):
    # a world of one rank runs NCCL on the card; the row plans give the
    # single-device plan's bits (the shard is the whole matrix, its kernel
    # the same launch), and the csr kernel launched for it
    import torch.distributed as dist

    from sblas_torch.parallel import DistSpmvPlan, make_mesh

    a = datasets.emulate("cant", dtype=np.float32)
    x, y = _vec(a.shape[1], 1), _vec(a.shape[0], 2)
    mesh = make_mesh()
    try:
        assert (mesh.backend, mesh.transport) == ("nccl", "nccl")
        one = sblas_torch.SpmvPlan(a, "auto", device=cuda)(x, 2.5, -0.5, y)
        for strategy in ("even_rows", "nnz_balanced"):
            before = kern.LAUNCHES
            plan = DistSpmvPlan(a, mesh, strategy=strategy)
            assert plan.local_method == "csr"
            got = plan(x, 2.5, -0.5, y)
            assert kern.LAUNCHES > before
            assert torch.equal(got, one)
        got = DistSpmvPlan(a, mesh, strategy="nnz_split")(x, 2.5, -0.5, y)
        assert rel_err(got.cpu().numpy(),
                       spmv_golden(a, x, 2.5, -0.5, y)) < 2e-5
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dist_sptrsv_world_of_one_on_card(cuda, dtype):
    # at one rank the dist solve is one batch on the sync-free kernel: the
    # single-device plan's bits, lower and upper, one and K columns
    import torch.distributed as dist

    from sblas_torch.parallel import DistSptrsmPlan, DistSptrsvPlan, make_mesh

    low = datasets.cholesky_factor(datasets.poisson2d_nd(
        40, dtype=np.float64), dtype=np.float64).astype(dtype)
    rng = np.random.default_rng(4)
    b = rng.standard_normal(low.shape[0]).astype(dtype)
    bk = rng.standard_normal((low.shape[0], 6)).astype(dtype)
    mesh = make_mesh()
    try:
        for lower, l in ((True, low), (False, csr_transpose(low))):
            before = skern.LAUNCHES + skern.LAUNCHES_F64
            plan = DistSptrsvPlan(l, mesh, lower=lower)
            assert plan.nbatches == 1
            one = sblas_torch.SptrsvPlan(l, lower=lower, device=cuda)
            assert torch.equal(plan(b), one(b))
            assert skern.LAUNCHES + skern.LAUNCHES_F64 > before
            got = DistSptrsmPlan(l, mesh, lower=lower)(bk)
            assert torch.equal(got, sblas_torch.SptrsmPlan(
                l, lower=lower, device=cuda)(bk))
            assert rel_err(got.cpu().numpy(), sptrsm_golden(
                l, bk, lower=lower)) < (1e-3 if dtype == np.float32
                                        else 1e-10)
    finally:
        dist.destroy_process_group()


def test_chip_smoke_fails_without_a_card(tmp_path):
    # alone in a directory, or on a machine where torch sees no card, the
    # smoke run exits non-zero and prints no result line
    import shutil
    import subprocess
    import sys
    from pathlib import Path

    script = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    shutil.copy(script, tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_imports_only_the_port():
    import re
    from pathlib import Path

    src = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    imports = re.findall(r"^\s*(?:from|import)\s+([\w.]+)", src, re.M)
    assert "sblas_torch" in imports
    assert not [m for m in imports
                if m.split(".")[0] in ("jax", "jaxlib", "sblas")], imports
