"""The scattered slice: the port's SpMV ``merge``/``pseg``/``pseg_big``/``rcm``
and SpMM ``merge``/``pallas``/``pseg`` against the JAX package's, on the same
inputs.

All of them run the port's nnz-balanced kernel (``spmm_csr``; ``rcm`` the
csr kernel); on the CPU its wrapper runs the plain version, and
``spmm_csr_emulate`` runs the kernel's own partition and carry fix-up. The
reference's PSEG and w-SELL Pallas kernels (TPU kernels #2, #3, #4, #8) run
in interpret mode, on matrices small enough for tier-1 (its own tests of
them are marked slow). Matrices come from the JAX package's generators and
reach the port through ``from_reference``; X and Y come from
``np.random.default_rng``. Tolerances (``default_tol``): 2e-5 for f32, port
against reference and each against scipy (the reference's PSEG sums are
exact f32 masked sums); bf16 values: 2e-5 port against reference (both
round the values to nearest even and sum in f32), 2e-2 against scipy.
"""

import hashlib
import time

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sblas import datasets
from sblas import native as ref_native
from sblas.formats import COO, CSR as RefCSR, csr_transpose
from sblas.golden import rel_err, spmm_golden, spmv_golden
from sblas.ops.kernels.spmm_pseg import PallasSpmmScattered
from sblas.ops.spmm import SpmmPlan as RefSpmm
from sblas.ops.spmv import SpmvPlan as RefSpmv
from sblas.retile_pseg import pack_pseg_hybrid
from sblas_torch import relabel
from sblas_torch.formats import from_reference, to_device
from sblas_torch.golden import KERNEL_TOL
from sblas_torch.ops.kernels import spmm_csr as ckern
from sblas_torch.ops.spmm import SpmmPlan, spmm
from sblas_torch.ops.spmv import SpmvPlan, spmv
from test_spmm_kres import GEO, _powerlaw

TOL = 2e-5
BF16_TOL = 2e-2
# how long a worker waits for another's g++ to finish the reference's
# native library, and how often it looks
NATIVE_WAIT_S = 60.0
NATIVE_POLL_S = 0.5


def load_reference_native(wait_s: float = NATIVE_WAIT_S,
                          poll_s: float = NATIVE_POLL_S):
    """The JAX package's native library, loaded.

    ``sblas.native`` compiles its library in place the first time a process
    asks for it; under ``pytest -n`` several workers do so at once, and one
    that finds the file half-written fails to load it and keeps ``None``
    for the rest of its life (``_load_attempted``), so the reference's
    hybrid PSEG pack, and the parity tests that need it, fail by chance.
    This clears that state and tries again until the other worker's g++
    is done; past ``wait_s`` it fails, naming the library.
    """
    deadline = time.monotonic() + wait_s
    while True:
        lib = ref_native._build_and_load()
        if lib is not None:
            return lib
        if time.monotonic() >= deadline:
            tag = hashlib.sha256(ref_native._SRC.read_bytes()).hexdigest()[:12]
            pytest.fail(f"the reference's native library "
                        f"{ref_native._LIB_DIR / f'_sblas_native_{tag}.so'} "
                        f"did not load within {wait_s:.0f} s")
        time.sleep(poll_s)
        ref_native._lib = None
        ref_native._load_attempted = False


@pytest.fixture(scope="module")
def reference_native():
    """The parity tests that build the reference's hybrid PSEG pack need
    its native library: see :func:`load_reference_native`."""
    return load_reference_native()


def _dense(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(y):
    return y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def _held(port, ref, golden, gtol=TOL):
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape == golden.shape
    assert port.dtype == np.float32
    assert rel_err(port, ref) < TOL
    assert rel_err(port, golden) < gtol
    assert rel_err(ref, golden) < gtol


def _uk():
    return datasets.emulate("uk-2002", scale=0.003, dtype=np.float32)


def _long_rows():
    """Rows of 20,000+ nonzeros, empty rows between them and trailing
    (rows >= 300 hold nothing), m != n."""
    rng = np.random.default_rng(0)
    m, n = 1500, 30000
    rows = np.concatenate([np.full(21000, 3), np.full(25000, 200),
                           rng.integers(0, 300, 6000)])
    cols = np.concatenate([rng.permutation(n)[:21000],
                           rng.permutation(n)[:25000],
                           rng.integers(0, n, 6000)])
    a = COO((m, n), rows, cols, _dense(len(rows), 1)).tocsr()
    assert (a.row_lengths >= 21000).sum() == 2
    return a


# (a) SpMV pseg against the reference's PSEG kernel (#2) ------------------

@pytest.mark.parametrize("vdt", ["f32", "bf16"])
def test_spmv_pseg_vs_reference_pseg(vdt):
    a = _uk()
    port_vd, ref_vd = (None, None) if vdt == "f32" else \
        (torch.bfloat16, jnp.bfloat16)
    m, n = a.shape
    x, y0 = _dense(n, 1), _dense(m, 2)
    plan = SpmvPlan(from_reference(a), "pseg", value_dtype=port_vd,
                    device="cpu")
    ref = RefSpmv(a, "pseg", value_dtype=ref_vd)
    assert plan.method == ref.method == "pseg"
    np.testing.assert_array_equal(plan.colperm, ref._pallas.colperm)
    np.testing.assert_array_equal(plan.rowperm, ref._pallas.rowperm)
    gtol = TOL if vdt == "f32" else BF16_TOL
    _held(plan(x, 2.5, -0.5, y0), ref(x, 2.5, -0.5, y0),
          spmv_golden(a, x, 2.5, -0.5, y0), gtol)
    # the same kernel in natural order, as auto runs it
    merge = SpmvPlan(from_reference(a), "merge", value_dtype=port_vd,
                     device="cpu")
    _held(merge(x, 2.5, -0.5, y0), ref(x, 2.5, -0.5, y0),
          spmv_golden(a, x, 2.5, -0.5, y0), gtol)
    # the permuted space: the same x_perm gives the same y_perm
    x_perm = x[plan.colperm]
    y_ref = ref.apply_permuted(ref.device_arrays(), jnp.asarray(x_perm))
    _held(plan.apply_permuted(x_perm), y_ref,
          spmv_golden(a, x)[plan.rowperm], gtol)


def test_spmv_pseg_trans_vs_reference_pseg():
    a = _uk()
    x = _dense(a.shape[0], 3)
    port = spmv(from_reference(a), x, trans=True, method="pseg",
                device="cpu")
    ref = RefSpmv(csr_transpose(a), "pseg")(x)
    _held(port, ref, spmv_golden(csr_transpose(a), x))


@pytest.mark.parametrize("method", ["pseg", "pseg_big", "merge"])
def test_spmv_pseg_rows_above_8192(method):
    # the reference's pseg splits such rows (split_heavy_rows), which its
    # tests run only under `slow`; its coo and bucket routes are the anchors
    a = _long_rows()
    m, n = a.shape
    x, y0 = _dense(n, 4), _dense(m, 5)
    plan = SpmvPlan(from_reference(a), method, device="cpu")
    assert plan.method == ("merge" if method == "merge" else "pseg")
    port = _np(plan(x, 1.5, 0.25, y0))
    golden = spmv_golden(a, x, 1.5, 0.25, y0)
    for ref_method in ("coo", "bucket"):
        _held(port, RefSpmv(a, ref_method)(x, 1.5, 0.25, y0), golden)
    np.testing.assert_array_equal(port[300:], (0.25 * y0)[300:])


def test_spmv_pseg_big_is_the_pseg_plan():
    a = from_reference(_uk())
    x = _dense(a.shape[1], 6)
    big = SpmvPlan(a, "pseg_big", device="cpu")
    pseg = SpmvPlan(a, "pseg", device="cpu")
    assert big.method == pseg.method == "pseg"
    assert "TPU memory" in big.route_reason
    np.testing.assert_array_equal(big.colperm, pseg.colperm)
    assert torch.equal(big(x), pseg(x))


def _scrambled_band():
    base = datasets.random_csr(2000, 2000, 40, bandwidth=60, seed=21,
                               dtype=np.float32)
    p = np.random.default_rng(22).permutation(2000)
    s = base.to_scipy().tocsr()[p][:, p].tocsr()
    s.sort_indices()
    return RefCSR.from_scipy(s).astype(np.float32)


def test_spmv_rcm_vs_reference_rcm():
    a = _scrambled_band()
    x, y0 = _dense(2000, 23), _dense(2000, 24)
    plan = SpmvPlan(from_reference(a), "rcm", device="cpu")
    ref = RefSpmv(a, "rcm", min_fill=0.0)
    assert plan.method == ref.method == "rcm"
    np.testing.assert_array_equal(plan.colperm, np.asarray(ref._rcm_perm))
    _held(plan(x, 2.5, -0.5, y0), ref(x, 2.5, -0.5, y0),
          spmv_golden(a, x, 2.5, -0.5, y0))
    x_perm = x[plan.colperm]
    y_ref = ref.apply_permuted(ref.device_arrays(), jnp.asarray(x_perm))
    _held(plan.apply_permuted(x_perm), y_ref,
          spmv_golden(a, x)[plan.rowperm])


# (b) SpMM pseg against the reference's PSEG kernels (#3, #4) -------------

def _kres_matrix():
    # 3 y groups and 2 tail-Xt chunks at the shrunk geometry
    return _powerlaw(np.random.default_rng(0), 4500, 4500, 6000)


def test_a_worker_whose_first_load_failed_recovers(monkeypatch):
    # the state a worker is left in when another's g++ was still writing
    # the library as it tried to load it
    monkeypatch.setattr(ref_native, "_lib", None)
    monkeypatch.setattr(ref_native, "_load_attempted", True)
    assert ref_native._build_and_load() is None
    assert load_reference_native() is not None
    pk = pack_pseg_hybrid(RefCSR.from_scipy(_kres_matrix()), cache=False)
    assert pk is not None and pk.n_hub_rounds >= 0


@pytest.mark.usefixtures("reference_native")
@pytest.mark.parametrize("k", [3, 8])
def test_spmm_pseg_vs_reference_kres(k):
    a_sp = _kres_matrix()
    a = RefCSR.from_scipy(a_sp)
    ref = PallasSpmmScattered(a, hybrid=True, k_hint=8, th=64, kres=True,
                              kres_geo=GEO)
    assert ref._kres and ref._kres_geo[0] == 3
    assert ref._kranges[0][1]["ck"].max() > 0
    x = _dense((4500, k), 30 + k)
    plan = SpmmPlan(from_reference(a), "pseg", k_hint=k, device="cpu")
    np.testing.assert_array_equal(plan.colperm, ref.colperm)
    np.testing.assert_array_equal(plan.rowperm, ref.rowperm)
    _held(plan(x), ref.apply_pure(ref.device_arrays(), jnp.asarray(x)),
          spmm_golden(a, x))
    x_perm = x[plan.colperm]
    _held(plan.apply_permuted(x_perm),
          ref.apply_permuted(ref.device_arrays(), jnp.asarray(x_perm)),
          spmm_golden(a, x)[plan.rowperm])


@pytest.mark.parametrize("k", [1, 13])
def test_spmm_pseg_odd_k_on_the_kres_matrix(k):
    # the reference compiles a kernel body per K: K = 1 and 13 are held to
    # its bucket route instead
    a = RefCSR.from_scipy(_kres_matrix())
    x, y0 = _dense((4500, k), 40 + k), _dense((4500, k), 41)
    port = SpmmPlan(from_reference(a), "pseg", device="cpu")(
        x, 2.5, -0.5, y0)
    _held(port, RefSpmm(a, "bucket")(x, 2.5, -0.5, y0),
          spmm_golden(a, x, 2.5, -0.5, y0))


@pytest.mark.usefixtures("reference_native")
def test_spmm_pseg_vs_reference_whole_x():
    a_sp = _powerlaw(np.random.default_rng(1), 1200, 2400, 6000)
    a = RefCSR.from_scipy(a_sp)
    ref = PallasSpmmScattered(a, hybrid=True, th=64, kres=False)
    assert not ref._kres
    x = _dense((2400, 8), 50)
    port = SpmmPlan(from_reference(a), "pseg", device="cpu")(x)
    _held(port, ref.apply_pure(ref.device_arrays(), jnp.asarray(x)),
          spmm_golden(a, x))


# (c) SpMM pallas against the reference's w-SELL kernel (#8) --------------

def _cant():
    return datasets.emulate("cant", scale=0.02, dtype=np.float32)


def test_spmm_pallas_vs_reference_wsell():
    a = _cant()
    x, y0 = _dense((a.shape[1], 3), 60), _dense((a.shape[0], 3), 61)
    port = SpmmPlan(from_reference(a), "pallas", k_hint=3, device="cpu")(
        x, 2.5, -0.5, y0)
    ref = RefSpmm(a, "pallas", k_hint=3)
    assert ref.method == "pallas"
    _held(port, ref(x, 2.5, -0.5, y0), spmm_golden(a, x, 2.5, -0.5, y0))


def test_spmm_pallas_is_the_merge_plan():
    a = from_reference(_cant())
    x = _dense((a.shape[1], 4), 63)
    pallas = SpmmPlan(a, "pallas", device="cpu")
    merge = SpmmPlan(a, "merge", device="cpu")
    assert pallas.method == merge.method == "merge"
    assert "w-SELL" in pallas.route_reason
    assert torch.equal(pallas(x), merge(x))


@pytest.mark.parametrize("k", [8, 32])
def test_spmm_pallas_wide_k(k):
    a = _cant()
    x = _dense((a.shape[1], k), 62 + k)
    port = spmm(from_reference(a), x, method="pallas", k_hint=k,
                device="cpu")
    _held(port, RefSpmm(a, "bucket")(x), spmm_golden(a, x))


# (d) every scattered SpMM route on the edges ----------------------------

EDGES = {
    "m!=n": lambda: datasets.random_csr(257, 301, 9, seed=2,
                                        dtype=np.float32),
    "empty rows": lambda: datasets.random_csr(100, 90, 2, seed=4,
                                              dtype=np.float32),
    "nnz=0": lambda: COO((40, 30), np.zeros(0, np.int32),
                         np.zeros(0, np.int32),
                         np.zeros(0, np.float32)).tocsr(),
    "long rows": _long_rows,
}


@pytest.mark.parametrize("method", ["pseg", "pallas"])
@pytest.mark.parametrize("name", list(EDGES))
def test_spmm_scattered_routes_on_edges(method, name):
    a = EDGES[name]()
    m, n = a.shape
    x, y0 = _dense((n, 5), 70), _dense((m, 5), 71)
    port = _np(SpmmPlan(from_reference(a), method, device="cpu")(
        x, 1.5, 0.25, y0))
    golden = spmm_golden(a, x, 1.5, 0.25, y0)
    for ref_method in ("bucket", "ell"):
        _held(port, RefSpmm(a, ref_method)(x, 1.5, 0.25, y0), golden)
    empty = np.flatnonzero(a.row_lengths == 0)
    np.testing.assert_array_equal(port[empty], (0.25 * y0)[empty])


@pytest.mark.parametrize("method", ["pseg", "pallas"])
@pytest.mark.parametrize("case", ["trans", "bf16"])
def test_spmm_scattered_routes_trans_and_bf16(method, case):
    a = datasets.powerlaw_graph(3000, 10, seed=5)
    trans = case == "trans"
    op = csr_transpose(a) if trans else a
    x = _dense((op.shape[1], 8), 72)
    vd = {"value_dtype": torch.bfloat16} if case == "bf16" else {}
    port = spmm(from_reference(a), x, trans=trans, method=method,
                device="cpu", **vd)
    if vd:
        # the reference's bucket route on the values rounded as the port
        # rounds them (to bf16, nearest even)
        rounded = np.asarray(jnp.asarray(op.data).astype(jnp.bfloat16)
                             .astype(jnp.float32))
        ref = RefSpmm(RefCSR(op.shape, op.indptr, op.indices, rounded),
                      "bucket")(x)
    else:
        ref = RefSpmm(op, "bucket")(x)
    _held(port, ref, spmm_golden(op, x), BF16_TOL if vd else TOL)


# (e) the kernel's partition, emulated on the CPU --------------------------

@pytest.mark.parametrize("k", [1, 3, 8, 32])
@pytest.mark.parametrize("name", ["long rows", "powerlaw", "empty rows"])
def test_emulated_partition_matches_the_plain_version(name, k):
    a = from_reference(_long_rows() if name == "long rows" else
                       datasets.powerlaw_graph(300, 12, seed=6)
                       if name == "powerlaw" else EDGES["empty rows"]())
    # shares of a few items: many more shares than rows (300 items on the
    # long rows), and rows cut across 3 or more shares
    op = ckern.prepare(to_device(a, "cpu"), 300 if name == "long rows" else 2)
    m, n = a.shape
    assert op["part"].shape[0] - 1 > (m if name != "long rows" else 90)
    starts = op["part"][:, 0].numpy()
    assert np.bincount(starts, minlength=m + 1).max() >= 3
    assert op["fix"].numel() > 0
    x = torch.from_numpy(_dense((n, k), 80 + k))
    y = torch.from_numpy(_dense((m, k), 81))
    for args in ((2.5, -0.5, y), (1.0, 0.0, None)):
        got = ckern.spmm_csr_emulate(op, x, *args)
        want = ckern.spmm_csr_reference(op, x, *args)
        assert rel_err(got.numpy(), want.numpy()) <= KERNEL_TOL


def _one_long_row():
    """One row of 5,000 nonzeros (several shares of 1,024 items) among
    short and empty rows."""
    rng = np.random.default_rng(12)
    m, n = 700, 6000
    rows = np.concatenate([np.full(5000, 350), rng.integers(0, 300, 2000)])
    cols = np.concatenate([rng.permutation(n)[:5000],
                           rng.integers(0, n, 2000)])
    return COO((m, n), rows, cols, _dense(len(rows), 13)).tocsr()


def _empty_rows():
    """Runs of empty rows, in the middle and trailing."""
    a = datasets.random_csr(400, 300, 6, seed=14, dtype=np.float32)
    coo = a.tocoo()
    keep = ((coo.row < 50) | (coo.row >= 150)) & (coo.row < 300)
    return COO(a.shape, coo.row[keep], coo.col[keep], coo.data[keep]).tocsr()


PARTITION_CASES = {
    "uk-2002@0.003": _uk,
    "empty rows": _empty_rows,
    "one row over several shares": _one_long_row,
}


@pytest.mark.parametrize("unit", [None, 256])
@pytest.mark.parametrize("k", [1, 4, 32])
@pytest.mark.parametrize("name", list(PARTITION_CASES))
def test_lane_runs_and_segmented_scan_match_the_plain_version(name, k, unit):
    # the kernel's shares at its own unit (and a quarter of it): at K = 1
    # the lanes' runs of the merged path and their segmented scan, at any
    # K the carries and the warp-wide fix-up, against the plain version
    a = from_reference(PARTITION_CASES[name]())
    t = to_device(a, "cpu")
    op = ckern.prepare(t) if unit is None else ckern.prepare(t, unit)
    m, n = a.shape
    # both paths of the fix-up: a thread alone on the graph's rows, and the
    # whole warp on a row cut into more than SHORT_FIX + 1 shares
    spans = np.concatenate([(sh["fix"] - sh["fix_lo"]).numpy()[
        sh["fix"].numpy() >= 0] for sh in (op, op["spmv"])])
    if name == "one row over several shares":
        assert spans.max() > ckern.SHORT_FIX
    if name == "uk-2002@0.003":
        assert spans.min() <= ckern.SHORT_FIX
    if name == "empty rows":
        assert (a.row_lengths == 0).any()
    x = torch.from_numpy(_dense((n, k), 60 + k))
    y = torch.from_numpy(_dense((m, k), 61))
    for args in ((2.5, -0.5, y), (1.0, 0.0, None)):
        got = ckern.spmm_csr_emulate(op, x, *args)
        want = ckern.spmm_csr_reference(op, x, *args)
        assert got.dtype == torch.float32
        assert rel_err(got.numpy(), want.numpy()) <= KERNEL_TOL
        golden = spmm_golden(a, x.numpy(), args[0], args[1],
                             None if args[2] is None else args[2].numpy())
        assert rel_err(got.numpy(), golden) < TOL
    empty = np.flatnonzero(a.row_lengths == 0)
    np.testing.assert_array_equal(got.numpy()[empty], 0.0)


def test_long_fixups_take_one_warp_each():
    # the rows cut into more than SHORT_FIX + 1 shares sit at lane 0 of
    # separate fix-up warps; the list is the same set of rows
    a = from_reference(_long_rows())
    t = to_device(a, "cpu")
    part = ckern.merge_path(a.indptr, 7)
    fix = ckern.fixup_units(a.indptr, part)
    lo = ckern.fixup_starts(a.indptr, part, fix)
    op = ckern.prepare(t, 7)
    got_fix, got_lo = op["fix"].numpy(), op["fix_lo"].numpy()
    real = got_fix >= 0
    assert sorted(zip(got_fix[real], got_lo[real])) == sorted(zip(fix, lo))
    assert (got_lo[~real] == -1).all()
    long_at = np.flatnonzero(got_fix - got_lo > ckern.SHORT_FIX)
    assert len(long_at) > 0
    np.testing.assert_array_equal(long_at, np.arange(len(long_at)) *
                                  ckern.WARP)
    assert len(got_fix) == max(len(fix), ckern.WARP * len(long_at))


def test_fixup_starts_are_where_the_cut_rows_begin():
    # fix_lo[f]: the share holding the first nonzero of fix[f]'s first
    # row; every share from there to fix[f] - 1 ends inside that row
    a = from_reference(_one_long_row())
    for unit in (7, 256, 1024):
        op = ckern.prepare(to_device(a, "cpu"), unit)
        part = op["part"].numpy().astype(np.int64)
        for b, lo in zip(op["fix"].tolist(), op["fix_lo"].tolist()):
            if b < 0:
                continue
            r = part[b, 0]
            assert lo < b
            assert part[lo, 0] + part[lo, 1] <= a.indptr[r] + r < \
                part[lo + 1, 0] + part[lo + 1, 1]
            assert (part[lo + 1:b + 1, 0] == r).all()


@pytest.mark.parametrize("k", [1, 8])
def test_permutations_around_the_kernel(k):
    # the pseg plan's drop-in call works in the graph's own order: X[colperm]
    # into the relabeled operand, its row i out to row rowperm[i]
    g = from_reference(datasets.powerlaw_graph(300, 12, seed=6))
    ap, colperm, rowperm = relabel.hub_relabel(g)
    plan = SpmmPlan(g, "pseg", device="cpu")
    assert plan._perms is not None
    np.testing.assert_array_equal(plan.colperm, colperm)
    np.testing.assert_array_equal(plan.rowperm, rowperm)
    rel = ckern.prepare(to_device(ap, "cpu"), 2)
    nat = ckern.prepare(to_device(g, "cpu"))
    m, n = g.shape
    x = torch.from_numpy(_dense((n, k), 90 + k))
    y = torch.from_numpy(_dense((m, k), 91))
    for args in ((2.5, -0.5, y), (1.0, 0.0, None)):
        want = ckern.spmm_csr_reference(nat, x, *args)
        assert rel_err(plan(x, *args).numpy(), want.numpy()) <= KERNEL_TOL
        # the kernel's own partition on the relabeled operand
        yp = None if args[2] is None else args[2][rowperm]
        got = ckern.spmm_csr_emulate(rel, x[colperm], args[0], args[1], yp)
        assert rel_err(got.numpy(), want[rowperm].numpy()) <= KERNEL_TOL
    # no hubs: the identity, and no permutation around the kernel
    band = from_reference(datasets.banded(3000, 5, seed=1))
    assert SpmmPlan(band, "pseg", device="cpu")._perms is None


def test_merge_path_gives_equal_shares():
    a = from_reference(_long_rows())
    indptr = a.indptr.astype(np.int64)
    part = ckern.merge_path(indptr, 1000).astype(np.int64)
    items = part.sum(axis=1)
    assert items[0] == 0 and items[-1] == a.shape[0] + a.nnz
    assert (np.diff(items)[:-1] == 1000).all()
    assert np.all(np.diff(part, axis=0) >= 0)
    # row r's end is consumed in a share iff its item lies before the end
    ends = indptr[1:] + np.arange(a.shape[0])
    assert (np.searchsorted(ends, items, side="left") == part[:, 0]).all()


def test_spmm_csr_wrapper_checks_its_inputs():
    a = from_reference(datasets.random_csr(20, 30, 3, seed=1,
                                           dtype=np.float32))
    raw = to_device(a, "cpu")
    op = ckern.prepare(raw)
    x = torch.from_numpy(_dense((30, 4), 1))
    with pytest.raises(ValueError, match="X must be f32"):
        ckern.spmm_csr(op, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        ckern.spmm_csr(op, x.t().contiguous().t())
    with pytest.raises(ValueError, match="beta"):
        ckern.spmm_csr(op, x, 1.0, 1.0, None)
    with pytest.raises(TypeError, match="int32"):
        ckern.prepare({**raw, "indices": raw["indices"].long()})
    with pytest.raises(ValueError, match="unit"):
        ckern.prepare(raw, 0)
    with pytest.raises(ValueError, match="Y must be f32 of shape"):
        ckern.spmm_csr(op, x, 1.0, 1.0, torch.zeros((20, 5)))
    with pytest.raises(ValueError, match="Y must be f32 of shape"):
        ckern.spmm_csr(op, x, 1.0, 1.0, torch.zeros((21, 4)))
    before = ckern.LAUNCHES
    got = ckern.spmm_csr(op, x, 2.0)
    assert ckern.LAUNCHES == before       # the plain version: no launch
    assert torch.equal(got, ckern.spmm_csr_reference(op, x, 2.0))


# (f) auto's picks -----------------------------------------------------

def test_spmv_auto_picks_csr_on_fem_and_pseg_on_a_graph():
    cant = SpmvPlan(from_reference(datasets.emulate("cant", scale=0.05)),
                    device="cpu")
    assert cant.method == "csr" and cant.route_reason.endswith("-> csr")
    # the nnz-balanced kernel in natural order: relabeling made it no
    # faster on the H100 (PERF.md)
    g = from_reference(datasets.powerlaw_graph(20000, 16, seed=3))
    plan = SpmvPlan(g, device="cpu")
    assert plan.method == "merge" and plan.route_reason.endswith("-> merge")
    assert "longest row" in plan.route_reason
    x = _dense(20000, 9)
    assert rel_err(_np(plan(x)), spmv_golden(g, x)) < TOL


@pytest.mark.parametrize("k", [1, 8, 32])
@pytest.mark.parametrize("name", ["cant", "graph"])
def test_spmm_auto_is_the_cheapest_price(name, k):
    a = from_reference(datasets.emulate("cant", scale=0.05) if name == "cant"
                       else datasets.powerlaw_graph(20000, 16, seed=3))
    plan = SpmmPlan(a, k_hint=k, device="cpu")
    prices = SpmmPlan.prices(a, k)
    routes = ("block", "merge", "spmv_passes")
    assert plan.method == min(routes, key=prices.get)
    for r in routes:
        assert f"{r} {prices[r] / 1e6:.1f} MB" in plan.route_reason
