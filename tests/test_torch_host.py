"""The port's own host layer against the JAX package's, on the same seeds.

The port copies ``formats`` (``has_full_diagonal`` too), ``io``,
``datasets`` (and ``examples/convection_ilu.py``'s ``convection_diffusion``),
``golden``, ``retile``, ``retile_bsr``, ``reorder``, ``hub_relabel``
(``relabel``), ``sptrsv_schedule``, ``partition`` (and
``validate_partition``'s refusals) and the solvers' plain factorizations
instead of importing them, and computes the solves' dependency levels
itself (``levels``, where the JAX package has a native sweep). These tests
hold every copy
to the original: the same generator seeds give the same arrays, the same
retilings give the same layouts, and a matrix written by one package reads
back identically in the other. No tolerance: the arrays must be equal.
"""

import gzip
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import sblas
import sblas_torch
from sblas import datasets as ref_ds
from sblas import golden as ref_golden
from sblas import partition as ref_partition
from sblas import native as ref_native
from sblas import sptrsv_schedule as ref_sched
from sblas import io as ref_io
from sblas import retile as ref_retile
from sblas import reorder as ref_reorder
from sblas import retile_bsr as ref_bsr
from sblas.ops.kernels import spmv_pseg as ref_pseg
from sblas_torch import (datasets, golden, io, levels, partition, relabel,
                         reorder, retile, retile_bsr, sptrsv_schedule)
from sblas_torch.formats import CSC, CSR, from_reference, has_full_diagonal

ROOT = Path(__file__).resolve().parents[1]

GENERATORS = {
    "emulate(cant,0.01)": lambda d: d.emulate("cant", scale=0.01),
    "emulate(uk-2002,1e-4)": lambda d: d.emulate("uk-2002", scale=1e-4),
    "random_csr(skew)": lambda d: d.random_csr(300, 200, 6, skew=0.8, seed=3),
    "random_csr(band,f64)": lambda d: d.random_csr(
        256, 256, 9, bandwidth=20, seed=4, dtype=np.float64),
    "banded": lambda d: d.banded(300, 5, seed=1),
    "powerlaw_graph": lambda d: d.powerlaw_graph(2000, 12, seed=5),
    "lower_triangular": lambda d: d.lower_triangular(
        400, 6, bandwidth=30, seed=2),
    "poisson2d_nd": lambda d: d.poisson2d_nd(12),
    "spd_diag_dominant": lambda d: d.spd_diag_dominant(200, 6, seed=8),
}


def _same_csr(p, r):
    assert type(p) is CSR
    assert tuple(p.shape) == tuple(r.shape)
    for name in ("indptr", "indices", "data"):
        got, want = getattr(p, name), getattr(r, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("name", list(GENERATORS))
def test_generators_match(name):
    _same_csr(GENERATORS[name](datasets), GENERATORS[name](ref_ds))


def test_ell_layouts_match():
    r = ref_ds.random_csr(500, 400, 10, skew=1.0, seed=7)
    p = from_reference(r)
    pe, re_ = retile.to_ell(p), ref_retile.to_ell(r)
    assert (pe.m, pe.n, pe.width, pe.nnz) == (re_.m, re_.n, re_.width, re_.nnz)
    np.testing.assert_array_equal(pe.col, re_.col)
    np.testing.assert_array_equal(pe.val, re_.val)
    for max_width in (None, 16):
        pb = retile.to_bucket_ell(p, max_width=max_width)
        rb = ref_retile.to_bucket_ell(r, max_width=max_width)
        np.testing.assert_array_equal(pb.perm, rb.perm)
        assert len(pb.buckets) == len(rb.buckets)
        for x, y in zip(pb.buckets, rb.buckets):
            assert x.width == y.width
            np.testing.assert_array_equal(x.col, y.col)
            np.testing.assert_array_equal(x.val, y.val)


@pytest.mark.parametrize("br", [128, 64])
def test_pack_bsr_matches(br):
    r = ref_ds.emulate("cant", scale=0.05)
    p = from_reference(r)
    pb = retile_bsr.pack_bsr(p, br=br)
    rb = ref_bsr.pack_bsr(r, br=br, cache=False)
    for name in ("m", "n", "nnz", "br", "bc", "nblocks", "num_brows",
                 "num_bcols"):
        assert getattr(pb, name) == getattr(rb, name), name
    for name in ("blocks", "brow", "bcol"):
        np.testing.assert_array_equal(getattr(pb, name), getattr(rb, name))
    assert pb.density == rb.density
    # the port's extensions: CSR pointers over the blocks, and the blocks
    # transposed
    assert pb.bptr.dtype == np.int32 and pb.bptr.shape == (pb.num_brows + 1,)
    np.testing.assert_array_equal(np.repeat(np.arange(pb.num_brows),
                                            np.diff(pb.bptr)), pb.brow)
    bt = pb.blocks_t()
    assert bt.shape == (pb.nblocks, pb.bc, pb.br) and bt.flags.c_contiguous
    np.testing.assert_array_equal(bt, pb.blocks.transpose(0, 2, 1))


def test_pack_bsr_without_entries_has_no_blocks():
    e = CSR((300, 200), np.zeros(301, np.int32), np.zeros(0, np.int32),
            np.zeros(0, np.float32))
    b = retile_bsr.pack_bsr(e)
    assert b.nblocks == 0 and b.blocks.shape == (0, 128, 128)
    np.testing.assert_array_equal(b.bptr, np.zeros(4, np.int32))


@pytest.mark.parametrize("br", [128, 64])
@pytest.mark.parametrize("name", ["emulate(cant,0.01)", "powerlaw_graph",
                                  "random_csr(skew)"])
def test_bsr_stats_match(name, br):
    r = GENERATORS[name](ref_ds)
    assert retile_bsr.bsr_stats(from_reference(r), br=br) == \
        ref_bsr.bsr_stats(r, br=br)


def test_rcm_matches():
    base = ref_ds.random_csr(600, 600, 12, bandwidth=30, seed=21)
    p = np.random.default_rng(22).permutation(600)
    s = base.to_scipy().tocsr()[p][:, p].tocsr()
    s.sort_indices()
    r = type(base).from_scipy(s)
    pa, pperm = reorder.rcm(from_reference(r))
    ra, rperm = ref_reorder.rcm(r)
    np.testing.assert_array_equal(pperm, rperm)
    _same_csr(pa, ra)
    y = np.random.default_rng(3).standard_normal(600)
    np.testing.assert_array_equal(reorder.unpermute(y, pperm),
                                  ref_reorder.unpermute(y, rperm))
    with pytest.raises(ValueError, match="square"):
        reorder.rcm(datasets.random_csr(30, 20, 3, seed=1))


@pytest.mark.parametrize("name", ["emulate(uk-2002,1e-4)", "powerlaw_graph",
                                  "banded"])
def test_hub_relabel_matches(name):
    # a graph relabels; a band of 3000 columns has no hubs (its top 256
    # columns hold under 10% of the nonzeros) and keeps the identity
    r = ref_ds.banded(3000, 5, seed=1) if name == "banded" \
        else GENERATORS[name](ref_ds)
    pa, pcol, prow = relabel.hub_relabel(from_reference(r))
    ra, rcol, rrow = ref_pseg.hub_relabel(r)
    np.testing.assert_array_equal(pcol, rcol)
    np.testing.assert_array_equal(prow, rrow)
    _same_csr(pa, ra)
    identity = np.array_equal(pcol, np.arange(r.shape[1]))
    assert identity == (name == "banded")
    assert relabel.HUB_COLS == ref_pseg.HUB_PANELS * ref_pseg.LANES


TRIANGLES = {
    "lower_triangular(band)": lambda d: d.lower_triangular(
        500, 6, bandwidth=40, seed=2),
    "lower_triangular(random)": lambda d: d.lower_triangular(300, 5, seed=3),
    "cholesky_factor(poisson2d_nd(20))": lambda d: d.cholesky_factor(
        d.poisson2d_nd(20, dtype=np.float64)),
    "chain": lambda d: d.lower_triangular(64, 2, bandwidth=1, seed=0),
}


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("name", list(TRIANGLES))
def test_levels_match_the_native_sweep(name, lower):
    r = TRIANGLES[name](ref_ds)
    if not lower:
        r = _ref_transpose(r)
    p = from_reference(r)
    lv, nl = levels.level_schedule(p.indptr, p.indices, p.shape[0],
                                   lower=lower)
    rlv, rnl = ref_native.level_schedule(r.indptr, r.indices, r.shape[0],
                                         lower=lower)
    assert lv.dtype == np.int32 and nl == rnl
    np.testing.assert_array_equal(lv, rlv)
    # the side not asked for is ignored: the full matrix gives the same
    full = r.to_scipy() + r.to_scipy().T
    fp = sblas_torch.CSR.from_scipy(full)
    flv, fnl = levels.level_schedule(fp.indptr, fp.indices, fp.shape[0],
                                     lower=lower)
    assert fnl == rnl
    np.testing.assert_array_equal(flv, rlv)


def _ref_transpose(r):
    from sblas.formats import csr_transpose

    return csr_transpose(r)


@pytest.mark.parametrize("tile_rows", [0, 8])
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("name", list(TRIANGLES))
def test_level_schedule_matches(name, lower, tile_rows):
    r = TRIANGLES[name](ref_ds)
    if not lower:
        r = _ref_transpose(r)
    ps = sptrsv_schedule.build_level_schedule(from_reference(r), lower=lower,
                                              tile_rows=tile_rows)
    rs = ref_sched.build_level_schedule(r, lower=lower, tile_rows=tile_rows)
    for f in ("n", "nnz", "tile_rows", "width", "nlevels", "num_tiles",
              "padded_slots"):
        assert getattr(ps, f) == getattr(rs, f), f
    for f in ("slot_row", "col", "val", "inv_diag", "level_of_tile",
              "levels"):
        got, want = getattr(ps, f), getattr(rs, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    sptrsv_schedule.validate_schedule(ps)


def test_validate_schedule_finds_a_broken_schedule():
    l = datasets.lower_triangular(64, 4, seed=1)
    s = sptrsv_schedule.build_level_schedule(l, tile_rows=8)
    broken = sptrsv_schedule.LevelSchedule(
        **{**{f: getattr(s, f) for f in (
            "n", "nnz", "tile_rows", "width", "nlevels", "col", "val",
            "inv_diag", "level_of_tile", "levels")},
           "slot_row": s.slot_row[::-1].copy()})
    with pytest.raises(ValueError, match="dependencies"):
        sptrsv_schedule.validate_schedule(broken)


def test_mtx_round_trip_across_packages(tmp_path):
    a = datasets.random_csr(60, 45, 5, seed=9, dtype=np.float64)
    io.write_mtx(tmp_path / "a.mtx", a)
    _same_csr(io.read_mtx(tmp_path / "a.mtx"), a)
    _same_csr(io.read_mtx(tmp_path / "a.mtx"),
              ref_io.read_mtx(tmp_path / "a.mtx"))
    ref_io.write_mtx(tmp_path / "b.mtx", ref_ds.banded(40, 3, seed=2))
    _same_csr(io.read_mtx(tmp_path / "b.mtx", dtype=np.float32),
              ref_io.read_mtx(tmp_path / "b.mtx", dtype=np.float32))


@pytest.mark.parametrize("field,symmetry", [
    ("real", "symmetric"), ("integer", "skew-symmetric"),
    ("pattern", "general"), ("complex", "hermitian")])
def test_mtx_fields_and_symmetries_match(tmp_path, field, symmetry):
    rows = [(1, 1), (3, 1), (4, 2), (4, 4)]
    if symmetry == "skew-symmetric":
        rows = [rc for rc in rows if rc[0] != rc[1]]
    vals = {"real": " 2.5", "integer": " 3", "pattern": "",
            "complex": " 1.5 -0.5"}[field]
    body = "".join(f"{i} {j}{vals}\n" for i, j in rows)
    path = tmp_path / "m.mtx.gz"
    with gzip.open(path, "wt") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} {symmetry}\n"
                f"% a comment\n4 4 {len(rows)}\n{body}")
    _same_csr(io.read_mtx(path), ref_io.read_mtx(path))


@pytest.mark.parametrize("name", ["poisson2d_nd", "spd_diag_dominant",
                                  "random_csr(skew)", "lower_triangular"])
def test_has_full_diagonal_matches(name):
    from sblas.formats import COO as RefCOO
    from sblas.formats import has_full_diagonal as ref_has_full_diagonal

    r = GENERATORS[name](ref_ds)
    assert has_full_diagonal(from_reference(r)) == ref_has_full_diagonal(r)
    # without the (5, 5) entry
    coo = r.tocoo()
    keep = ~((coo.row == coo.col) & (coo.row == 5))
    dropped = RefCOO(r.shape, coo.row[keep], coo.col[keep],
                     coo.data[keep]).tocsr()
    assert not has_full_diagonal(from_reference(dropped))
    assert not ref_has_full_diagonal(dropped)


def _same_bits(p, r):
    """``_same_csr``, the values compared bit for bit (``-0.0`` is not
    ``+0.0``)."""
    _same_csr(p, r)
    assert p.data.view(np.uint8).tobytes() == r.data.view(np.uint8).tobytes()


def _from_rows(shape, rows, cols, vals):
    """A CSR of the entries in the order given within each row (unsorted
    and duplicated columns kept)."""
    rows = np.asarray(rows, np.int64)
    order = np.argsort(rows, kind="stable")
    indptr = np.concatenate([[0], np.cumsum(np.bincount(
        rows, minlength=shape[0]))])
    return CSR(shape, indptr, np.asarray(cols)[order],
               np.asarray(vals)[order])


def _empty_rows(dtype):
    # the first, the last and every fourth row hold nothing
    a = datasets.random_csr(60, 60, 7, seed=6, dtype=dtype).tocoo()
    keep = (a.row % 4 != 1) & (a.row > 0) & (a.row < 59)
    return _from_rows(a.shape, a.row[keep], a.col[keep], a.data[keep])


def _negative_zero(dtype):
    # a stored -0.0 below, on and above the diagonal
    a = datasets.poisson2d(9, dtype=dtype)
    data = a.data.copy()
    data[::3] = -0.0
    return CSR(a.shape, a.indptr, a.indices, data)


CANONICAL = {
    "poisson2d": lambda dt: datasets.poisson2d(12, dtype=dt),
    "random_csr(60x90)": lambda dt: datasets.random_csr(60, 90, 9, seed=2,
                                                        dtype=dt),
    "empty_rows": _empty_rows,
    "negative_zero": _negative_zero,
    "nnz=0": lambda dt: CSR((7, 5), np.zeros(8, np.int32),
                            np.zeros(0, np.int32), np.zeros(0, dt)),
}


def _unsorted(dtype):
    a = datasets.random_csr(50, 50, 6, seed=3, dtype=dtype)
    return _from_rows(a.shape, a.row_ids()[::-1], a.indices[::-1],
                      a.data[::-1])


def _duplicated(dtype):
    # entries stored twice, with -0.0 among them, in row order
    a = _negative_zero(dtype).tocoo()
    return _from_rows(a.shape, np.concatenate([a.row, a.row[::5]]),
                      np.concatenate([a.col, a.col[::5]]),
                      np.concatenate([a.data, a.data[::5]]))


NOT_CANONICAL = {"unsorted": _unsorted, "duplicated": _duplicated}


def _negative_zeros(data) -> int:
    return int((np.signbit(data) & (data == 0)).sum())


def _coo_to_csr_under_triangles() -> int:
    from sblas_torch import trace

    return sum(1 for name, _, parent, _, _ in trace.totals()["spans"]
               if name == "sblas.coo_to_csr"
               and parent in ("sblas.tril", "sblas.triu"))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [-1, 0, 1])
@pytest.mark.parametrize("name", [*CANONICAL, *NOT_CANONICAL])
def test_tril_triu_equal_the_sort_path_and_the_reference(name, k, dtype):
    # a canonical CSR is masked row by row, any other goes the COO round
    # trip; both give the sort path's bits and the JAX package's
    from sblas import formats as ref_formats
    from sblas_torch import formats, trace

    a = {**CANONICAL, **NOT_CANONICAL}[name](dtype)
    assert formats._canonical(a) == (name in CANONICAL)
    r = ref_formats.CSR(a.shape, a.indptr, a.indices, a.data)
    trace.reset()
    for unit in (False, True):
        got = formats.tril(a, k, unit_diagonal=unit)
        _same_bits(got, formats.tril_plain(a, k, unit_diagonal=unit))
        _same_bits(got, ref_formats.tril(r, k, unit_diagonal=unit))
        assert _negative_zeros(got.data) == 0
    got = formats.triu(a, k)
    _same_bits(got, formats.triu_plain(a, k))
    _same_bits(got, ref_formats.triu(r, k))
    # tril twice through coo_to_csr with unit_diagonal, once without; triu
    # once
    assert _coo_to_csr_under_triangles() == \
        (0 if name in CANONICAL else 4)
    assert (_negative_zeros(a.data) > 0) == ("zero" in name or
                                             name == "duplicated")


def _transposed(name, dtype):
    if name in CANONICAL:
        return CANONICAL[name](dtype)
    if name in NOT_CANONICAL:
        return NOT_CANONICAL[name](dtype)
    if name == "empty_columns":
        a = datasets.random_csr(40, 70, 5, seed=8, dtype=dtype).tocoo()
        keep = (a.col % 3 != 0) & (a.col < 60)
        return _from_rows(a.shape, a.row[keep], a.col[keep], a.data[keep])
    return CSR((0, 0), np.zeros(1, np.int32), np.zeros(0, np.int32),
               np.zeros(0, dtype))


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex128])
@pytest.mark.parametrize("name", [*CANONICAL, *NOT_CANONICAL,
                                  "empty_columns", "0x0"])
def test_native_transpose_equals_the_stable_sort(name, dtype):
    from sblas import formats as ref_formats
    from sblas_torch import formats

    a = _transposed(name, dtype)
    got = formats.csr_transpose(a)
    assert got.shape == a.shape[::-1]
    _same_bits(got, formats.csr_transpose_plain(a))
    r = ref_formats.CSR(a.shape, a.indptr, a.indices, a.data)
    _same_bits(got, ref_formats.csr_transpose(r))
    # and back
    _same_bits(formats.csr_transpose(got), formats.csr_transpose_plain(got))


def test_native_transpose_refuses_what_it_cannot_read():
    from sblas_torch import formats

    with pytest.raises(ValueError, match="outside"):
        formats.csr_transpose(CSR((2, 3), [0, 1, 2], [0, 3], [1.0, 2.0]))
    with pytest.raises(ValueError, match="indptr"):
        formats.csr_transpose(CSR((2, 3), [0, 2, 1], [0, 1], [1.0, 2.0]))
    with pytest.raises(ValueError, match="indptr"):
        formats.csr_transpose(CSR((2, 3), [0, 1, 1], [0, 1], [1.0, 2.0]))


@pytest.mark.parametrize("fault", ["missing", "missing(7 rows)", "zero"])
def test_diagonal_raises_as_before(fault):
    # the message names the missing rows, the first five in order, as the
    # JAX package's schedule does
    l = datasets.lower_triangular(40, 4, seed=2, dtype=np.float64).tocoo()
    drop = {"missing": [17, 3], "missing(7 rows)": [30, 2, 9, 4, 21, 5, 11],
            "zero": []}[fault]
    keep = ~((l.row == l.col) & np.isin(l.row, drop))
    data = l.data.copy()
    if fault == "zero":
        data[(l.row == l.col) & (l.row == 12)] = 0.0
    p = _from_rows(l.shape, l.row[keep], l.col[keep], data[keep])
    want = ("zero diagonal entry; matrix is singular" if not drop else
            f"{len(drop)} rows have no diagonal entry (first: "
            f"{np.sort(drop)[:5]}); pass unit_diagonal=True or fix L")
    with pytest.raises(ValueError) as err:
        sptrsv_schedule.diagonal(p)
    assert str(err.value) == want
    from sblas.formats import CSR as RefCSR

    r = RefCSR(p.shape, p.indptr, p.indices, p.data)
    with pytest.raises(ValueError) as ref_err:
        ref_sched.build_level_schedule(r)
    assert str(ref_err.value) == want
    np.testing.assert_array_equal(
        sptrsv_schedule.diagonal(p, unit_diagonal=True), np.ones(40))


@pytest.mark.parametrize("eps", [0.01, 0.05])
@pytest.mark.parametrize("nx", [12, 32])
def test_convection_diffusion_matches_the_example(nx, eps):
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        from convection_ilu import convection_diffusion as example
    finally:
        sys.path.remove(str(ROOT / "examples"))
    r = example(nx, eps)
    _same_csr(datasets.convection_diffusion(nx, eps), r)
    p64 = datasets.convection_diffusion(nx, eps, dtype=np.float64)
    assert p64.dtype == np.float64
    np.testing.assert_array_equal(p64.data.astype(np.float32), r.data)


@pytest.mark.parametrize("kind", ["ic0", "ilu0"])
def test_plain_factorizations_match(kind):
    from sblas import formats as ref_formats
    from sblas import solvers as ref_solvers
    from sblas_torch import solvers

    if kind == "ic0":
        a = ref_formats.tril(ref_ds.spd_diag_dominant(300, 6, seed=11,
                                                      dtype=np.float64))
    else:
        a = ref_ds.random_csr(300, 300, 8, bandwidth=30, seed=5,
                              dtype=np.float64)
        s = a.to_scipy().tolil()
        s.setdiag(np.abs(s).sum(axis=1).A1 + 1.0)
        a = ref_formats.CSR.from_scipy(s.tocsr())
    name = f"_{kind}_numpy"
    port, theirs = a.data.copy(), a.data.copy()
    assert getattr(solvers, name)(a.indptr, a.indices, port) == \
        getattr(ref_solvers, name)(a.indptr, a.indices, theirs) == 0
    np.testing.assert_array_equal(port, theirs)


def test_goldens_match():
    a = datasets.random_csr(80, 60, 5, seed=1)
    r = ref_ds.random_csr(80, 60, 5, seed=1)
    x = np.random.default_rng(2).standard_normal((60, 3)).astype(np.float32)
    y = np.random.default_rng(3).standard_normal((80, 3)).astype(np.float32)
    np.testing.assert_array_equal(golden.spmm_golden(a, x, 2.0, 0.5, y),
                                  ref_golden.spmm_golden(r, x, 2.0, 0.5, y))
    l = datasets.lower_triangular(50, 4, seed=3)
    b = np.random.default_rng(4).standard_normal(50)
    np.testing.assert_array_equal(golden.sptrsv_golden(l, b),
                                  ref_golden.sptrsv_golden(
                                      ref_ds.lower_triangular(50, 4, seed=3),
                                      b))
    assert golden.rel_err(x, x + 1e-3) == ref_golden.rel_err(x, x + 1e-3)
    for dt in (np.float64, np.float32, np.float16):
        assert golden.default_tol(dt) == ref_golden.default_tol(dt)


PARTITIONED = ("emulate(cant,0.01)", "emulate(uk-2002,1e-4)",
               "random_csr(skew)", "powerlaw_graph")


@pytest.mark.parametrize("ndev", [1, 2, 3, 8])
@pytest.mark.parametrize("name", PARTITIONED)
def test_partitions_match(name, ndev):
    a, r = GENERATORS[name](datasets), GENERATORS[name](ref_ds)
    for strategy in ("even_rows", "nnz_balanced"):
        p = partition.partition_rows(a, ndev, strategy)
        q = ref_partition.partition_rows(r, ndev, strategy)
        assert (p.ndev, p.strategy) == (q.ndev, q.strategy)
        np.testing.assert_array_equal(p.row_starts, q.row_starts)
        np.testing.assert_array_equal(p.nnz_counts, q.nnz_counts)
        assert p.balance() == q.balance()
        for pp, qq in zip(p.parts, q.parts, strict=True):
            _same_csr(pp, qq)
        partition.validate_partition(a, p)
    p = partition.partition_nnz_split(a, ndev)
    q = ref_partition.partition_nnz_split(r, ndev)
    for field in ("nnz_starts", "first_row", "last_row"):
        np.testing.assert_array_equal(getattr(p, field), getattr(q, field))
    for pp, qq in zip(p.parts, q.parts, strict=True):
        _same_csr(pp, qq)
    with pytest.raises(ValueError, match="unknown strategy"):
        partition.partition_rows(a, ndev, "rows")


def _broken(mod, a, how):
    part = mod.partition_rows(a, 3, "even_rows")
    if how == "rows":
        starts = part.row_starts.copy()
        starts[-1] -= 1
        return mod.RowPartition(3, part.strategy, starts, part.parts)
    if how == "nnz":
        return mod.RowPartition(3, part.strategy, part.row_starts,
                                part.parts[:2] + part.parts[:1])
    p0, p1, p2 = part.parts               # equal shapes, other columns
    return mod.RowPartition(3, part.strategy, part.row_starts, (p1, p0, p2))


@pytest.mark.parametrize("how", ["rows", "nnz", "parts"])
def test_validate_partition_refuses_as_the_reference(how):
    a, r = datasets.random_csr(90, 70, 5, seed=6), ref_ds.random_csr(
        90, 70, 5, seed=6)
    with pytest.raises(AssertionError):
        ref_partition.validate_partition(r, _broken(ref_partition, r, how))
    with pytest.raises(AssertionError):
        partition.validate_partition(a, _broken(partition, a, how))


def test_from_reference_shares_the_arrays():
    r = ref_ds.random_csr(30, 20, 4, seed=0)
    p = from_reference(r)
    assert type(p) is CSR and p.shape == (30, 20)
    assert np.shares_memory(p.indices, r.indices)
    assert np.shares_memory(p.data, r.data)
    assert from_reference(p) is p
    c = from_reference(r.tocsc())
    assert type(c) is CSC
    np.testing.assert_array_equal(c.tocsr().indices, r.indices)
    with pytest.raises(TypeError, match="shape, indptr"):
        from_reference(np.eye(3))


@pytest.mark.parametrize("entry", ["SpmvPlan", "SpmmPlan", "spmv", "spmm",
                                   "SptrsvPlan", "SptrsmPlan", "sptrsv",
                                   "sptrsm"])
def test_entry_points_refuse_the_reference_class(entry):
    r = ref_ds.random_csr(16, 16, 3, seed=1) if "trs" not in entry.lower() \
        else ref_ds.lower_triangular(16, 3, seed=1)
    x = np.ones((16, 2) if entry.startswith(("spmm", "SpmmPlan", "sptrsm",
                                             "SptrsmPlan")) else 16,
                np.float32)
    call = getattr(sblas_torch, entry)
    args = (r,) if entry[0] == "S" else (r, x)
    with pytest.raises(TypeError, match="from_reference"):
        call(*args, device="cpu")


def test_the_port_imports_nothing_of_the_jax_package():
    pattern = re.compile(r"^\s*(from|import)\s+(sblas|jax|jaxlib)\b", re.M)
    files = [*sorted((ROOT / "sblas_torch").rglob("*.py")),
             ROOT / "chip_smoke.py"]
    assert len(files) > 10
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in pattern.finditer(f.read_text())]
    assert not hits, hits


_SCRIPT = """
import sys
import numpy as np
import sblas_torch
from sblas_torch import datasets, golden

a = datasets.emulate("cant", scale=0.02)
n = a.shape[1]
x = np.random.default_rng(0).standard_normal((n, 4)).astype(np.float32)
assert golden.rel_err(sblas_torch.spmv(a, x[:, 0], device="cpu").numpy(),
                      golden.spmv_golden(a, x[:, 0])) < 2e-5
for method in ("block", "spmv_passes", "merge", "pseg", "pallas"):
    out = sblas_torch.spmm(a, x, method=method, device="cpu").numpy()
    assert golden.rel_err(out, golden.spmm_golden(a, x)) < 2e-5, method
l = datasets.cholesky_factor(datasets.poisson2d_nd(12, dtype=np.float64))
b = x[:l.shape[0]]
for method in ("auto", "tiles", "jacobi"):
    out = sblas_torch.sptrsv(l, b[:, 0], method=method, device="cpu").numpy()
    assert golden.rel_err(out, golden.sptrsv_golden(l, b[:, 0])) < 2e-4
    out = sblas_torch.sptrsm(l, b, trans=True, method=method,
                             device="cpu").numpy()
    assert golden.rel_err(out, golden.sptrsm_golden(
        sblas_torch.csr_transpose(l), b, lower=False)) < 2e-4
from sblas_torch import solvers
p = datasets.poisson2d(16, dtype=np.float64)
r = np.random.default_rng(1).standard_normal(256)
for m in (None, solvers.ichol(p, device="cpu")):
    xs, info = solvers.cg(p, r, tol=1e-10, M=m, device="cpu")
    assert info["rel_residual"] < 1e-10, info
c = datasets.convection_diffusion(16, dtype=np.float64)
xs, info = solvers.gmres(c, r, tol=1e-10, M=solvers.ilu(c, device="cpu"),
                         device="cpu")
assert info["rel_residual"] < 1e-10, info
print("MODULES", sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "sblas")))
"""


def test_spmv_and_spmm_leave_the_jax_package_unloaded():
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "MODULES []" in out.stdout, out.stdout


_ENTRY_SCRIPT = """
import contextlib, io, sys, tempfile
from pathlib import Path
from sblas_torch import cli, datasets
from sblas_torch.benchmarks import run_suite
from sblas_torch.examples import cg, convection_ilu, pagerank

with contextlib.redirect_stdout(io.StringIO()):
    for argv in (["spmv", "--matrix", "poisson:8", "--iters", "4"],
                 ["sptrsm", "--matrix", "chol:poisson:8", "--iters", "4"],
                 ["solve", "--matrix", "poisson:8", "--precond", "ilu",
                  "--solver", "gmres"],
                 ["stream"]):
        assert cli.main(["--device", "cpu", *argv]) == 0, argv
    # the suite's cant at a small size (its table is the one name it reads)
    run_suite.fem_cases = lambda: {"cant": lambda: datasets.banded(300, 5)}
    with tempfile.TemporaryDirectory() as d:
        assert run_suite.main(["--device", "cpu", "--quick", "--case", "cant",
                               "--out", str(Path(d) / "suite.jsonl")]) == 0
    assert cg.main(["8", "--device", "cpu"]) == 0
    assert convection_ilu.main(["8", "--device", "cpu"]) == 0
    assert pagerank.main(["500", "--device", "cpu"]) == 0
print("MODULES", sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "sblas")))
"""


def test_cli_suite_and_examples_leave_the_jax_package_unloaded():
    out = subprocess.run([sys.executable, "-c", _ENTRY_SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "MODULES []" in out.stdout, out.stdout


def test_reference_package_is_the_one_compared():
    # the comparisons above are against the JAX package, not a second copy
    assert Path(sblas.__file__).parent == ROOT / "sblas"
    assert torch.__version__
