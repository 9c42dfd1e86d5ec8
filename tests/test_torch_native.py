"""The port's host library's level sweep and MatrixMarket parse
(``sblas_torch/hostsrc/levels.cpp``, ``mtx.cpp``) against their plain
versions (``levels.level_schedule_plain``, ``io.parse_coordinate_plain``)
and the JAX package's (``sblas.native.level_schedule``,
``sblas.io.read_mtx``), on the same arrays and files. No tolerance: the
levels and the parsed arrays must be equal.
"""

import gzip

import numpy as np
import pytest

from sblas import datasets as ref_ds
from sblas import io as ref_io
from sblas import native as ref_native
from sblas_torch import datasets, io, levels, native
from sblas_torch.formats import CSR, from_reference
from test_torch_host import TRIANGLES, _same_csr
from test_torch_scattered import load_reference_native


@pytest.fixture(scope="module")
def ref_lib():
    """The JAX package's native library, loaded: without it its sweep
    falls back to an O(depth * nnz) fixpoint and its reader to numpy."""
    return load_reference_native()


def _csr(n, rows, cols):
    """An ``n x n`` CSR of the entries in the order given (duplicates and
    unsorted columns kept), values 1."""
    rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int32)
    order = np.argsort(rows, kind="stable")
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    return CSR((n, n), indptr.astype(np.int32), cols[order],
               np.ones(len(cols), np.float64))


def _chain(n):
    i = np.arange(n)
    return _csr(n, np.concatenate([i, i[1:]]), np.concatenate([i, i[:-1]]))


def _duplicates():
    # each strict entry stored two or three times, columns unsorted
    rng = np.random.default_rng(4)
    r = rng.integers(1, 300, 2000)
    c = (rng.random(2000) * r).astype(np.int64)
    rows = np.concatenate([r, r, r[:500], np.arange(300)])
    cols = np.concatenate([c, c, c[:500], np.arange(300)])
    perm = rng.permutation(len(rows))
    return _csr(300, rows[perm], cols[perm])


def _empty_rows():
    # every third row has no entry at all (not even its diagonal), and
    # others depend on those rows
    a = datasets.lower_triangular(400, 6, bandwidth=30, seed=2).tocoo()
    keep = a.row % 3 != 1
    return _csr(400, a.row[keep], a.col[keep])


PATTERNS = {
    "chain(50000)": lambda: _chain(50_000),
    "duplicates": _duplicates,
    "empty_rows": _empty_rows,
    "n=0": lambda: CSR((0, 0), np.zeros(1, np.int32), np.zeros(0, np.int32),
                       np.zeros(0)),
    **{name: (lambda make=make: from_reference(make(ref_ds)))
       for name, make in TRIANGLES.items()},
}


def _upper(a):
    t = a.to_scipy().T.tocsr()
    return CSR.from_scipy(t) if a.shape[0] else a


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("name", list(PATTERNS))
def test_native_levels_match_the_plain_loop_and_the_reference(
        name, lower, ref_lib):
    a = PATTERNS[name]()
    if not lower:
        a = _upper(a)
    n = a.shape[0]
    got, nl = levels.level_schedule(a.indptr, a.indices, n, lower=lower)
    plain, pnl = levels.level_schedule_plain(a.indptr, a.indices, n,
                                             lower=lower)
    ref, rnl = ref_native.level_schedule(a.indptr, a.indices, n, lower=lower)
    assert got.dtype == np.int32 and got.shape == (n,)
    assert nl == pnl == rnl
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, ref)
    if name == "chain(50000)":
        np.testing.assert_array_equal(
            got, np.arange(n) if lower else np.arange(n)[::-1])
    if n == 0:
        assert nl == 0


def test_the_plans_call_the_native_sweep(monkeypatch):
    # the sync-free kernel's operand, the tiles schedule and the Jacobi
    # plan reach the sweep through levels.level_schedule, which has no
    # numpy fallback
    calls = []
    real = native.level_sweep

    def counted(*args, **kw):
        calls.append(kw["lower"])
        return real(*args, **kw)

    monkeypatch.setattr(levels, "level_sweep", counted)
    from sblas_torch.ops.kernels import sptrsv_csr
    from sblas_torch.ops.sptrsv_iter import SptrsvJacobiPlan
    from sblas_torch.sptrsv_schedule import build_level_schedule

    l = datasets.lower_triangular(200, 5, bandwidth=20, seed=1,
                                  dtype=np.float64)
    op = sptrsv_csr.prepare(l, "cpu")
    want = levels.level_schedule_plain(l.indptr, l.indices, l.shape[0])
    np.testing.assert_array_equal(op["levels"], want[0])
    assert op["nlevels"] == want[1]
    build_level_schedule(_upper(l), lower=False, tile_rows=8)
    SptrsvJacobiPlan(l, device="cpu")
    assert calls == [True, False, True]


def test_levels_refuse_an_index_outside_the_matrix():
    # a strict-side index the sweep would read levels at, outside [0, n)
    indptr = np.array([0, 1, 2, 4], np.int32)
    with pytest.raises(ValueError, match="outside"):
        levels.level_schedule(indptr, np.array([0, 1, -1, 2], np.int32), 3)
    with pytest.raises(ValueError, match="outside"):
        levels.level_schedule(np.array([0, 2, 3, 4], np.int32),
                              np.array([0, 7, 1, 2], np.int32), 3,
                              lower=False)
    # and an indptr that would send it past the indices
    for bad in ([0, 1, 2, 5], [0, 2, 1, 4], [1, 2, 3, 4]):
        with pytest.raises(ValueError, match="indptr"):
            levels.level_schedule(np.array(bad, np.int32),
                                  np.array([0, 1, 1, 2], np.int32), 3)
    with pytest.raises(ValueError, match="indptr"):
        levels.level_schedule(np.array([0, 1], np.int32),
                              np.array([0], np.int32), 3)


def test_levels_without_gxx_raise(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setenv("PATH", str(tmp_path))
    native.host_tag.cache_clear()
    try:
        l = _chain(5)
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            levels.level_schedule(l.indptr, l.indices, 5)
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            io.parse_coordinate(b"1 1 1.0\n", 1, "real", np.float64)
    finally:
        native.host_tag.cache_clear()


def test_the_transpose_is_built_with_the_host_library():
    assert "transpose.cpp" in {s.name for s in native.sources()}
    assert hasattr(native.load(), "sblas_torch_csr_transpose")


def test_transpose_without_gxx_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setenv("PATH", str(tmp_path))
    native.host_tag.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            _chain(5).tocsc()
    finally:
        native.host_tag.cache_clear()


# (b) the MatrixMarket parse ---------------------------------------------

BODIES = {
    "real": ("real", [(1, 1, "2.5"), (3, 1, "-1e-3"), (4, 2, "+.5"),
                      (4, 4, "3."), (2, 4, "1.2345678901234567e+30"),
                      (2, 2, "-0"), (3, 3, "4.9e-324")]),
    "integer": ("integer", [(1, 1, "3"), (3, 1, "-7"), (4, 2, "12"),
                            (2, 3, "0")]),
    "pattern": ("pattern", [(1, 1, ""), (3, 1, ""), (4, 2, ""), (4, 4, ""),
                            (1, 4, "")]),
}


def _write(path, field, symmetry, entries, *, comment=False, gz=False,
           tabs=False):
    if symmetry != "general":       # the lower triangle only
        entries = [e for e in entries if e[0] > e[1] or
                   (e[0] == e[1] and symmetry != "skew-symmetric")]
    sep = "\t" if tabs else " "
    lines = [sep.join(str(t) for t in e if t != "") for e in entries]
    if comment:
        lines.insert(len(lines) // 2, "% a comment inside the body")
    text = (f"%%MatrixMarket matrix coordinate {field} {symmetry}\n"
            f"% a comment\n\n4 4 {len(entries)}\n" + "\r\n".join(lines)
            + "\n")
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        path.write_text(text)
    return path


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("symmetry", ["general", "symmetric",
                                      "skew-symmetric"])
@pytest.mark.parametrize("body", list(BODIES))
def test_read_mtx_equals_the_reference(tmp_path, body, symmetry, gz,
                                      ref_lib):
    field, entries = BODIES[body]
    path = _write(tmp_path / ("m.mtx.gz" if gz else "m.mtx"), field,
                  symmetry, entries, gz=gz, tabs=body == "integer")
    got = io.read_mtx(path)
    _same_csr(got, ref_io.read_mtx(path))
    for dtype in (np.float32, np.float64):
        _same_csr(io.read_mtx(path, dtype=dtype),
                  ref_io.read_mtx(path, dtype=dtype))


@pytest.mark.parametrize("field", ["real", "integer", "pattern"])
def test_native_parse_equals_the_plain_parse(tmp_path, field, ref_lib):
    a = datasets.random_csr(500, 400, 9, seed=9, dtype=np.float64)
    if field != "real":
        a = CSR(a.shape, a.indptr, a.indices,
                np.round(a.data * 1e3) if field == "integer"
                else np.ones(a.nnz))
    coo = a.tocoo()
    fmt = {"real": "%d %d %.17g\n", "integer": "%d %d %d\n",
           "pattern": "%d %d\n"}[field]
    body = "".join(fmt % e[:fmt.count("%")] for e in zip(
        coo.row + 1, coo.col + 1, coo.data)).encode()
    got = io.parse_coordinate(body, a.nnz, field, np.float64)
    want = io.parse_coordinate_plain(body, a.nnz, field, np.float64)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[2], coo.data)
    path = tmp_path / "a.mtx"
    path.write_bytes(f"%%MatrixMarket matrix coordinate {field} general\n"
                     f"{a.shape[0]} {a.shape[1]} {a.nnz}\n".encode() + body)
    _same_csr(io.read_mtx(path), a)
    _same_csr(io.read_mtx(path), ref_io.read_mtx(path))


def test_comments_inside_the_body_as_the_reference(tmp_path, ref_lib):
    field, entries = BODIES["real"]
    path = _write(tmp_path / "c.mtx", field, "general", entries,
                  comment=True)
    _same_csr(io.read_mtx(path), ref_io.read_mtx(path))


@pytest.mark.parametrize("field", ["real", "pattern"])
def test_a_short_body_raises_with_both_counts(tmp_path, field, ref_lib):
    _, entries = BODIES[field]
    path = _write(tmp_path / "t.mtx", field, "general", entries)
    text = path.read_text().replace(f"4 4 {len(entries)}",
                                    f"4 4 {len(entries) + 2}")
    path.write_text(text)
    msg = f"parsed {len(entries)} of {len(entries) + 2}"
    with pytest.raises(ValueError, match=msg):
        io.read_mtx(path)
    with pytest.raises(ValueError, match=msg):
        ref_io.read_mtx(path)
    # a token that is not a number
    path.write_text(text.replace("3 1", "3 x", 1))
    with pytest.raises(ValueError, match="malformed"):
        io.read_mtx(path)
    with pytest.raises(TypeError, match="bytes"):
        native.parse_mtx_body("1 1 1.0", 1, True)


def test_mtx_reader_reads_in_a_process_of_its_own(tmp_path):
    # the smoke run's reader of a .mtx: each parse in a new process, its
    # arrays' hash those of the matrix written, its RSS read after each
    # step of its set-up and after the read
    import hashlib

    from sblas_torch.benchmarks.mtx_reader import MtxReader

    a = datasets.emulate("pwtk", scale=0.005, dtype=np.float32)
    path = tmp_path / "pwtk.mtx"
    io.write_mtx(path, a)
    h = hashlib.sha256()
    for arr in (a.indptr, a.indices, a.data):
        h.update(np.ascontiguousarray(arr).tobytes())
    with MtxReader() as reader:
        recs = {parse: reader.read(path, parse) for parse in ("host", "plain")}
        with pytest.raises(RuntimeError, match="the host read"):
            reader.read(tmp_path / "missing.mtx")
    for rec in recs.values():
        assert rec["nnz"] == a.nnz and rec["sha256"] == h.hexdigest()[:16]
        steps = list(rec["rss_mb"].values())
        assert list(rec["rss_mb"]) == ["floor", "numpy", "torch",
                                       "sblas_torch", "native.load"]
        assert steps == sorted(steps) and steps[-1] == rec["base_rss_mb"]
        assert rec["peak_rss_mb"] >= rec["base_rss_mb"]
        assert not rec["cuda_initialized"]
