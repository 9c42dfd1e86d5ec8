"""The port's SpMV against the JAX package's, on the same inputs.

Inputs come from ``np.random.default_rng`` as explicit float32/float64
arrays (conftest turns on ``jax_enable_x64``, so a numpy default would
promote the reference to f64). Matrices are built once, with the JAX
package's generators, and reach the port through
``sblas_torch.from_reference``, which reads the same arrays. The
reference's Pallas route runs in interpret mode on the CPU, as its own
tests run it, with ``min_fill=0.0`` so that it takes the small test
matrices. Tolerances:

- port vs reference, f32 values: 2e-5 (``default_tol(f32)``; the two sum
  each row in another order);
- port vs reference, bf16 values: also 2e-5 — both round the f32 values to
  bf16 to nearest even and accumulate in f32, so they differ only by order;
- port vs reference, f64: 1e-11 (``default_tol(f64)``);
- against scipy: ``default_tol`` of the value dtype (bf16: 2e-2).
"""

import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sblas import datasets
from sblas.formats import csr_transpose
from sblas.golden import default_tol, rel_err, spmv_golden
from sblas.ops.spmv import SpmvPlan as RefPlan
from sblas.ops.spmv import spmv as ref_spmv
from sblas_torch.formats import CSR, from_reference, to_device
from sblas_torch.golden import KERNEL_TOL, value_tol
from sblas_torch.ops.common import as_csr
from sblas_torch.ops.kernels.spmv_csr import (GROUPS, group_size, prepare,
                                              spmv_csr, spmv_csr_reference)
from sblas_torch.ops.spmv import (_PLAN_CACHE, NOT_PORTED, SpmvPlan,
                                  f32_rule, spmv)
from test_spmv import MATRICES

PORT_REF_TOL = 2e-5

KERNEL_MATRICES = {
    "banded(300,6)": lambda: datasets.banded(300, 6, seed=5, dtype=np.float32),
    "random(256,256,10,bw=30)": lambda: datasets.random_csr(
        256, 256, 10, bandwidth=30, seed=6, dtype=np.float32),
    "empty_rows(100,90,2)": lambda: datasets.random_csr(
        100, 90, 2, seed=4, dtype=np.float32),
}
VALUE_DTYPES = {"f32": (None, None), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _vec(n, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def _p(a):
    """The port's matrix holding the reference matrix's arrays."""
    return from_reference(a)


def _np(y):
    return y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


# (b) plain-torch routes against the reference's XLA routes -------------

@pytest.mark.parametrize("method", ["coo", "ell", "bucket"])
@pytest.mark.parametrize("name", list(MATRICES))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_routes_vs_reference(method, name, dtype):
    a = MATRICES[name](dtype)
    x = _vec(a.shape[1], 7, dtype)
    y0 = _vec(a.shape[0], 8, dtype)
    port = _np(SpmvPlan(_p(a), method, device="cpu")(x, 2.5, -0.5, y0))
    ref = np.asarray(RefPlan(a, method)(x, 2.5, -0.5, y0))
    tol = default_tol(dtype)
    assert port.dtype == ref.dtype == dtype
    assert rel_err(port, ref) < tol
    assert rel_err(port, spmv_golden(a, x, 2.5, -0.5, y0)) < tol


@pytest.mark.parametrize("max_width", [8, 24])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bucket_split_rows_add_by_gathers(monkeypatch, max_width, dtype):
    # rows longer than max_width are split into slots; the route adds a
    # row's partial sums through gathers in one fixed order, never through
    # a scatter-add (whose atomics on the card add them in a new order each
    # call), and agrees with the reference's split rows
    a = datasets.powerlaw_graph(600, 10.0, seed=3, dtype=dtype)
    x = _vec(a.shape[1], 7, dtype)
    y0 = _vec(a.shape[0], 8, dtype)
    plan = SpmvPlan(_p(a), "bucket", max_width=max_width, device="cpu")
    lengths = np.diff(a.indptr)
    split = plan._split_rows.numpy()
    np.testing.assert_array_equal(split, np.flatnonzero(lengths > max_width))
    table = plan._split_slots.numpy()
    zero = sum(v.shape[0] for v, _ in plan._buckets)
    assert ((table < zero).sum(axis=1)
            == -(-lengths[split] // max_width)).all()
    assert (plan._row_slot.numpy()[split] == zero).all()

    def scatter(*_a, **_k):
        raise AssertionError("the bucket route scatter-added")

    monkeypatch.setattr(torch.Tensor, "index_add_", scatter)
    port = _np(plan(x, 2.5, -0.5, y0))
    ref = np.asarray(RefPlan(a, "bucket", max_width=max_width)(
        x, 2.5, -0.5, y0))
    assert rel_err(port, ref) < default_tol(dtype)
    assert rel_err(port, spmv_golden(a, x, 2.5, -0.5, y0)) < default_tol(dtype)


@pytest.mark.parametrize("name", list(MATRICES))
def test_f64_auto_picks_the_reference_route(name):
    # auto runs f64 on the f64 build of the kernel the longest-row rule
    # picks at 8-byte values and vectors (csr, or merge on long rows); its
    # reason states the rule and names the route the JAX package's auto
    # runs (its XLA heuristic), and the two agree to f64 rounding
    a = MATRICES[name](np.float64)
    plan = SpmvPlan(_p(a), device="cpu")
    ref = RefPlan(a, "auto")
    pick, why = f32_rule(_p(a), 8, 8)
    assert plan.method == pick in ("csr", "merge")
    assert why in plan.route_reason
    assert repr(ref.method) in plan.route_reason
    x = _vec(a.shape[1], 9, np.float64)
    assert rel_err(_np(plan(x)), np.asarray(ref(x))) < 1e-13


# (c) the csr kernel module against the reference Pallas kernel ----------

@pytest.mark.parametrize("case", ["plain", "axpby", "trans", "csc"])
@pytest.mark.parametrize("vdt", list(VALUE_DTYPES))
@pytest.mark.parametrize("name", list(KERNEL_MATRICES))
def test_csr_vs_reference_pallas(name, vdt, case):
    a = KERNEL_MATRICES[name]()
    port_vd, ref_vd = VALUE_DTYPES[vdt]
    src, trans = (a.tocsc(), False) if case == "csc" else (a, case == "trans")
    op = csr_transpose(a) if trans else a
    x = _vec(op.shape[1], 11)
    y0 = _vec(op.shape[0], 12)
    args = (2.5, -0.5, y0) if case == "axpby" else ()
    port = _np(spmv(_p(src), x, *args, trans=trans, method="csr",
                    value_dtype=port_vd, device="cpu"))
    ref = np.asarray(ref_spmv(src, x, *args, trans=trans, method="pallas",
                              value_dtype=ref_vd, min_fill=0.0))
    assert port.shape == ref.shape == (op.shape[0],)
    assert port.dtype == np.float32
    assert rel_err(port, ref) < PORT_REF_TOL
    tol = value_tol(port_vd or torch.float32)
    assert rel_err(port, spmv_golden(op, x, *args)) < tol


# (d) the slice as a whole ----------------------------------------------

def test_slice_auto_vs_reference_pallas():
    a = datasets.emulate("cant", scale=0.05, dtype=np.float32)
    x = _vec(a.shape[1], 21)
    y0 = _vec(a.shape[0], 22)
    pa = _p(a)
    port = spmv(pa, x, alpha=2.5, beta=-0.5, y=y0, method="auto",
                device="cpu")
    plan = _PLAN_CACHE[pa][("spmv", "auto", (("device", "cpu"),))]
    assert plan.method == "csr" and "csr" in plan.route_reason
    ref = np.asarray(ref_spmv(a, x, alpha=2.5, beta=-0.5, y=y0,
                              method="pallas", min_fill=0.0))
    assert rel_err(_np(port), ref) < PORT_REF_TOL
    assert rel_err(_np(port), spmv_golden(a, x, 2.5, -0.5, y0)) < 2e-5


# (e) errors, as the reference raises them ------------------------------

@pytest.mark.parametrize("method", ["csr", "coo", "ell", "bucket"])
def test_beta_requires_y(method):
    a = datasets.random_csr(8, 8, 2, seed=0)
    x = np.ones(8, np.float32)
    with pytest.raises(ValueError, match="beta"):
        SpmvPlan(_p(a), method, device="cpu")(x, beta=1.0)
    ref_method = "pallas" if method == "csr" else method
    with pytest.raises(ValueError):
        RefPlan(a, ref_method, min_fill=0.0)(x, beta=1.0)


@pytest.mark.parametrize("method", ["csr", "coo", "ell", "bucket"])
def test_x_shape_check(method):
    a = datasets.random_csr(8, 10, 2, seed=0)
    with pytest.raises(ValueError, match="shape"):
        SpmvPlan(_p(a), method, device="cpu")(np.ones(9, np.float32))
    with pytest.raises(ValueError):
        RefPlan(a, "coo")(np.ones(9, np.float32))


@pytest.mark.parametrize("method", ["bsr", "pallas_ds"])
def test_not_ported_methods_raise(method):
    # both are ported (NOT_PORTED is empty): 'bsr' builds on any matrix, and
    # 'pallas_ds' raises only where the JAX package raises, on f32
    assert NOT_PORTED == ()
    a = datasets.random_csr(8, 8, 2, seed=0)
    if method == "pallas_ds":
        with pytest.raises(ValueError, match="f64 path"):
            SpmvPlan(_p(a), method, device="cpu")
        with pytest.raises(ValueError, match="f64 path"):
            RefPlan(a, method)
    else:
        assert SpmvPlan(_p(a), method, device="cpu").method == "bsr"


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bsr_vs_reference(dtype):
    # the SpMM bsr plan at K = 1 against the reference's XLA bsr route
    a = datasets.banded(300, 20, seed=7, dtype=dtype)
    x, y0 = _vec(300, 23, dtype), _vec(300, 24, dtype)
    plan = SpmvPlan(_p(a), "bsr", device="cpu")
    assert plan.method == "bsr" and plan._mm.method == "bsr"
    port = _np(plan(x, 2.5, -0.5, y0))
    ref = np.asarray(RefPlan(a, "bsr")(x, 2.5, -0.5, y0))
    tol = default_tol(dtype)
    assert port.dtype == ref.dtype == dtype
    assert rel_err(port, ref) < tol
    assert rel_err(port, spmv_golden(a, x, 2.5, -0.5, y0)) < tol


def test_unknown_method():
    a = datasets.random_csr(8, 8, 2, seed=0)
    with pytest.raises(ValueError, match="nope"):
        SpmvPlan(_p(a), "nope", device="cpu")
    with pytest.raises(ValueError):
        RefPlan(a, "nope")


def test_csr_rejects_f64_like_the_pallas_route():
    # the reference's w-SELL kernel refuses f64; the csr and nnz-balanced
    # kernels have f64 builds and take it, and refuse what neither build
    # takes: f64 values cut to f32 and complex values
    a = datasets.random_csr(64, 64, 4, seed=8, dtype=np.float64)
    with pytest.raises(ValueError):
        RefPlan(a, "pallas")
    x = _vec(64, 3, np.float64)
    for method in ("csr", "merge"):
        got = _np(SpmvPlan(_p(a), method, device="cpu")(x))
        assert got.dtype == np.float64
        assert rel_err(got, spmv_golden(a, x)) < 1e-13
        with pytest.raises(ValueError, match="f64"):
            SpmvPlan(_p(a), method, value_dtype=torch.float32, device="cpu")
    c = CSR(a.shape, a.indptr, a.indices, a.data.astype(np.complex128))
    for method in ("csr", "merge"):
        with pytest.raises(ValueError, match="f32 or f64"):
            SpmvPlan(c, method, device="cpu")


def test_to_device_refuses_int32_overflow():
    # a CSR whose nnz is 2**31, without allocating it: zero-stride arrays,
    # constructed past the dataclass checks
    big = object.__new__(CSR)
    object.__setattr__(big, "shape", (1, 1))
    object.__setattr__(big, "indptr", np.zeros(2, np.int32))
    object.__setattr__(big, "indices",
                       np.broadcast_to(np.int32(0), (2**31,)))
    object.__setattr__(big, "data", np.broadcast_to(np.float32(0), (2**31,)))
    assert big.nnz == 2**31
    with pytest.raises(ValueError, match="2\\*\\*31"):
        to_device(big, "cpu")


def test_to_device_refuses_complex_and_other_value_dtypes():
    a = _p(datasets.random_csr(8, 8, 2, seed=0))
    c = CSR(a.shape, a.indptr, a.indices, a.data.astype(np.complex64))
    with pytest.raises(ValueError, match="complex"):
        to_device(c, "cpu")
    with pytest.raises(ValueError, match="value dtype"):
        to_device(a, "cpu", torch.float16)
    with pytest.raises(ValueError, match="value_dtype"):
        SpmvPlan(a, "csr", value_dtype=torch.float64, device="cpu")


def test_to_device_layout_and_bf16_rounding():
    a = _p(datasets.random_csr(50, 40, 5, seed=3))
    t = to_device(a, "cpu", torch.bfloat16)
    assert t["shape"] == (50, 40)
    assert t["indptr"].dtype == t["indices"].dtype == torch.int32
    np.testing.assert_array_equal(t["indptr"].numpy(), a.indptr)
    np.testing.assert_array_equal(t["indices"].numpy(), a.indices)
    # the same round-to-nearest-even as the JAX package's bf16 values
    ref = np.asarray(jnp.asarray(a.data).astype(jnp.bfloat16)
                     .astype(jnp.float32))
    np.testing.assert_array_equal(t["data"].float().numpy(), ref)


def test_wrapper_checks_its_inputs():
    a = _p(datasets.random_csr(20, 30, 3, seed=1))
    raw = to_device(a, "cpu")
    t = prepare(raw)
    x = torch.from_numpy(_vec(30, 1))
    y = torch.from_numpy(_vec(20, 2))
    with pytest.raises(ValueError, match="x must be f32"):
        spmv_csr(t, x.double())
    with pytest.raises(ValueError, match="x must be f32"):
        spmv_csr(t, x[:29])
    with pytest.raises(ValueError, match="contiguous"):
        spmv_csr(t, torch.from_numpy(_vec(60, 3))[::2])
    with pytest.raises(ValueError, match="y must be f32"):
        spmv_csr(t, x, 1.0, 1.0, y[:19])
    with pytest.raises(ValueError, match="beta"):
        spmv_csr(t, x, 1.0, 1.0, None)
    # the matrix is checked once, when its operand is prepared
    with pytest.raises(TypeError, match="int32"):
        prepare({**raw, "indices": raw["indices"].long()})
    with pytest.raises(TypeError, match="f32, bf16 or f64"):
        prepare({**raw, "data": raw["data"].half()})
    with pytest.raises(ValueError, match="contiguous"):
        prepare({**raw, "data": torch.stack([raw["data"]] * 2, 1)[:, 0]})
    with pytest.raises(ValueError, match="shape"):
        prepare({**raw, "indptr": raw["indptr"][:-1]})


# the plain version on the edges the kernel must get right ---------------

def test_empty_rows_and_no_entries():
    e = CSR((5, 7), np.zeros(6, np.int32), np.zeros(0, np.int32),
            np.zeros(0, np.float32))
    x = torch.ones(7)
    y = torch.arange(5, dtype=torch.float32)
    t = prepare(to_device(e, "cpu"))
    assert torch.equal(spmv_csr(t, x), torch.zeros(5))
    assert torch.equal(spmv_csr(t, x, 2.0, -0.5, y), -0.5 * y)
    a = _p(datasets.random_csr(100, 90, 2, seed=4))
    empty_rows = np.flatnonzero(a.row_lengths == 0)
    xa, ya = torch.from_numpy(_vec(90, 5)), torch.from_numpy(_vec(100, 6))
    out = spmv_csr(prepare(to_device(a, "cpu")), xa, 1.5, 0.25, ya)
    if len(empty_rows):
        np.testing.assert_array_equal(out.numpy()[empty_rows],
                                      (0.25 * ya).numpy()[empty_rows])
    assert rel_err(out.numpy(), spmv_golden(a, xa.numpy(), 1.5, 0.25,
                                            ya.numpy())) < 2e-5


def test_group_size_follows_mean_row_length():
    # the group_sweep's fastest width at 58 and 110 nnz/row (PERF.md)
    assert group_size(62451, 3637188) == 8           # cant, 58 nnz/row
    assert group_size(1_000_000, 109_900_000) == 8   # fem-band, capped
    assert group_size(100, 3300) == 8                # 33 nnz/row
    assert group_size(100, 3200) == 4                # 32: 8 per lane
    assert group_size(300, 3858) == 2                # 12.9 nnz/row
    assert group_size(100, 237) == 2
    assert group_size(0, 0) == 2 and group_size(5, 0) == 2
    # the f64 build: capped at 16 (the FEM band's fastest f64 width)
    f64 = torch.float64
    assert group_size(1_000_000, 109_900_000, f64) == 16   # fem-band
    assert group_size(62451, 3637188, f64) == 8            # cant
    assert group_size(100, 30000, f64) == 16               # capped
    assert group_size(100, 3200, torch.bfloat16) == 4


def test_csr_bytes_model():
    a = _p(datasets.banded(300, 5))
    m, n = a.shape
    f32 = SpmvPlan(a, "csr", device="cpu")
    bf16 = SpmvPlan(a, "csr", value_dtype="bfloat16", device="cpu")
    assert f32.bytes_per_iter == a.nnz * 8 + (m + 1) * 4 + n * 4 + m * 4
    assert f32.bytes_per_iter - bf16.bytes_per_iter == a.nnz * 2


def test_plan_cache_is_weak_and_derived_matrices_are_reused():
    a = _p(datasets.random_csr(64, 64, 4, seed=9))
    x = _vec(64, 1)
    y1 = spmv(a, x, trans=True, device="cpu")
    y2 = spmv(a, x, trans=True, device="cpu")
    assert torch.equal(y1, y2)
    at = as_csr(a, True)
    assert as_csr(a, True) is at          # one host transpose, reused
    (plan,) = _PLAN_CACHE[at].values()    # one plan for both calls
    refs = [weakref.ref(o) for o in (a, at, plan)]
    del a, at, plan
    gc.collect()
    # the plan, and with it its tensors, dies with the matrix
    assert all(r() is None for r in refs)


def test_plain_reference_matches_scipy():
    a = _p(datasets.random_csr(400, 400, 12, skew=1.2, seed=3))
    x, y = _vec(400, 1), _vec(400, 2)
    t = to_device(a, "cpu")
    out = spmv_csr_reference(t, torch.from_numpy(x), 2.5, -0.5,
                             torch.from_numpy(y))
    assert rel_err(out.numpy(), spmv_golden(a, x, 2.5, -0.5, y)) < 2e-5


def test_plan_prepares_the_operand_once():
    a = _p(datasets.emulate("cant", scale=0.05, dtype=np.float32))
    plan = SpmvPlan(a, "csr", device="cpu")
    op = plan._op
    assert op["group"] == group_size(a.shape[0], a.nnz)
    x = _vec(a.shape[1], 2)
    plan(x)
    assert plan._op is op                 # the call adds no per-call state
    with pytest.raises(ValueError, match="shape"):
        plan(np.ones(a.shape[1] + 1, np.float32))


@pytest.mark.parametrize("group", GROUPS)
def test_group_override_keeps_the_result(group):
    # on the CPU the width changes nothing: the operand carries it to the
    # launch only
    a = _p(datasets.random_csr(200, 150, 9, seed=12))
    op = prepare(to_device(a, "cpu"))
    x = torch.from_numpy(_vec(150, 1))
    y = torch.from_numpy(_vec(200, 2))
    got = spmv_csr({**op, "group": group}, x, 2.5, -0.5, y)
    want = spmv_csr_reference(op, x, 2.5, -0.5, y)
    assert rel_err(got.numpy(), want.numpy()) <= KERNEL_TOL


def test_value_tol_is_the_golden_policy():
    assert value_tol(torch.float32) == default_tol(np.float32) == 2e-5
    assert value_tol(np.float64) == default_tol(np.float64) == 1e-11
    assert value_tol(torch.bfloat16) == value_tol("bfloat16") == 2e-2
    assert value_tol(jnp.bfloat16) == default_tol(jnp.bfloat16)
