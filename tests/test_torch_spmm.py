"""The port's SpMM against the JAX package's, on the same inputs.

Matrices are built once with the JAX package's generators and reach the
port through ``sblas_torch.from_reference``; X and Y come from
``np.random.default_rng`` as explicit float32/float64 arrays (conftest turns
on ``jax_enable_x64``). The reference's dense-block Pallas kernels run in
interpret mode on the CPU, as its own tests run them. Tolerances:

- port vs reference, f32: 2e-5 (``default_tol(f32)``). The reference's f32
  block products are bf16x3, the port's exact f32 FMAs: both are within
  2e-5 of scipy, and so within 2e-5 of each other;
- port vs reference, bf16 values: also 2e-5 — both round the values to
  bf16 to nearest even and compute in f32 on the CPU;
- f64: 1e-11; against scipy: ``default_tol`` of the value dtype (bf16:
  2e-2).
"""

import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sblas import datasets
from sblas.formats import COO, csr_transpose
from sblas.golden import default_tol, rel_err, spmm_golden
from sblas.ops.kernels import spmm_bsr_pallas as ref_bsr_mod
from sblas.ops.spmm import SpmmPlan as RefPlan
from sblas.ops.spmm import spmm as ref_spmm
from sblas_torch.formats import CSR, from_reference
from sblas_torch.ops.kernels import spmm_bsr as bkern
from sblas_torch.ops.spmm import (_PLAN_CACHE, NOT_PORTED, ROUTES, X_GATHER,
                                  SpmmPlan, block_stream_bytes, spmm)
from sblas_torch.ops.spmv import csr_bytes_per_iter
from sblas_torch.retile_bsr import pack_bsr

TOL = 2e-5


def _p(a):
    """The port's matrix holding the reference matrix's arrays."""
    return from_reference(a)


def _dense(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _np(y):
    return y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def _cant(scale=0.05, dtype=np.float32):
    return datasets.emulate("cant", scale=scale, dtype=dtype)


def _drop_rows(a, *spans):
    """``a`` with the rows of each ``[lo, hi)`` span emptied."""
    coo = a.tocoo()
    keep = np.ones(a.nnz, bool)
    for lo, hi in spans:
        keep &= (coo.row < lo) | (coo.row >= hi)
    return COO(a.shape, coo.row[keep], coo.col[keep], coo.data[keep]).tocsr()


def _held(port, ref, golden, tol=TOL, gtol=TOL):
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape == golden.shape
    assert rel_err(port, ref) < tol
    assert rel_err(port, golden) < gtol
    assert rel_err(ref, golden) < gtol


# (a) the block route against the reference's dense-block Pallas kernels --

@pytest.mark.parametrize("k", [1, 5, 8, 32])
def test_block_vs_bsr_pallas_t(k):
    a = _cant()
    x, y0 = _dense((a.shape[1], k), 40 + k), _dense((a.shape[0], k), 41)
    port = SpmmPlan(_p(a), "block", k_hint=k, device="cpu")(x, 2.5, -0.5, y0)
    ref = RefPlan(a, "bsr_pallas_t", k_hint=k)(x, 2.5, -0.5, y0)
    _held(port, ref, spmm_golden(a, x, 2.5, -0.5, y0))


def test_block_vs_bsr_pallas_t_streamed(monkeypatch):
    # the reference streams Xt through VMEM in column slices when it does
    # not fit whole; the port's kernel never stages X whole
    monkeypatch.setattr(ref_bsr_mod, "_VMEM_T_LIMIT", 120 * 1024)
    a = _cant(0.1)
    x = _dense((a.shape[1], 8), 42)
    ref = ref_bsr_mod.PallasSpmmBsrT(a, k_hint=8)
    assert ref.R > 1 and ref._slice_pcols
    port = SpmmPlan(_p(a), "block", device="cpu")(x)
    _held(port, ref.apply_traced(jnp.asarray(x)), spmm_golden(a, x))


@pytest.mark.parametrize("k", [8, 32])
def test_block_rows_64_vs_bsr_pallas(k):
    a = _cant()
    x, y0 = _dense((a.shape[1], k), 43 + k), _dense((a.shape[0], k), 44)
    port = SpmmPlan(_p(a), "block", block_rows=64, device="cpu")(
        x, 2.0, -0.5, y0)
    ref = RefPlan(a, "bsr_pallas")(x, 2.0, -0.5, y0)
    _held(port, ref, spmm_golden(a, x, 2.0, -0.5, y0))


def test_block_bf16_values_vs_reference():
    a = _cant()
    x = _dense((a.shape[1], 8), 45)
    port = SpmmPlan(_p(a), "block", value_dtype=torch.bfloat16,
                    device="cpu")(x)
    ref = RefPlan(a, "bsr_pallas_t", value_dtype=jnp.bfloat16)(x)
    _held(port, ref, spmm_golden(a, x), gtol=2e-2)


def test_block_trans_vs_reference():
    a = _cant()
    x = _dense((a.shape[0], 8), 46)
    port = spmm(_p(a), x, trans=True, method="block", device="cpu")
    ref = ref_spmm(a, x, trans=True, method="bsr_pallas_t")
    _held(port, ref, spmm_golden(csr_transpose(a), x))


EDGE = {
    # m != n, n not a multiple of 128
    "m!=n": lambda: datasets.random_csr(300, 200, 6, seed=2),
    # block-rows 1 (br=128) and 1..4 (br=64) empty, and the last rows
    "empty block-rows": lambda: _drop_rows(
        datasets.random_csr(450, 400, 7, seed=6), (64, 320), (420, 450)),
    "nnz=0": lambda: _drop_rows(datasets.random_csr(300, 200, 6, seed=2),
                                (0, 300)),
}


@pytest.mark.parametrize("br", [128, 64])
@pytest.mark.parametrize("name", list(EDGE))
def test_block_edges_vs_reference_bsr(name, br):
    # too sparse for the reference's Pallas kernels (they refuse a block
    # density below 0.04), so the reference is its XLA block route
    a = EDGE[name]()
    x, y0 = _dense((a.shape[1], 3), 47), _dense((a.shape[0], 3), 48)
    port = SpmmPlan(_p(a), "block", block_rows=br, device="cpu")(
        x, 1.5, 0.25, y0)
    ref = RefPlan(a, "bsr")(x, 1.5, 0.25, y0)
    _held(port, ref, spmm_golden(a, x, 1.5, 0.25, y0))
    if name != "m!=n":
        empty = np.flatnonzero(a.row_lengths == 0)
        np.testing.assert_array_equal(_np(port)[empty], 0.25 * y0[empty])


# (b) the plain-torch routes and spmv_passes against the reference's ------

ROUTE_MATRICES = {
    "banded": lambda dt: datasets.banded(300, 5, seed=1, dtype=dt),
    "skewed": lambda dt: datasets.random_csr(400, 400, 12, skew=1.2, seed=3,
                                             dtype=dt),
    "m!=n": lambda dt: datasets.random_csr(257, 301, 9, seed=2, dtype=dt),
}


@pytest.mark.parametrize("method", ["ell", "bucket", "bsr", "spmv_passes"])
@pytest.mark.parametrize("name", list(ROUTE_MATRICES))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_routes_vs_reference(method, name, dtype):
    a = ROUTE_MATRICES[name](dtype)
    x, y0 = _dense((a.shape[1], 5), 50, dtype), _dense((a.shape[0], 5), 51,
                                                       dtype)
    port = SpmmPlan(_p(a), method, k_hint=5, device="cpu")(x, 2.5, -0.5, y0)
    ref = RefPlan(a, method, k_hint=5)(x, 2.5, -0.5, y0)
    assert _np(port).dtype == np.asarray(ref).dtype == dtype
    tol = default_tol(dtype)
    _held(port, ref, spmm_golden(a, x, 2.5, -0.5, y0), tol, tol)


# (c) auto's picks ---------------------------------------------------------

def test_auto_picks_block_by_the_bytes_rule():
    a = _cant()
    pa = _p(a)
    plan = SpmmPlan(pa, k_hint=32, device="cpu")
    assert plan.method == "block" and plan.k_hint == 32
    assert "block " in plan.route_reason and "merge " in plan.route_reason
    assert plan.route_reason.endswith("-> block")
    eight = SpmmPlan(pa, device="cpu")
    assert eight.method == "merge" and eight.k_hint == 8
    assert eight.route_reason.endswith("-> merge")
    one = SpmmPlan(pa, k_hint=1, device="cpu")
    assert one.method == "spmv_passes"
    assert one.route_reason.endswith("-> spmv_passes")
    g = datasets.powerlaw_graph(3000, 10, seed=5)
    assert SpmmPlan(_p(g), device="cpu").method == "merge"


def test_auto_rule_is_the_bytes_model():
    a = _p(_cant())
    m, n = a.shape
    for k, br, vd in ((8, 128, torch.float32), (3, 64, torch.bfloat16),
                      (2, 128, torch.float32), (32, 128, torch.float32)):
        plan = SpmmPlan(a, k_hint=k, block_rows=br, value_dtype=vd,
                        device="cpu")
        vb = vd.itemsize
        b = pack_bsr(a, br=br)
        xy = (n + m) * k * 4
        prices = {
            "block": block_stream_bytes(b.nblocks, b.num_brows, br, vb) + xy,
            "merge": a.nnz * (vb + 4) + (m + 1) * 4
            + int(X_GATHER * a.nnz * k * 4) + xy,
            "spmv_passes": k * csr_bytes_per_iter(m, n, a.nnz, vb)}
        assert plan.method == min(prices, key=prices.get)


@pytest.mark.parametrize("name", ["banded", "skewed", "m!=n", "block-dense"])
def test_f64_auto_picks_the_reference_route(name):
    # auto runs f64 on the cheaper by the bytes model of merge and
    # spmv_passes (the kernels' f64 builds); its reason gives both prices
    # and names the route the JAX package's auto runs (its XLA heuristic:
    # bsr on the dense band), and the two agree to f64 rounding
    a = datasets.banded(512, 40, seed=33, dtype=np.float64) \
        if name == "block-dense" else ROUTE_MATRICES[name](np.float64)
    plan = SpmmPlan(_p(a), device="cpu")
    ref = RefPlan(a, "auto")
    prices = SpmmPlan.prices(_p(a), plan.k_hint, val_bytes=8, vec_bytes=8)
    assert plan.method == min(("merge", "spmv_passes"), key=prices.get)
    for r in ("merge", "spmv_passes"):
        assert f"{r} {prices[r] / 1e6:.1f} MB" in plan.route_reason
    assert repr(ref.method) in plan.route_reason
    if name == "block-dense":
        assert ref.method == "bsr"
    x = _dense((a.shape[1], 3), 56, np.float64)
    assert rel_err(_np(plan(x)), np.asarray(ref(x))) < 1e-13


def test_slice_auto_vs_reference():
    a = _cant()
    pa = _p(a)
    x, y0 = _dense((a.shape[1], 8), 52), _dense((a.shape[0], 8), 53)
    port = spmm(pa, x, 2.5, -0.5, y0, method="auto", k_hint=8, device="cpu")
    (plan,) = _PLAN_CACHE[pa].values()
    assert plan.method == "merge"         # the bytes rule's pick at K = 8
    ref = RefPlan(a, "bsr_pallas_t", k_hint=8)(x, 2.5, -0.5, y0)
    _held(port, ref, spmm_golden(a, x, 2.5, -0.5, y0))


# (d) errors, the cache, the plain version and the bytes model ----------

@pytest.mark.parametrize("method", list(ROUTES))
def test_shape_and_beta_checks(method):
    a = _p(datasets.random_csr(40, 30, 4, seed=0))
    plan = SpmmPlan(a, method, device="cpu")
    x = np.ones((30, 4), np.float32)
    with pytest.raises(ValueError, match="X must have shape"):
        plan(np.ones((31, 4), np.float32))
    with pytest.raises(ValueError, match="X must have shape"):
        plan(np.ones(30, np.float32))
    with pytest.raises(ValueError, match="beta"):
        plan(x, beta=1.0)
    with pytest.raises(ValueError, match="Y must have shape"):
        plan(x, 1.0, 1.0, np.ones((40, 3), np.float32))
    assert tuple(plan(x).shape) == (40, 4)
    assert tuple(plan(np.ones((30, 0), np.float32)).shape) == (40, 0)


@pytest.mark.parametrize("method", ["pallas_ds"])
def test_not_ported_methods_raise(method):
    # ported (NOT_PORTED is empty): 'pallas_ds' raises only where the JAX
    # package raises, on f32, and runs f64 as spmv_passes
    assert NOT_PORTED == ()
    r = datasets.random_csr(8, 8, 2, seed=0)
    with pytest.raises(ValueError, match="f64 path"):
        SpmmPlan(_p(r), method, device="cpu")
    with pytest.raises(ValueError, match="f64 path"):
        RefPlan(r, method)
    r64 = datasets.random_csr(8, 8, 2, seed=0, dtype=np.float64)
    assert SpmmPlan(_p(r64), method, device="cpu").method == "spmv_passes"


def test_unknown_and_reference_only_names():
    a = _p(datasets.random_csr(8, 8, 2, seed=0))
    with pytest.raises(ValueError, match="nope"):
        SpmmPlan(a, "nope", device="cpu")
    # no aliases: the reference's kernel names map to 'block' in the docs
    for name in ("bsr_pallas_t", "bsr_pallas"):
        with pytest.raises(ValueError, match="'block'"):
            SpmmPlan(a, name, device="cpu")


def test_block_route_refuses_what_the_kernel_does_not_take():
    a64 = _p(datasets.random_csr(64, 64, 4, seed=8, dtype=np.float64))
    with pytest.raises(ValueError, match="f32"):
        SpmmPlan(a64, "block", device="cpu")
    a = _p(datasets.random_csr(64, 64, 4, seed=8))
    with pytest.raises(ValueError, match="block_rows"):
        SpmmPlan(a, "block", block_rows=32, device="cpu")
    with pytest.raises(ValueError, match="value_dtype"):
        SpmmPlan(a, "block", value_dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("entry", ["SpmmPlan", "spmm", "SpmvPlan", "spmv"])
def test_entry_points_default_to_the_card(entry):
    import sblas_torch

    a = _p(datasets.random_csr(16, 16, 3, seed=1))
    x = np.ones((16, 2) if "mm" in entry.lower() else 16, np.float32)
    call = getattr(sblas_torch, entry)
    args = (a,) if entry[0] == "S" else (a, x)
    if torch.cuda.is_available():
        assert call(*args).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(*args)


def test_plan_cache_is_weak_and_shared_with_spmv():
    import sblas_torch

    a = _p(datasets.random_csr(64, 64, 4, seed=9))
    x = _dense((64, 3), 1)
    y1 = spmm(a, x, trans=True, k_hint=3, device="cpu")
    y2 = spmm(a, x, trans=True, k_hint=3, device="cpu")
    assert torch.equal(y1, y2)
    sblas_torch.spmv(a, x[:, 0], device="cpu")
    from sblas_torch.ops.common import as_csr

    at = as_csr(a, True)
    (plan,) = _PLAN_CACHE[at].values()    # one plan for both SpMM calls
    assert len(_PLAN_CACHE[a]) == 1       # and the SpMV plan beside it
    refs = [weakref.ref(o) for o in (a, at, plan)]
    del a, at, plan
    gc.collect()
    assert all(r() is None for r in refs)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("br", [128, 64])
def test_plain_version_matches_scipy(br, dtype):
    a = datasets.random_csr(300, 260, 12, bandwidth=60, seed=31, dtype=dtype)
    op = bkern.bsr_to_device(pack_bsr(_p(a), br=br), "cpu")
    x, y0 = _dense((260, 7), 54, dtype), _dense((300, 7), 55, dtype)
    out = bkern.spmm_bsr_reference(op, torch.from_numpy(x), 2.5, -0.5,
                                   torch.from_numpy(y0))
    assert out.dtype == torch.from_numpy(x).dtype
    assert rel_err(out.numpy(), spmm_golden(a, x, 2.5, -0.5, y0)) < \
        default_tol(dtype)


def test_wrapper_checks_its_inputs():
    a = _p(datasets.random_csr(200, 150, 6, bandwidth=40, seed=1))
    raw = bkern.bsr_to_device(pack_bsr(a), "cpu")
    op = bkern.prepare(raw)
    x = torch.from_numpy(_dense((150, 4), 1))
    y = torch.from_numpy(_dense((200, 4), 2))
    before = bkern.LAUNCHES
    with pytest.raises(ValueError, match="X must be f32"):
        bkern.spmm_bsr(op, x.double())
    with pytest.raises(ValueError, match="X must be f32"):
        bkern.spmm_bsr(op, x[:149])
    with pytest.raises(ValueError, match="contiguous"):
        bkern.spmm_bsr(op, x.t().contiguous().t())
    with pytest.raises(ValueError, match="Y must be f32"):
        bkern.spmm_bsr(op, x, 1.0, 1.0, y[:, :3].contiguous())
    with pytest.raises(ValueError, match="beta"):
        bkern.spmm_bsr(op, x, 1.0, 1.0, None)
    with pytest.raises(TypeError, match="int32"):
        bkern.prepare({**raw, "bptr": raw["bptr"].long()})
    with pytest.raises(TypeError, match="f32 or bf16"):
        bkern.prepare({**raw, "blocks_t": raw["blocks_t"].double()})
    with pytest.raises(ValueError, match="block rows"):
        bkern.prepare({**raw, "br": 32})
    with pytest.raises(ValueError, match="shape"):
        bkern.prepare({**raw, "bptr": raw["bptr"][:-1]})
    with pytest.raises(ValueError, match="shape"):
        bkern.prepare({**raw,
                       "blocks_t": raw["blocks_t"][:, :, :64].contiguous()})
    # on CPU tensors the wrapper runs the plain version: no launch counted
    got = bkern.spmm_bsr(op, x, 2.5, -0.5, y)
    assert bkern.LAUNCHES == before
    assert torch.equal(got, bkern.spmm_bsr_reference(op, x, 2.5, -0.5, y))


def test_bytes_model():
    a = _p(_cant())
    m, n = a.shape
    f32 = SpmmPlan(a, "block", device="cpu")
    bf16 = SpmmPlan(a, "block", value_dtype="bfloat16", device="cpu")
    b = pack_bsr(a)
    assert f32.bytes_per_iter_nx == b.nblocks * (128 * 128 * 4 + 4) + \
        (b.num_brows + 1) * 4
    assert f32.bytes_per_iter_nx - bf16.bytes_per_iter_nx == \
        b.nblocks * 128 * 128 * 2
    assert f32.bytes_per_call(8, with_y=True) == \
        f32.bytes_per_iter_nx + (n + 2 * m) * 8 * 4
    assert f32.flops_per_call(8) == 2 * b.nblocks * 128 * 128 * 8
    passes = SpmmPlan(a, "spmv_passes", k_hint=8, device="cpu")
    one = csr_bytes_per_iter(m, n, a.nnz, 4) - (m + n) * 4
    assert passes.bytes_per_iter_nx == 8 * one
    assert passes.bytes_per_call(8) == 8 * one + (n + m) * 8 * 4
    assert passes.flops_per_call(8) == 2 * a.nnz * 8


def test_port_csr_class_is_required():
    a = datasets.random_csr(16, 16, 3, seed=1)
    with pytest.raises(TypeError, match="from_reference"):
        SpmmPlan(a, "block", device="cpu")
    assert isinstance(_p(a), CSR)
