"""The merge kernel at K > 1, emulated on the CPU by ``spmm_csr_emulate``,
against the JAX package's scattered SpMM kernels and scipy: the columns
kernel (``csrc/spmm_csr.cu``, ``spmm_merge_kernel``: each warp stages its
share once, lanes own columns of K, one pass over the CSR stream) in its
own order, and the rows kernel (``spmm_rows_kernel``, lane groups a row)
that f32 and bf16 values take up to K = 16.

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
from sblas_torch.golden import KERNEL_TOL
from sblas_torch.ops.kernels import spmm_csr as ckern
from test_spmm_kres import GEO, _powerlaw
from test_torch_scattered import _long_rows

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


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", ["long rows", "powerlaw"])
def test_emulated_steps_f64_vs_reference_bucket(name, k):
    # the f64 build's order, alpha = 1/3: the reference's f64 route is its
    # XLA bucket route (Mosaic has no f64)
    a, x64, y64, ref = _f64_case(name)
    op = ckern.prepare(to_device(from_reference(a), "cpu"),
                       None if name == "long rows" else 7)
    assert op["data"].dtype == torch.float64
    assert not ckern.rows_kernel({**op, "design": "rows"}, k)
    if name == "long rows":
        # rows of 20,000+ nonzeros over 40+ shares: the warp-wide fix-up
        sh = ckern.shares(op, k)
        assert sh["unit"] == ckern.UNIT_COLS
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
    assert not any(ckern.rows_kernel(op64, k) for k in KS)


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
