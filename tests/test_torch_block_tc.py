"""The block kernel on tensor cores (``csrc/spmm_bsr.cu``, ``spmm_bsr_tc``:
``mma.sync`` m16n8k8 on TF32 operands in 3xTF32), its arithmetic emulated
on the CPU by ``spmm_bsr_emulate``, against the JAX package's dense-block
kernels and scipy.

The reference's ``bsr_pallas_t`` (TPU kernel #5 ``_kernel_t``, 128-row
blocks) and ``bsr_pallas`` (#7 ``_kernel``, 64-row blocks) run in
interpret mode once per block height and value type, at K = 32; K = 8
holds the emulation to the first 8 columns of that product (each column of
an SpMM is computed alone). The matrix is the suite's ``cant`` at 5%
scale, from the JAX package's generator, through ``from_reference``; X
and Y come from ``np.random.default_rng``. Tolerances (``default_tol``):
f32 2e-5 against the reference, scipy and the plain version; bf16 values
2e-5 against the reference (both round the values to bf16 and sum in
f32) and the plain version, 2e-2 against scipy.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sblas import datasets
from sblas.golden import rel_err, spmm_golden
from sblas.ops.spmm import SpmmPlan as RefPlan
from sblas_torch.formats import from_reference
from sblas_torch.golden import KERNEL_TOL
from sblas_torch.ops.kernels import spmm_bsr as bkern
from sblas_torch.retile_bsr import pack_bsr

TOL = 2e-5
BF16_TOL = 2e-2


def _dense(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _reference(br, vdt):
    """``(a, x, y, product)``: cant at 5%, X and Y of 32 columns and the
    reference's ``2.5 A @ X - 0.5 Y`` through its kernel of ``br``-row
    blocks, values in ``vdt``."""
    a = datasets.emulate("cant", scale=0.05, dtype=np.float32)
    x, y = _dense((a.shape[1], 32), 90), _dense((a.shape[0], 32), 91)
    kw = {"value_dtype": jnp.bfloat16} if vdt == "bf16" else {}
    plan = RefPlan(a, "bsr_pallas_t" if br == 128 else "bsr_pallas",
                   k_hint=32, **kw)
    assert plan.method == ("bsr_pallas_t" if br == 128 else "bsr_pallas")
    return a, x, y, np.asarray(plan(x, 2.5, -0.5, y))


@pytest.mark.parametrize("br", [128, 64])
@pytest.mark.parametrize("vdt", ["f32", "bf16"])
@pytest.mark.parametrize("k", [8, 32])
def test_3xtf32_emulation_vs_reference_block_kernels(k, vdt, br):
    a, x32, y32, prod = _reference(br, vdt)
    vd = torch.bfloat16 if vdt == "bf16" else torch.float32
    op = bkern.prepare(bkern.bsr_to_device(
        pack_bsr(from_reference(a), br=br), "cpu", vd))
    x, y = torch.from_numpy(x32[:, :k]), torch.from_numpy(y32[:, :k])
    got = bkern.spmm_bsr_emulate(op, x, 2.5, -0.5, y).numpy()
    golden = spmm_golden(a, x.numpy(), 2.5, -0.5, y.numpy())
    assert got.dtype == np.float32 and got.shape == golden.shape
    assert rel_err(got, prod[:, :k]) < TOL
    assert rel_err(got, golden) < (BF16_TOL if vdt == "bf16" else TOL)
    plain = bkern.spmm_bsr_reference(op, x, 2.5, -0.5, y).numpy()
    assert rel_err(got, plain) <= KERNEL_TOL


def test_tf32_round_is_cvt_rna():
    # 10 mantissa bits, to nearest, ties away from zero; inf and NaN kept
    ulp = 2.0 ** -10
    v = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4,
                      1 + 3 * ulp / 4, 3.0, float("inf"), float("-inf")],
                     dtype=torch.float32)
    want = [1 + ulp, -(1 + ulp), 1.0, 1 + ulp, 3.0, float("inf"),
            float("-inf")]
    assert bkern.tf32_round(v).tolist() == want
    assert torch.isnan(bkern.tf32_round(torch.tensor([float("nan")]))).all()
    bits = bkern.tf32_round(torch.from_numpy(_dense(1000, 92))).view(
        torch.int32)
    assert ((bits & 0x1FFF) == 0).all()


def test_tf32_split_keeps_f32():
    # hi + lo holds v to about 2^-22 of it; one TF32 product alone would
    # keep about 2^-11, which misses the f32 tolerance on the suite's
    # blocks, and 3xTF32 keeps it
    v = torch.from_numpy(_dense(100000, 93))
    hi, lo = bkern.tf32_split(v)
    assert ((hi + lo - v).abs() <= 2.0 ** -21 * v.abs()).all()
    a, x32, _, _ = _reference(128, "f32")
    op = bkern.prepare(bkern.bsr_to_device(pack_bsr(from_reference(a)),
                                           "cpu"))
    x = torch.from_numpy(x32)
    golden = spmm_golden(a, x32)
    one = bkern.spmm_bsr_reference(
        {**op, "blocks_t": bkern.tf32_round(op["blocks_t"])},
        bkern.tf32_round(x)).numpy()
    assert rel_err(one, golden) > TOL
    assert rel_err(bkern.spmm_bsr_emulate(op, x).numpy(), golden) < TOL / 4
