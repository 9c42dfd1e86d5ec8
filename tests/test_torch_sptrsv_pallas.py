"""The port's solves against the JAX package's two wavefront kernels, TPU
kernels #10 and #11 (``sblas/ops/kernels/sptrsv_pallas.py:_kernel``, through
``PallasSptrsv``, and ``:_kernel_m``, through ``PallasSptrsvLanes``), run in
interpret mode on the CPU. The reference's own tests of them are marked
slow; these take small factors, about 20 s each here, and sit in a file of
their own so that a parallel run spreads them.

The port runs its ``auto`` route (the sync-free kernel's plain version on
the CPU) and the kernel's emulated order of work. Tolerance 2e-4 for f32,
as the reference's tests (``tests/test_sptrsv.py:91``), against each other
and against scipy.
"""

import numpy as np
import pytest
import torch

from sblas import datasets
from sblas.formats import csr_transpose
from sblas.golden import rel_err, sptrsm_golden, sptrsv_golden
from sblas.ops.sptrsm import SptrsmPlan as RefSptrsmPlan
from sblas.ops.sptrsv import SptrsvPlan as RefSptrsvPlan
from sblas_torch import SptrsvPlan, sptrsm
from sblas_torch.formats import from_reference
from sblas_torch.ops.kernels import sptrsv_csr as skern

TOL = 2e-4


def _held(port, ref, golden):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape == golden.shape
    assert rel_err(port, ref) < TOL
    assert rel_err(port, golden) < TOL
    assert rel_err(ref, golden) < TOL


@pytest.mark.parametrize("lower", [True, False])
def test_sptrsv_vs_pallas_wavefront(lower):
    lo = datasets.lower_triangular(120, 5, seed=8, dtype=np.float32)
    l = lo if lower else csr_transpose(lo)
    b = np.random.default_rng(9).standard_normal(120).astype(np.float32)
    ref_plan = RefSptrsvPlan(l, lower=lower, method="pallas")
    assert ref_plan.method == "pallas"
    want = sptrsv_golden(l, b, lower=lower)
    plan = SptrsvPlan(from_reference(l), lower=lower, device="cpu")
    assert plan.method == "syncfree" and plan.nlevels == ref_plan.nlevels
    ref = np.asarray(ref_plan(b))
    _held(plan(b).numpy(), ref, want)
    _held(skern.sptrsv_csr_emulate(plan._op, torch.from_numpy(b)).numpy(),
          ref, want)


def test_sptrsm_vs_pallas_lanes():
    spd = datasets.poisson2d_nd(16, dtype=np.float64)
    l = datasets.cholesky_factor(spd, dtype=np.float32)
    b = np.random.default_rng(11).standard_normal((l.shape[0], 4)).astype(
        np.float32)
    ref_plan = RefSptrsmPlan(l, method="pallas")
    ref = np.asarray(ref_plan(b))
    assert ref_plan._lanes_state == "ok", "the lanes kernel must run"
    x = sptrsm(from_reference(l), b, device="cpu")
    _held(x.numpy(), ref, sptrsm_golden(l, b))
