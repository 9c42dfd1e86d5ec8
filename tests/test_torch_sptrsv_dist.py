"""The distributed triangular solves' host plan, and the plan at one rank.

The port deals tiles and batches levels from the CSR and the levels
(``sblas_torch.parallel.sptrsv_dist.deal_tiles``, ``make_batches``); the
reference from its padded level schedule (``sblas.parallel.sptrsv_dist.
_deal_tiles``, ``_make_batches``). Both must give the same tile dealing,
tiles per level and batches, at 1, 4 and 8 ranks, on the factors of the
reference's dist solve tests. At one rank, in a world of one in this
process, ``DistSptrsvPlan`` is one batch and the single-device plan's
solve bit for bit (on the CPU: the kernel's plain version), lower and
upper, one and K columns.
"""

import numpy as np
import pytest
import torch.distributed as dist

import sblas.formats as ref_formats
from sblas.parallel import sptrsv_dist as ref_dist
from sblas.sptrsv_schedule import build_level_schedule
from sblas_torch import SptrsmPlan, SptrsvPlan, datasets
from sblas_torch import parallel as par
from sblas_torch.formats import csr_transpose
from sblas_torch.levels import level_schedule
from sblas_torch.parallel import sptrsv_dist


def _fuzz(seed):
    """``tests/test_dist_fuzz.py:22-33``'s factor of ``seed``."""
    rng = np.random.default_rng(1000 + seed)
    n = int(rng.integers(40, 1500))
    deg = float(rng.uniform(1.5, 9.0))
    skew = float(rng.choice([0.0, 0.0, 1.2]))
    return datasets.lower_triangular(n, deg, skew=skew, seed=seed,
                                     dtype=np.float32)


FACTORS = {
    "band": lambda: datasets.lower_triangular(300, 4, bandwidth=9, seed=9,
                                              dtype=np.float64),
    "random": lambda: datasets.lower_triangular(300, 5, seed=10,
                                                dtype=np.float64),
    "chol": lambda: datasets.cholesky_factor(datasets.spd_diag_dominant(
        200, 5, bandwidth=12, seed=4, dtype=np.float64), dtype=np.float64),
    "upper": lambda: csr_transpose(datasets.lower_triangular(
        250, 5, seed=41, dtype=np.float64)),
    "clamp": lambda: datasets.lower_triangular(600, 5, seed=1,
                                               dtype=np.float32),
    "fuzz0": lambda: _fuzz(0),
    "fuzz2": lambda: _fuzz(2),
    "fuzz5": lambda: _fuzz(5),
    "chol-nd-40": lambda: datasets.cholesky_factor(datasets.poisson2d_nd(
        40, dtype=np.float64), dtype=np.float64),
}


def _ref(a):
    return ref_formats.CSR(a.shape, a.indptr, a.indices, a.data)


@pytest.mark.parametrize("ndev", [1, 4, 8])
@pytest.mark.parametrize("name", list(FACTORS))
def test_dealing_and_batches_are_the_references(name, ndev):
    l = FACTORS[name]()
    lower = name != "upper"
    sched = build_level_schedule(_ref(l), lower=lower, tile_rows=8)
    tile_chip, tpl = ref_dist._deal_tiles(sched, ndev, lower)
    batches = ref_dist._make_batches(sched, tile_chip, tpl, ndev, _ref(l),
                                     lower)
    levels, nlevels = level_schedule(l.indptr, l.indices, l.shape[0],
                                     lower=lower)
    got_chip, got_tpl, chip = sptrsv_dist.deal_tiles(l, levels, nlevels,
                                                     ndev, lower, 8)
    assert nlevels == sched.nlevels
    np.testing.assert_array_equal(got_chip, tile_chip)
    np.testing.assert_array_equal(got_tpl, tpl)
    assert sptrsv_dist.make_batches(l, levels, nlevels, chip, lower) == \
        batches
    # every row lies on its tile's rank (the reference's slots)
    live = sched.slot_row < l.shape[0]
    np.testing.assert_array_equal(chip[sched.slot_row[live]],
                                  tile_chip[np.flatnonzero(live) // 8])


@pytest.mark.parametrize("n,nlevels,tile_rows,want", [
    (100, 10, 8, 8), (100, 10, 0, 16), (10_000, 3, 0, 512), (5, 5, 0, 8)])
def test_tile_size_is_the_references_rule(n, nlevels, tile_rows, want):
    assert sptrsv_dist.tile_size(n, nlevels, tile_rows) == want


@pytest.fixture
def world_of_one():
    # a group of one rank in this process, ended after the test
    mesh = par.make_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("name", ["band", "chol", "upper", "clamp"])
def test_one_rank_is_the_single_device_solve(world_of_one, name):
    l = FACTORS[name]()
    lower = name != "upper"
    rng = np.random.default_rng(3)
    b = rng.standard_normal(l.shape[0]).astype(l.dtype)
    bk = rng.standard_normal((l.shape[0], 5)).astype(l.dtype)
    plan = par.DistSptrsvPlan(l, world_of_one, lower=lower)
    assert plan.nbatches == 1 and plan.step_methods == ["syncfree"]
    single = SptrsvPlan(l, lower=lower, method="syncfree", device="cpu")
    assert plan.nlevels == single.nlevels
    np.testing.assert_array_equal(plan(b).numpy(), single(b).numpy())
    planm = par.DistSptrsmPlan(l, world_of_one, lower=lower)
    np.testing.assert_array_equal(
        planm(bk).numpy(),
        SptrsmPlan(l, lower=lower, method="syncfree", device="cpu")(
            bk).numpy())


def test_refusals(world_of_one):
    l = FACTORS["band"]()
    with pytest.raises(ValueError, match="square"):
        par.DistSptrsvPlan(datasets.random_csr(4, 5, 2), world_of_one)
    with pytest.raises(ValueError, match="1D"):
        par.DistSptrsvPlan(l, par.make_mesh2d(1, 1, device="cpu"))
    with pytest.raises(ValueError, match="diagonal"):
        par.DistSptrsvPlan(datasets.random_csr(6, 6, 0), world_of_one)
    with pytest.raises(ValueError, match="shape"):
        par.DistSptrsvPlan(l, world_of_one)(np.zeros(3))
    with pytest.raises(ValueError, match="shape"):
        par.DistSptrsmPlan(l, world_of_one)(np.zeros(l.shape[0]))
