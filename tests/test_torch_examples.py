"""The port's examples (``sblas_torch.examples``) against the JAX package's
(``examples/``), on the inputs ``tests/test_examples.py`` gives them, on
the CPU (``device="cpu"``).

Held to the reference: CG's iteration counts within 2 (plain and SSOR),
and SSOR reducing them; ILU(0)-preconditioned GMRES under 1e-6 in under
half the plain iterations, as the reference's; PageRank's rank vector
(``bucket`` and ``pseg``) within 1e-5 of the reference's, in max abs over
``r.max()``. The reference runs its ``bucket`` route for PageRank (its
``pseg`` route is a PSEG Pallas kernel in interpret mode, which its own
test runs only in the slow lane).
"""

import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

from sblas import datasets as ref_datasets
from sblas_torch import from_reference
from sblas_torch.examples import cg as ex_cg
from sblas_torch.examples import convection_ilu as ex_ilu
from sblas_torch.examples import pagerank as ex_pr

_EX = Path(__file__).resolve().parent.parent / "examples"
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ref_examples():
    return {name: runpy.run_path(str(_EX / f"{name}.py"))
            for name in ("cg", "convection_ilu", "pagerank")}


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_cg_iterations_match_the_reference(ref_examples):
    ref = ref_examples["cg"]
    ra = ref_datasets.poisson2d(24, dtype=np.float32)
    a = from_reference(ra)
    b = np.random.default_rng(1).standard_normal(a.shape[0]).astype(
        np.float32)
    _, it_ref, _ = ref["cg"](ra, b, tol=1e-5)
    _, itp_ref, _ = ref["cg"](ra, b, tol=1e-5,
                              m_solve=ref["ssor_preconditioner"](ra))
    x, it, res = ex_cg.cg(a, b, tol=1e-5, device=CPU)
    xp, itp, resp = ex_cg.cg(a, b, tol=1e-5, device=CPU,
                             m_solve=ex_cg.ssor_preconditioner(a, device=CPU))
    assert res < 1e-5 and resp < 1e-5
    assert abs(it - it_ref) <= 2 and abs(itp - itp_ref) <= 2
    assert itp < it, "SSOR preconditioning must reduce iterations"
    err = np.linalg.norm(a.to_scipy() @ _np(xp) - b) / np.linalg.norm(b)
    assert err < 5e-5


def test_ssor_with_omega_matches_the_reference(ref_examples):
    ref = ref_examples["cg"]
    ra = ref_datasets.poisson2d(16, dtype=np.float32)
    r = np.random.default_rng(2).standard_normal(ra.shape[0]).astype(
        np.float32)
    want = np.asarray(ref["ssor_preconditioner"](ra, omega=1.3)(r))
    got = ex_cg.ssor_preconditioner(from_reference(ra), omega=1.3,
                                    device=CPU)(torch.from_numpy(r))
    np.testing.assert_allclose(_np(got), want, rtol=2e-5,
                               atol=2e-5 * np.abs(want).max())


def test_convection_ilu_matches_the_reference(ref_examples):
    _, _, (_, plain_ref), (x1_ref, pre_ref) = ref_examples["convection_ilu"][
        "solve"](nx=24, eps=0.02)
    a, b, (_, plain), (x1, pre) = ex_ilu.solve(nx=24, eps=0.02, device=CPU)
    assert pre["rel_residual"] < 1e-6
    assert pre["iterations"] < plain["iterations"] / 2
    assert pre_ref["iterations"] < plain_ref["iterations"] / 2
    # GMRES counts matvecs in cycles of 30: the same cycles as the
    # reference's
    assert pre["iterations"] == pre_ref["iterations"]
    assert plain["iterations"] == plain_ref["iterations"]
    err = (np.linalg.norm(a.to_scipy() @ _np(x1) - b) / np.linalg.norm(b))
    assert err < 1e-4
    assert np.abs(_np(x1) - np.asarray(x1_ref)).max() < 1e-4 * np.abs(
        np.asarray(x1_ref)).max()


@pytest.fixture(scope="module")
def pagerank_ref(ref_examples):
    g = ref_datasets.emulate("uk-2002", scale=0.01, dtype=np.float32)
    r, it = ref_examples["pagerank"]["pagerank"](g, method="bucket",
                                                 tol=1e-9)
    return g, np.asarray(r), it


@pytest.mark.parametrize("method", ["bucket", "pseg"])
def test_pagerank_matches_the_reference(pagerank_ref, method):
    # the iteration counts may differ: the last steps' deltas are at the
    # f32 products' rounding
    g, r_ref, it_ref = pagerank_ref
    r, it = ex_pr.pagerank(from_reference(g), method=method, tol=1e-9,
                           device=CPU)
    r = _np(r)
    assert r.dtype == np.float64 and r.shape == r_ref.shape
    assert abs(float(r.sum()) - 1.0) < 1e-3 and it < 200 and it_ref < 200
    assert np.abs(r - r_ref).max() < 1e-5 * r_ref.max()


def test_stochastic_transpose_matches_the_reference(ref_examples):
    g = ref_datasets.powerlaw_graph(500, 6.0, seed=3, dtype=np.float32)
    want = ref_examples["pagerank"]["stochastic_transpose"](g)
    got = ex_pr.stochastic_transpose(from_reference(g))
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("mod,argv", [
    (ex_cg, ["16"]), (ex_ilu, ["16", "0.05"]),
    (ex_pr, ["3000"])])
def test_example_main_runs_on_the_cpu(mod, argv, capsys):
    assert mod.main([*argv, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert len(out.splitlines()) >= 2


@pytest.mark.parametrize("mod", [ex_cg, ex_ilu, ex_pr])
def test_examples_run_on_the_card_by_default(mod, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(["16"])
