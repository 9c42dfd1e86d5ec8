"""The entry points of the port's distributed plans, on the CPU.

- ``sblas-torch-bench dist-spmv --device cpu --chips 2`` (with and without
  ``--mesh2d 1x2``) starts two gloo ranks and prints one validated record,
  named as the JAX CLI names its own;
- ``python -m sblas_torch.benchmarks.weak_scaling --device cpu --chips
  1,2`` under every ``--plan`` writes one validated record a count (CG: the
  single-device iteration count; the triangular solves: the reference's
  keys, one batch at one rank);
- ``dryrun_multichip(4, device="cpu")`` gates every exported plan and
  solver;
- a world of one rank in this process: the plans' collectives run (the ring
  and halo exchanges do nothing), the row plans give the single-device
  plan's bits, and ``solvers.cg`` takes a distributed plan (the SpMV
  protocol) and the single-device iterations;
- ``sblas_torch.parallel`` exports the JAX package's names, all of them
  (``NOT_PORTED`` is empty), and a dist call leaves ``jax`` and ``sblas``
  out of ``sys.modules``.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch.distributed as dist

import sblas.parallel as ref_par
import sblas_torch.parallel as par
from sblas_torch import cli, datasets, solvers
from sblas_torch.benchmarks import weak_scaling
from sblas_torch.golden import default_tol, rel_err, spmv_golden
from sblas_torch.ops.spmv import SpmvPlan
from sblas_torch.parallel.dryrun import dryrun_multichip

ROOT = Path(__file__).resolve().parents[1]
RECORD_KEYS = {"routes", "nnz_balance", "local_us", "collective_us",
               "collective_bytes", "backend", "transport", "ranks_per_card",
               "correctness_only", "rel_err", "us_by_rank"}


@pytest.mark.parametrize("mesh2d,name", [(None, "dist_spmv_nnz_balanced"),
                                         ("1x2", "dist_spmv2d_1x2")])
def test_cli_dist_spmv(capsys, mesh2d, name):
    argv = ["--device", "cpu", "dist-spmv", "--matrix", "poisson:16",
            "--chips", "2", "--iters", "5"]
    if mesh2d:
        argv += ["--mesh2d", mesh2d]
    assert cli.main(argv) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["name"] == name
    assert RECORD_KEYS <= set(rec)
    assert rec["ndev"] == 2 and len(rec["routes"]) == 2
    assert (rec["backend"], rec["transport"], rec["timer"]) == \
        ("gloo", "gloo", "host")
    assert rec["correctness_only"] is True
    assert rec["rel_err"] < default_tol(np.float32)
    assert rec["matrix"] == "poisson:16"


@pytest.mark.parametrize("plan", weak_scaling.PLANS)
def test_weak_scaling(tmp_path, plan):
    out = tmp_path / "weak.jsonl"
    assert weak_scaling.main(["--device", "cpu", "--chips", "1,2", "--plan",
                              plan, "--rows-per-chip", "300", "--kind",
                              "fem", "--out", str(out)]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["chips"] for r in recs] == [1, 2]
    for r in recs:
        assert r["correctness_only"] is True and r["backend"] == "gloo"
        if plan == "cg":
            assert r["iterations"] == r["iterations_single_chip"]
            assert r["true_rel_err"] < 2e-5
        else:
            assert r["rel_err"] < default_tol(np.float32)
            assert len(r["routes"]) == r["chips"]


@pytest.mark.parametrize("plan", ["sptrsv", "sptrsm"])
def test_weak_scaling_refuses_the_triangular_solves(tmp_path, plan):
    # the triangular solves run, and their records carry the reference's
    # keys (benchmarks/weak_scaling.py:91-135)
    out = tmp_path / "weak.jsonl"
    assert weak_scaling.main(["--device", "cpu", "--chips", "1,2", "--plan",
                              plan, "--rows-per-chip", "300", "--nrhs", "3",
                              "--out", str(out)]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["chips"] for r in recs] == [1, 2]
    for r in recs:
        assert {"rel_err", "nlevels", "nbatches", "stream_bytes_per_chip",
                "collective_bytes", "collective_vs_model", "backend",
                "correctness_only"} <= set(r)
        assert r["correctness_only"] is True and r["backend"] == "gloo"
        assert r["rel_err"] < 2e-4
        assert r["routes"] == ["syncfree"] * r["chips"]
        assert r["nbatches"] >= 1 and r["nlevels"] >= r["nbatches"]
        assert r.get("nrhs") == (3 if plan == "sptrsm" else None)
    assert recs[0]["nbatches"] == 1 and recs[1]["nbatches"] > 1


def test_dryrun_multichip_gates_every_plan():
    names = dryrun_multichip(4, device="cpu")
    assert set(names) == set(par.__all__) - {
        "make_mesh", "make_mesh2d", "make_mesh_hier", "chips_axis",
        "rows_axis", "cols_axis", "hosts_axis"}


def test_exports_are_the_reference_names_but_not_ported():
    # every name of the reference is exported; nothing is left unported
    assert par.NOT_PORTED == ()
    assert par.__all__ == ref_par.__all__
    for name in par.__all__:
        assert hasattr(par, name), name


@pytest.fixture
def world_of_one():
    # a group of one rank in this process, ended after the test
    mesh = par.make_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_world_of_one_in_process(world_of_one):
    mesh = world_of_one
    assert (mesh.size, mesh.backend, mesh.transport) == (1, "gloo", "gloo")
    assert mesh.correctness_only and mesh.ranks_per_card is None
    a = datasets.emulate("cant", scale=0.01)
    x = np.random.default_rng(0).standard_normal(a.shape[1]).astype(
        np.float32)
    y = np.random.default_rng(1).standard_normal(a.shape[0]).astype(
        np.float32)
    one = SpmvPlan(a, "auto", device="cpu")(x, 2.5, -0.5, y).numpy()
    for strategy in ("even_rows", "nnz_balanced"):
        got = par.DistSpmvPlan(a, mesh, strategy=strategy)(x, 2.5, -0.5, y)
        np.testing.assert_array_equal(got.numpy(), one)
    got = par.HaloSpmvPlan(a, mesh, local_method="auto")(x, 2.5, -0.5, y)
    np.testing.assert_array_equal(got.numpy(), one)
    want = spmv_golden(a, x, 2.5, -0.5, y)
    for plan in (par.DistSpmvPlan(a, mesh, strategy="nnz_split"),
                 par.RingSpmvPlan(a, mesh), par.Dist2DSpmvPlan(
                     a, par.make_mesh2d(device="cpu")),
                 par.HierSpmvPlan(a, par.make_mesh_hier(device="cpu"))):
        assert rel_err(plan(x, 2.5, -0.5, y).numpy(), want) < 2e-5


def test_solvers_take_a_distributed_plan(world_of_one):
    p = datasets.poisson2d(20, dtype=np.float64)
    b = np.random.default_rng(2).standard_normal(p.shape[0])
    plan = par.DistSpmvPlan(p, world_of_one)
    x, info = solvers.cg(plan, b, tol=1e-10)
    _, one = solvers.cg(p, b, tol=1e-10, device="cpu")
    assert info["iterations"] == one["iterations"]
    assert info["rel_residual"] < 1e-10
    assert x.device.type == "cpu"


_SCRIPT = """
import contextlib, io, sys
import numpy as np
from sblas_torch import cli, datasets
from sblas_torch.parallel import DistSpmvPlan, make_mesh

a = datasets.poisson2d(8)
DistSpmvPlan(a, make_mesh(device="cpu"))(np.ones(64, np.float32))
with contextlib.redirect_stdout(io.StringIO()):
    assert cli.main(["--device", "cpu", "dist-spmv", "--matrix", "poisson:8",
                     "--chips", "2", "--iters", "5"]) == 0
print("MODULES", sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "sblas")))
"""


def test_dist_calls_leave_the_jax_package_unloaded():
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "MODULES []" in out.stdout, out.stdout
