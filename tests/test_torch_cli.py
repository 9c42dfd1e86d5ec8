"""The port's CLI (``sblas_torch.cli``, ``sblas-torch-bench``) and the
bench layer under it, against the JAX package's CLI (``sblas.cli``) on the
same matrix specs, on the CPU (``--device cpu``: the kernels' plain
versions, timed on the host clock).

Both CLIs generate the same matrix from a spec (``_load_matrix``), and each
validates its own record against scipy: every record's ``rel_err`` (a
solve's ``true_rel_err``) is held to ``default_tol`` (``sblas/golden.py``:
2e-5 for f32), and both records carry the JAX CLI's keys.
"""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sblas.cli import _load_matrix as ref_load_matrix
from sblas.cli import main as ref_main
from sblas.golden import default_tol
from sblas.utils.timing import BenchRecord as RefRecord
from sblas_torch import bench_lib, cli, datasets
from sblas_torch.utils.timing import (BenchRecord, measure_host_seconds,
                                      stream_bandwidth)

SPECS = ["poisson:8", "band:50:3", "tri:100:4", "random:64:3",
         "chol:poisson:8"]
REF_KEYS = ("name", "seconds_per_iter", "gflops", "gbps", "matrix")


def _record(main, argv, out: Path) -> dict:
    assert main([*argv, "--json", str(out)]) == 0
    return json.loads(out.read_text().splitlines()[-1])


def _port(argv, tmp_path, tag="port"):
    return _record(cli.main, ["--device", "cpu", *argv],
                   tmp_path / f"{tag}.jsonl")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("spec", SPECS)
def test_load_matrix_matches_the_reference(spec, dtype):
    a = cli._load_matrix(spec, 1.0, dtype)
    r = ref_load_matrix(spec, 1.0, dtype)
    assert a.shape == r.shape and a.dtype == r.dtype
    np.testing.assert_array_equal(a.indptr, r.indptr)
    np.testing.assert_array_equal(a.indices, r.indices)
    np.testing.assert_array_equal(a.data, r.data)


# each subcommand on one spec, through both CLIs (the JAX CLI's auto takes
# its XLA routes on the CPU, the port's its kernels' plain versions)
RECORDS = {
    "spmv": ["spmv", "--matrix", "random:256:6", "--iters", "4"],
    "spmm": ["spmm", "--matrix", "random:256:6", "--k", "4", "--iters", "4"],
    "sptrsv": ["sptrsv", "--matrix", "tri:256:4", "--iters", "4"],
    "sptrsm": ["sptrsm", "--matrix", "tri:256:4", "--k", "4", "--iters",
               "4"],
    "solve": ["solve", "--matrix", "poisson:24", "--precond", "ichol",
              "--tol", "1e-6"],
}


@pytest.mark.parametrize("cmd", list(RECORDS))
def test_records_match_the_reference_cli(cmd, tmp_path):
    argv = RECORDS[cmd]
    ref = _record(ref_main, argv, tmp_path / "ref.jsonl")
    port = _port(argv, tmp_path)
    tol = default_tol(np.float32)
    key = "true_rel_err" if cmd == "solve" else "rel_err"
    assert ref[key] < tol and port[key] < tol
    for rec in (ref, port):
        assert all(k in rec for k in REF_KEYS), rec
        assert rec["seconds_per_iter"] > 0 and rec["gflops"] > 0
    assert port["name"] == ref["name"]
    assert port["matrix"] == ref["matrix"]
    assert port["device"] == "cpu" and port["timer"] == "host"
    if cmd != "solve":
        assert port["method"] and port["route_reason"]
    # on the CPU neither the card's bound nor cuSPARSE
    assert "bound_us" not in port and "baseline_us" not in port


def test_solve_iterations_match_the_reference(tmp_path):
    argv = ["solve", "--matrix", "poisson:24", "--precond", "ichol",
            "--tol", "1e-5"]
    ref = _record(ref_main, argv, tmp_path / "ref.jsonl")
    port = _port(argv, tmp_path)
    assert ref["name"] == port["name"] == "cg_ichol"
    assert abs(port["iterations"] - ref["iterations"]) <= 2
    assert ref["true_rel_err"] < 1e-4 and port["true_rel_err"] < 1e-4
    assert port["rel_residual"] <= 1e-5


@pytest.mark.parametrize("solver,precond", [("bicgstab", "ilu"),
                                            ("gmres", "jacobi"),
                                            ("cg", "none")])
def test_solve_takes_every_solver_and_preconditioner(solver, precond,
                                                     tmp_path):
    rec = _port(["solve", "--matrix", "poisson:16", "--dtype", "f64",
                 "--solver", solver, "--precond", precond, "--tol", "1e-8"],
                tmp_path)
    assert rec["name"] == f"{solver}_{precond}"
    assert rec["rel_residual"] <= 1e-8 and rec["true_rel_err"] < 1e-7
    assert rec["dtype"] == "float64"


def test_solve_that_does_not_converge_fails(tmp_path):
    with pytest.raises(RuntimeError, match="did not converge"):
        _port(["solve", "--matrix", "poisson:24", "--maxiter", "3"],
              tmp_path)


@pytest.mark.parametrize("alias,rows", [("bsr_pallas_t", 128),
                                        ("bsr_pallas", 64)])
def test_spmm_block_aliases_name_the_block_heights(alias, rows, tmp_path):
    rec = _port(["spmm", "--matrix", "band:300:5", "--k", "8", "--method",
                 alias, "--iters", "4"], tmp_path)
    assert rec["method"] == "block" and rec["block_rows"] == rows
    assert rec["requested"] == alias
    assert rec["rel_err"] < default_tol(np.float32)


@pytest.mark.parametrize("method", ["pallas", "pallas_ds"])
def test_spmv_takes_the_reference_route_names(method, tmp_path):
    rec = _port(["spmv", "--matrix", "poisson:16", "--dtype", "f64",
                 "--method", method, "--iters", "4"], tmp_path)
    assert rec["method"] == "csr" and method in rec["route_reason"]
    assert rec["rel_err"] < default_tol(np.float64)


def test_spmv_bf16_values(tmp_path):
    rec = _port(["spmv", "--matrix", "poisson:16", "--value-dtype", "bf16",
                 "--iters", "4"], tmp_path)
    assert rec["value_dtype"] == "bfloat16" and rec["rel_err"] < 2e-2


def test_sptrsv_options(tmp_path):
    base = ["sptrsv", "--matrix", "chol:poisson:10", "--iters", "4"]
    rec = _port([*base, "--compare-reference"], tmp_path, "ref")
    assert rec["method"] == "syncfree" and rec["reference_us"] > 0
    assert rec["speedup_vs_reference"] > 0
    rec = _port([*base, "--method", "tiles", "--tile-rows", "16"], tmp_path,
                "tiles")
    assert rec["method"] == "tiles" and rec["tile_rows"] == 16
    assert rec["rel_err"] < 1e-3
    # a truncated Jacobi solve reports how far it got, unchecked
    rec = _port([*base, "--method", "jacobi", "--sweeps", "2"], tmp_path,
                "jacobi")
    assert rec["sweeps"] == 2 and rec["rel_err"] > 1e-3


def test_no_validate_skips_the_check(tmp_path):
    rec = _port(["spmv", "--matrix", "poisson:8", "--iters", "4",
                 "--no-validate"], tmp_path)
    assert "rel_err" not in rec and rec["seconds_per_iter"] > 0


def test_stream_on_the_cpu(tmp_path):
    rec = _port(["stream"], tmp_path)
    assert rec["name"] == "stream_triad" and rec["gbps"] > 0
    assert rec["timer"] == "host"


def test_profile_writes_a_trace(tmp_path):
    _port(["spmv", "--matrix", "poisson:8", "--iters", "4", "--profile",
           str(tmp_path / "trace")], tmp_path)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_dist_spmv_is_not_offered():
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu", "dist-spmv", "--matrix", "poisson:8"])


def test_cli_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["spmv", "--matrix", "poisson:8"])


def test_record_keys_match_the_reference_record():
    extra = {"rel_err": 1e-7, "matrix": "cant"}
    port = BenchRecord("spmv", 2e-6, flops=4e6, bytes=8e6, extra=extra)
    ref = RefRecord("spmv", 2e-6, flops=4e6, bytes=8e6, extra=extra)
    assert port.as_dict() == ref.as_dict()
    assert list(port.as_dict()) == list(ref.as_dict())


def test_host_timer_gives_the_marginal_cost():
    x = torch.zeros(1 << 16)
    per = measure_host_seconds(lambda c: c + 1.0, x, iters_lo=2,
                               iters_hi=10)
    assert 0 < per < 1.0
    with pytest.raises(ValueError):
        measure_host_seconds(lambda c: c, x, iters_lo=4, iters_hi=4)
    assert stream_bandwidth("cpu", fresh=True) > 0


def test_host_timer_outlasts_a_load_that_lifts(monkeypatch):
    # a host whose load lifts in the first round's last hi run: the least hi
    # (25 fast steps) undercuts the least lo (5 slow ones); the timer goes
    # on sampling until lo too is taken without the load
    from sblas_torch.utils import timing

    clock, calls = [0.0], [0]

    def step(c):
        calls[0] += 1
        clock[0] += 8e-3 if calls[0] <= 126 else 7e-4
        return c

    monkeypatch.setattr(timing, "time", SimpleNamespace(
        perf_counter=lambda: clock[0]))
    per = measure_host_seconds(step, torch.zeros(1), iters_lo=5,
                               iters_hi=25)
    assert per == pytest.approx(7e-4)
    assert calls[0] == 1 + 2 * 5 * (5 + 25)
    # a step that never costs more at more iterations still raises
    calls[0] = 10 ** 6
    monkeypatch.setattr(timing, "time", SimpleNamespace(
        perf_counter=lambda: 0.0))
    with pytest.raises(RuntimeError, match="did not scale"):
        measure_host_seconds(step, torch.zeros(1))


def test_benches_on_the_cpu_leave_out_the_card_only_fields():
    a = datasets.poisson2d(12)
    l = datasets.cholesky_factor(datasets.poisson2d(8, dtype=np.float64))
    recs = [bench_lib.bench_spmv(a, device="cpu", iters=4),
            bench_lib.bench_spmm(a, 4, device="cpu", iters=4),
            bench_lib.bench_sptrsv(l, device="cpu", iters=4),
            bench_lib.bench_sptrsm(l, 4, device="cpu", iters=4)]
    for rec in recs:
        e = rec.extra
        assert e["timer"] == "host" and e["device"] == "cpu"
        assert e["rel_err"] < 1e-3
        for key in ("bound_us", "baseline_us", "pct_stream", "stream_gbps"):
            assert key not in e, key


def test_benches_run_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_lib.bench_spmv(datasets.banded(32, 2))


def test_sblas_torch_bench_is_installed_by_pyproject():
    import importlib
    import tomllib

    root = Path(__file__).resolve().parents[1]
    conf = tomllib.loads((root / "pyproject.toml").read_text())
    target = conf["project"]["scripts"]["sblas-torch-bench"]
    mod, fn = target.split(":")
    assert getattr(importlib.import_module(mod), fn) is cli.main
    # the JAX package's entry stays
    assert conf["project"]["scripts"]["sblas-bench"] == "sblas.cli:main"
