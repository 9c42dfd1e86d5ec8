"""The port's benchmark suite (``sblas_torch.benchmarks.run_suite``) and its
matrix cache (``sblas_torch.matrix_cache``), on the CPU at small sizes.

Each stage runs on tiny matrices through the same functions the card runs
at full size (``device="cpu"``: the kernels' plain versions, timed on the
host clock) and must write the records it names, each validated against
scipy by the bench under it; a stage that raises is recorded and makes the
run exit 1. The suite's case tables are held to the JAX package's suite
(``benchmarks/run_suite.py``, run with its generators and benches
recording their calls): the same generator calls under the same names.
"""

import argparse
import json
import os
import runpy
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import sblas.bench_lib as ref_bench_lib
import sblas.datasets as ref_datasets
from sblas.utils.timing import BenchRecord as RefRecord
from sblas_torch import datasets
from sblas_torch.benchmarks import run_suite as rs
from sblas_torch.matrix_cache import cached_matrix, entry_dir

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _suite(tmp_path) -> rs.Suite:
    return rs.Suite(tmp_path / "out.jsonl", CPU, "cpu")


def _lines(path: Path) -> list[dict]:
    return [json.loads(line) for line in path.read_text().splitlines()]


def _band():
    return datasets.banded(300, 5)


def _graph():
    return datasets.powerlaw_graph(2000, 8.0, seed=1)


def _factor():
    return datasets.cholesky_factor(datasets.poisson2d_nd(
        10, dtype=np.float64), dtype=np.float64)


def test_fem_stages_write_their_records(tmp_path):
    s = _suite(tmp_path)
    rs.stage_fem_spmv(s, {"band": _band})
    rs.stage_fem_spmm(s, {"band": _band})
    recs = _lines(s.out)
    spmv = [r for r in recs if r["stage"] == "fem_spmv"]
    assert [r["value_dtype"] for r in spmv] == ["float32", "bfloat16",
                                                "float64"]
    assert [r["dtype"] for r in spmv] == ["float32", "float32", "float64"]
    spmm = [r for r in recs if r["stage"] == "fem_spmm"]
    assert [r["name"] for r in spmm] == ["spmm_k8"] * 2 + ["spmm_k32"] * 2
    assert [r.get("block_rows") for r in spmm[1::2]] == [64, 64]
    for r in recs:
        assert r["matrix"] == "band" and r["card"] == "cpu"
        assert r["rel_err"] < 2e-2 and r["timer"] == "host"


def test_solves_stage_times_the_three_orders(tmp_path):
    s = _suite(tmp_path)
    rs.stage_solves(s, {"tri": _factor}, f64=("tri",), compare=("tri",))
    recs = _lines(s.out)
    names = [(r["name"], r.get("dtype"), r.get("case")) for r in recs]
    assert names == [("sptrsv", "float32", None),
                     ("sptrsm_k8", "float32", None),
                     ("sptrsv_orders", None, "K=1"),
                     ("sptrsv_orders", None, "K=8"),
                     ("sptrsv_orders", None, "trans K=1"),
                     ("sptrsv", "float64", None),
                     ("sptrsm_k8", "float64", None)]
    assert recs[0]["reference_us"] > 0 and "reference_us" not in recs[5]
    for r in recs[2:5]:
        assert {"ticket_us", "level_us", "row_order_us"} <= set(r)
    assert recs[5]["rel_err"] < 1e-10


def test_graph_stage_writes_k_1_8_32(tmp_path):
    s = _suite(tmp_path)
    rs.stage_graphs(s, {"g": _graph})
    recs = _lines(s.out)
    assert [r["name"] for r in recs] == ["spmv", "spmm_k8", "spmm_k32"]
    assert all(r["rel_err"] < 2e-5 for r in recs)


def _grids():
    return {"poisson2d(12)": lambda: datasets.poisson2d(
                12, dtype=np.float64),
            "convection_diffusion(12)": lambda: datasets.convection_diffusion(
                12, dtype=np.float64)}


def test_solvers_stage_times_the_factorizations(tmp_path):
    s = _suite(tmp_path)
    rs.stage_solvers(s, _grids())
    recs = _lines(s.out)
    fac = recs[0]
    assert fac["name"] == "factorization" and fac["n"] == 144
    assert fac["matrix"] == "poisson2d(12), convection_diffusion(12) f64"
    for key in ("ic0_factor_s", "ilu0_factor_s", "ichol_setup_s",
                "ilu_setup_s"):
        assert fac[key] > 0
    assert [r["name"] for r in recs[1:]] == [
        "cg+jacobi", "ic0-cg", "ilu0-bicgstab", "ilu0-gmres(30)"]
    assert recs[1]["true_rel_residual"] <= 2e-8
    assert recs[2]["iterations"] == rs.SOLVER_ITERS
    assert [r["matrix"] for r in recs[1:]] == ["poisson2d(12)"] * 2 + [
        "convection_diffusion(12)"] * 2
    assert {"ticket_us", "level_us", "row_order_us"} <= set(
        recs[2]["fwd_order_us"])


def test_sweeps_stage(tmp_path):
    s = _suite(tmp_path)
    rs.stage_sweeps(s, {"g": _graph}, {"tri": (_factor, (1, 8))})
    recs = _lines(s.out)
    assert [r["name"] for r in recs] == ["unit_sweep", "unit_sweep",
                                         "ticket_group_sweep"]
    assert len(recs[0]["us"]) == 15 and max(recs[0]["rel_err"].values()) \
        <= 2e-5
    assert set(recs[2]["us"]) == {"tri K=1", "tri K=8"}


def test_large_stage_goes_through_the_matrix_cache(tmp_path):
    calls = []

    def gen():
        calls.append(1)
        return datasets.random_csr(400, 400, 6, seed=3)

    for cached in (False, True):
        s = _suite(tmp_path)
        rs.stage_large(s, {"tiny": gen}, ks=(8,), root=tmp_path / "mc")
        spmv = _lines(s.out)[-2]
        assert spmv["name"] == "spmv" and spmv["gen_cached"] is cached
        assert spmv["plan_seconds_cold"] > 0 and spmv["plan_seconds_warm"] > 0
        assert spmv["rel_err"] < 2e-5
        s.out.unlink()
    assert len(calls) == 1


def test_warm_caches_fills_the_suite_key(tmp_path, capsys):
    # warm_caches generates a case into the matrix cache; the suite's
    # large stage then loads it under its own key and generates nothing
    from sblas_torch.benchmarks import warm_caches

    calls = []

    def gen():
        calls.append(1)
        return datasets.random_csr(400, 400, 6, seed=3)

    def never():
        raise AssertionError("generated again")

    root = tmp_path / "mc"
    done = warm_caches.warm({"tiny": gen, "other": never}, "tiny", root)
    assert [d[:2] for d in done] == [("tiny", gen().nnz)]
    assert (entry_dir(rs.large_key("tiny"), root) / "shape.npy").exists()
    assert "warm tiny" in capsys.readouterr().out
    s = _suite(tmp_path)
    rs.stage_large(s, {"tiny": never}, ks=(8,), root=root)
    assert _lines(s.out)[-2]["gen_cached"] is True
    assert len(calls) == 2          # the warm run and the nnz above
    assert set(warm_caches.ORDER) == set(rs.large_cases(web=True))


def test_a_failing_stage_is_recorded_and_the_run_exits_1(tmp_path):
    s = _suite(tmp_path)
    ran = []

    def boom(_):
        raise ValueError("generator failed")

    rc = s.run([("first", lambda s: ran.append(1)), ("boom", boom),
                ("after", lambda s: rs.stage_graphs(s, {"g": _graph}))])
    assert rc == 1 and ran and s.failed == ["boom"]
    recs = _lines(s.out)
    err = [r for r in recs if "error" in r]
    assert len(err) == 1 and err[0]["stage"] == "boom"
    assert "ValueError: generator failed" in err[0]["error"]
    # the stage after it still ran, and each stage ends with its launches
    assert [r["name"] for r in recs if r["stage"] == "graphs"] == [
        "spmv", "spmm_k8", "spmm_k32"]
    assert sum("launches" in r for r in recs) == 3


def test_a_clean_run_exits_0(tmp_path):
    s = _suite(tmp_path)
    assert s.run([("stream", rs.stage_stream)]) == 0
    assert _lines(s.out)[0]["name"] == "stream_triad"


def _tiny_tables(monkeypatch):
    """The suite's case tables, under their names, at small sizes."""
    tiny = {"cant": _band, "consph": _band}
    monkeypatch.setattr(rs, "fem_cases", lambda: dict(tiny))
    monkeypatch.setattr(rs, "graph_cases", lambda: {"uk-2002@0.05": _graph})
    monkeypatch.setattr(rs, "factor_cases", lambda: {
        name: _factor for name in ("band-parallel", "chol-nd-poisson2d-120",
                                   "chol-nd-poisson2d-60",
                                   "chol-nd-poisson2d-1000")})
    monkeypatch.setattr(rs, "solver_cases", _grids)


def test_main_quick_cant_on_the_cpu(monkeypatch, tmp_path):
    _tiny_tables(monkeypatch)
    out = tmp_path / "q.jsonl"
    rc = rs.main(["--device", "cpu", "--quick", "--case", "cant", "--out",
                  str(out)])
    assert rc == 0
    recs = _lines(out)
    assert recs[0]["stage"] == "start"
    benched = [(r["stage"], r["name"]) for r in recs
               if "seconds_per_iter" in r]
    assert benched == [("stream", "stream_triad"), ("fem_spmv", "spmv"),
                       ("fem_spmm", "spmm_k8"), ("fem_spmm", "spmm_k8"),
                       ("fem_spmm", "spmm_k32"), ("fem_spmm", "spmm_k32")]


def _args(argv):
    ap = argparse.ArgumentParser()
    for flag in ("--quick", "--large", "--web", "--graphs-only"):
        ap.add_argument(flag, action="store_true")
    ap.add_argument("--case", default=None)
    ap.add_argument("--k", type=int, default=None)
    return ap.parse_args(argv)


def _stages(argv):
    return [name for name, _ in rs.stages_for(_args(argv))]


def test_every_stage_through_the_suites_run(monkeypatch, tmp_path):
    # the stages a run without flags selects, on tiny tables: each writes
    # its records, and none fails
    _tiny_tables(monkeypatch)
    s = _suite(tmp_path)
    assert s.run(rs.stages_for(_args([]))) == 0
    recs = _lines(s.out)
    ends = [r["stage"] for r in recs if "stage_seconds" in r]
    assert ends == ["stream", "fem_spmv", "fem_spmm", "solves", "graphs",
                    "solvers", "sweeps"]
    benched = {}
    for r in recs:
        if "stage_seconds" not in r:
            benched.setdefault(r["stage"], []).append(r["name"])
    assert benched["fem_spmv"] == ["spmv"] * 6
    assert benched["graphs"] == ["spmv", "spmm_k8", "spmm_k32"]
    assert benched["solvers"][0] == "factorization"
    assert benched["sweeps"] == ["unit_sweep", "unit_sweep",
                                 "ticket_group_sweep"]
    assert not any("error" in r for r in recs)


def test_stage_selection():
    assert _stages([]) == ["stream", "fem_spmv", "fem_spmm", "solves",
                           "graphs", "solvers", "sweeps"]
    assert _stages(["--quick"]) == ["stream", "fem_spmv", "fem_spmm",
                                    "solves"]
    assert _stages(["--quick", "--case", "cant"]) == ["stream", "fem_spmv",
                                                      "fem_spmm"]
    assert _stages(["--large"]) == ["stream", "large"]
    assert _stages(["--graphs-only"]) == ["stream", "graphs"]
    assert _stages(["--case", "twitter7"]) == ["stream", "graphs", "sweeps"]
    assert _stages(["--case", "poisson2d"]) == ["stream", "solves",
                                                "solvers", "sweeps"]


def test_suite_runs_on_the_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        rs.main(["--quick", "--out", str(tmp_path / "x.jsonl")])


GENERATORS = ("emulate", "random_csr", "powerlaw_graph", "lower_triangular",
              "poisson2d_nd", "cholesky_factor")


def _recording(fn, calls):
    """A generator that returns, and records, its call (the dtype apart)."""
    def gen(*args, **kw):
        dt = kw.pop("dtype", None)
        call = (fn, args, tuple(sorted(kw.items())))
        calls.append((call, None if dt is None else np.dtype(dt).name))
        return call
    return gen


@pytest.fixture
def reference_suite(monkeypatch, tmp_path):
    """The JAX package's ``benchmarks/run_suite.py`` run without flags, its
    generators and benches recording: its globals, its generator calls in
    order and the matrix names of its records; the port's generators
    record into ``port_calls``."""
    ref_calls, port_calls = [], []
    for fn in GENERATORS:
        monkeypatch.setattr(ref_datasets, fn, _recording(fn, ref_calls))
        monkeypatch.setattr(datasets, fn, _recording(fn, port_calls))
    for fn in ("bench_spmv", "bench_spmm", "bench_sptrsv", "bench_sptrsm",
               "bench_dist_spmv"):
        monkeypatch.setattr(ref_bench_lib, fn,
                            lambda *a, **kw: RefRecord("bench", 1.0))
    # its f64 records run in a subprocess; its persistent compile cache off
    monkeypatch.setattr(subprocess, "run", lambda *a, **kw: SimpleNamespace(
        stdout="", stderr="", returncode=0))
    monkeypatch.setenv("SBLAS_COMPILE_CACHE", "0")
    g = runpy.run_path(str(ROOT / "benchmarks" / "run_suite.py"),
                       run_name="reference_suite")
    ref_globals = g["main"].__globals__
    monkeypatch.setitem(ref_globals, "stream_bandwidth", lambda: 1.0)
    out = tmp_path / "ref.jsonl"
    monkeypatch.setattr(sys, "argv", ["run_suite.py", "--out", str(out)])
    ref_globals["main"]()
    names = [r["matrix"] for r in _lines(out)]
    return SimpleNamespace(globals=ref_globals, calls=ref_calls,
                           names=names, port_calls=port_calls)


def _calls(tables, calls):
    """Each case's generator calls, by name, as ``calls`` records them."""
    got = {}
    for table in tables:
        for name, gen in table.items():
            del calls[:]
            gen()
            got[name] = list(calls)
    return got


def test_case_tables_are_the_reference_suites(reference_suite):
    ref = reference_suite
    port = _calls([rs.fem_cases(), rs.graph_cases(), rs.factor_cases()],
                  ref.port_calls)
    # the 1M-row factor is the port's own (the solve kernel's ticket orders
    # at scale); every other case is one of the reference suite's records
    own = {"chol-nd-poisson2d-1000"}
    assert set(port) - own <= set(ref.names)
    assert set(rs.fem_cases()) == set(ref.names[:4])
    assert set(rs.graph_cases()) == {n for n in ref.names if "@" in n}
    # the same generator calls; the FEM and graph cases also in the same
    # dtype (f32). The factors are generated in f64 and cast, which
    # test_f32_factors_are_the_f64_ones_cast holds to the reference's f32
    assert {c for name in set(port) - own for c, _ in port[name]} == {
        c for c, _ in ref.calls}
    for name in [*rs.fem_cases(), *rs.graph_cases()]:
        assert set(port[name]) <= set(ref.calls)
        assert [dt for _, dt in port[name]] == ["float32"]
    assert port["chol-nd-poisson2d-1000"][0][0] == (
        "poisson2d_nd", (1000,), ())


def test_large_cases_are_the_reference_cases(reference_suite):
    ref = reference_suite
    want = _calls([dict(ref.globals["_large_cases"](web=True))], ref.calls)
    assert _calls([rs.large_cases(web=True)], ref.port_calls) == want
    assert set(rs.large_cases()) == set(want) - {"uk-2002-full"}


@pytest.mark.parametrize("case", ["band", "chol-nd"])
def test_f32_factors_are_the_f64_ones_cast(case):
    # the reference suite generates its f32 factors in f32; the port's
    # table generates them in f64 and casts (both generators compute in
    # f64), here at a small size
    if case == "band":
        want = ref_datasets.lower_triangular(2000, 30, bandwidth=400, seed=1,
                                             dtype=np.float32)
        got = datasets.lower_triangular(2000, 30, bandwidth=400, seed=1,
                                        dtype=np.float64)
    else:
        want = ref_datasets.cholesky_factor(ref_datasets.poisson2d_nd(
            12, dtype=np.float64), dtype=np.float32)
        got = datasets.cholesky_factor(datasets.poisson2d_nd(
            12, dtype=np.float64), dtype=np.float64)
    got = got.astype(np.float32)
    assert got.dtype == want.dtype == np.float32
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_matrix_cache_round_trips(tmp_path):
    calls = []

    def gen():
        calls.append(1)
        return datasets.random_csr(300, 200, 5, seed=2)

    a = cached_matrix("rt", gen, tmp_path)
    b = cached_matrix("rt", gen, tmp_path)
    want = datasets.random_csr(300, 200, 5, seed=2)
    assert len(calls) == 1
    for m in (a, b):
        assert m.shape == want.shape
        for f in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(m, f), getattr(want, f))
    assert not b.data.flags.writeable     # memory-mapped, read-only
    # nothing left beside the entry
    assert sorted(p.name for p in tmp_path.iterdir()) == ["rt"]
    with pytest.raises(ValueError):
        entry_dir("../escape", tmp_path)


_WRITER = """
import hashlib, sys, time
from pathlib import Path
from sblas_torch import datasets
from sblas_torch.matrix_cache import cached_matrix

def gen():
    time.sleep(0.5)            # both writers generate at once
    return datasets.random_csr(2000, 2000, 8, seed=5)

a = cached_matrix("shared", gen, Path(sys.argv[1]))
h = hashlib.sha256()
for arr in (a.indptr, a.indices, a.data):
    h.update(bytes(arr))
print("SHA", a.shape, h.hexdigest())
"""


def test_two_processes_writing_one_key_load_the_same_arrays(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen([sys.executable, "-c", _WRITER, str(tmp_path)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1] for o in outs]
    shas = [o[0].split("SHA", 1)[1].strip() for o in outs]
    assert shas[0] == shas[1]
    a = cached_matrix("shared", lambda: None, tmp_path)
    want = datasets.random_csr(2000, 2000, 8, seed=5)
    np.testing.assert_array_equal(a.indices, want.indices)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["shared"]
