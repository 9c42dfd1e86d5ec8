"""``sblas_torch.trace``: the set-up spans, their totals and phases, the
launch counters' registry, and the sync-free solve's counting variant.

This file imports no JAX; the ``cuda`` test skips where torch sees no
card, and on a machine with one the file runs on its own:

    python -m pytest --noconftest tests/test_torch_trace.py -q
"""

import statistics
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sblas_torch import datasets, solvers, trace
from sblas_torch.ops.spmv import SpmvPlan

# the launch counters' names as the suite, chip_smoke.py and the tests
# have read them
LAUNCH_NAMES = {"spmv_csr", "spmv_csr_f64", "spmm_bsr", "spmm_csr",
                "spmm_csr_f64", "spmm_csr_rows", "spmm_csr_rows_f64",
                "spmm_csr_cols", "spmm_csr_cols_f64", "sptrsv_csr",
                "sptrsv_csr_f64"}


@pytest.fixture
def fresh():
    trace.reset()
    yield
    trace.reset()


def _busy(seconds: float) -> None:
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        pass


def test_span_opens_a_range_only_while_a_profiler_records(fresh,
                                                          monkeypatch):
    entered = []

    class Fake:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(trace, "record_function", Fake)
    with trace.span("sblas.test.outside", "build"):
        pass
    assert entered == [] and not trace.recording()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        assert trace.recording()
        with trace.span("sblas.test.inside", "build"):
            pass
    finally:
        prof.stop()
    assert not trace.recording()
    with trace.span("sblas.test.after", "build"):
        pass
    assert entered == ["sblas.test.inside"]
    assert set(trace.totals()["names"]) == {
        "sblas.test.outside", "sblas.test.inside", "sblas.test.after"}


def test_span_stamps_lie_on_the_profilers_clock(fresh):
    names = [f"sblas.test.clock{i}" for i in range(20)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("sblas.test.warm", "build"):
            pass
        for name in names:
            with trace.span(name, "build"):
                _busy(1e-4)
    starts = {e.name(): e.start_ns()
              for e in prof.profiler.kineto_results.events()
              if e.name() in names}
    assert set(starts) == set(names)
    stamps = {n: s for n, _, _, s, _ in trace.totals()["spans"]}
    gaps = [abs(starts[n] - stamps[n]) for n in names]
    assert statistics.median(gaps) < 50_000, gaps


def test_self_time_and_phases_add_up(fresh):
    with trace.span("sblas.test.root", "build"):
        _busy(0.002)
        with trace.span("sblas.test.convert", "convert"):
            _busy(0.003)
            with trace.span("sblas.test.upload", "upload"):
                _busy(0.002)
        with trace.span("sblas.test.convert", "convert"):
            _busy(0.001)
    with trace.span("sblas.test.second_root", "levels"):
        _busy(0.001)
    t = trace.totals()
    names = t["names"]
    root, conv, up = (names[f"sblas.test.{k}"]
                      for k in ("root", "convert", "upload"))
    assert conv["calls"] == 2 and root["calls"] == 1
    assert root["self_s"] == pytest.approx(
        root["total_s"] - conv["total_s"], abs=1e-9)
    assert conv["self_s"] == pytest.approx(
        conv["total_s"] - up["total_s"], abs=1e-9)
    assert up["self_s"] == up["total_s"] >= 0.002
    assert t["top_s"] == pytest.approx(
        root["total_s"] + names["sblas.test.second_root"]["total_s"],
        abs=1e-9)
    assert set(t["phases"]) == {"build", "convert", "upload", "levels"}
    assert sum(t["phases"].values()) == pytest.approx(t["top_s"], abs=1e-9)
    parents = {(n, p) for n, _, p, _, _ in t["spans"]}
    assert ("sblas.test.upload", "sblas.test.convert") in parents
    assert ("sblas.test.root", None) in parents


def test_span_decorates_and_checks_its_name(fresh):
    with pytest.raises(ValueError, match="sblas"):
        trace.span("cudaLaunchKernel", "build")
    with pytest.raises(ValueError, match="phase"):
        trace.span("sblas.test.x", "solve")

    @trace.span("sblas.test.decorated", "convert")
    def twice(x):
        """Doubles."""
        return 2 * x

    assert twice(3) == 6 and twice.__doc__ == "Doubles."
    assert trace.totals()["names"]["sblas.test.decorated"]["calls"] == 1


def test_the_store_keeps_totals_of_every_span_and_the_newest_in_full(
        fresh):
    n = trace.MAX_RECORDS + 10
    for i in range(n):
        with trace.span("sblas.test.many", "build"):
            pass
    t = trace.totals()
    assert t["names"]["sblas.test.many"]["calls"] == n
    assert len(t["spans"]) == trace.MAX_RECORDS
    trace.reset()
    assert trace.totals() == {"names": {}, "phases": {}, "top_s": 0.0,
                              "spans": []}


def test_threads_keep_their_own_parents(fresh):
    threads, per, errors = 16, 200, []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        try:
            for _ in range(per):
                with trace.span("sblas.test.outer", "build"):
                    with trace.span("sblas.test.inner", "convert"):
                        pass
        except Exception as e:      # reported below
            errors.append(e)

    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in pool)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    t = trace.totals()
    assert t["names"]["sblas.test.outer"]["calls"] == threads * per
    assert t["names"]["sblas.test.inner"]["calls"] == threads * per
    assert {p for n, _, p, _, _ in t["spans"]
            if n == "sblas.test.inner"} == {"sblas.test.outer"}
    assert sum(t["phases"].values()) == pytest.approx(t["top_s"], rel=1e-9)


def test_ichol_records_all_five_phases(fresh):
    a = datasets.poisson2d(24, dtype=np.float64)
    trace.reset()
    pre = solvers.ichol(a, device="cpu")
    t = trace.totals()
    assert set(t["phases"]) == set(trace.PHASES)
    assert all(v > 0 for v in t["phases"].values())
    root = t["names"]["sblas.solvers.ichol"]
    assert t["top_s"] == pytest.approx(root["total_s"], rel=1e-9)
    assert sum(t["phases"].values()) == pytest.approx(t["top_s"], rel=1e-9)
    names = t["names"]
    for name, phase, calls in [("sblas.solvers.factor", "factor", 1),
                               ("sblas.level_schedule", "levels", 2),
                               ("sblas.ticket_order", "levels", 2),
                               ("sblas.tril", "convert", 1),
                               ("sblas.csr_transpose", "convert", 1),
                               ("sblas.SptrsvPlan", "build", 2)]:
        assert (names[name]["phase"], names[name]["calls"]) == (phase, calls)
    assert names["sblas.upload"]["phase"] == "upload"
    b = torch.ones(a.shape[0], dtype=torch.float64)
    pre(b)      # a solve adds no span
    assert trace.totals()["names"] == names


def _shuffled_row(a, row):
    """``a`` with ``row``'s columns (and values) in reverse order."""
    indices, data = a.indices.copy(), a.data.copy()
    lo, hi = a.indptr[row], a.indptr[row + 1]
    indices[lo:hi], data[lo:hi] = indices[lo:hi][::-1], data[lo:hi][::-1]
    return type(a)(a.shape, a.indptr, indices, data)


def _operands(pre):
    return {f"{side}.{k}": v.numpy().tobytes()
            for side, plan in (("fwd", pre.fwd), ("bwd", pre.bwd))
            for k, v in plan._op.items() if isinstance(v, torch.Tensor)}


def test_ichol_of_a_canonical_matrix_sorts_nothing(fresh):
    # tril masks a canonical CSR row by row; only a matrix with a row out
    # of order goes through coo_to_csr, and gives the same factors
    a = datasets.poisson2d(24, dtype=np.float64)
    trace.reset()
    pre = solvers.ichol(a, device="cpu")
    names = trace.totals()["names"]
    assert "sblas.coo_to_csr" not in names
    assert names["sblas.tril"]["calls"] == 1
    trace.reset()
    shuffled = solvers.ichol(_shuffled_row(a, 100), device="cpu")
    names = trace.totals()["names"]
    assert names["sblas.coo_to_csr"]["calls"] == 1
    assert {p for n, _, p, _, _ in trace.totals()["spans"]
            if n == "sblas.coo_to_csr"} == {"sblas.tril"}
    got, want = _operands(shuffled), _operands(pre)
    assert set(got) >= {"fwd.data", "bwd.data", "fwd.inv_diag", "bwd.perm"}
    assert got == want


@pytest.mark.parametrize("build", ["jacobi", "spmv_plan"])
def test_jacobi_and_the_spmv_plan_record_build_convert_upload(fresh, build):
    a = datasets.poisson2d(16, dtype=np.float64)
    trace.reset()
    if build == "jacobi":
        solvers.jacobi(a, device="cpu")
        root = "sblas.solvers.jacobi"
    else:
        SpmvPlan(a, device="cpu")
        root = "sblas.SpmvPlan"
    t = trace.totals()
    assert set(t["phases"]) == {"build", "convert", "upload"}
    assert t["top_s"] == pytest.approx(t["names"][root]["total_s"],
                                       rel=1e-9)
    assert sum(t["phases"].values()) == pytest.approx(t["top_s"], rel=1e-9)


def test_the_registry_keeps_the_launch_counters_names(fresh):
    from sblas_torch.ops.kernels import sptrsv_csr

    counts = trace.launch_counts()
    assert set(counts) == LAUNCH_NAMES == set(trace.COUNTERS)
    assert set(counts.values()) == {0}
    sptrsv_csr.LAUNCHES_F64 += 3
    assert trace.launch_counts()["sptrsv_csr_f64"] == 3
    assert trace.counters() == {**counts, "sptrsv_csr_f64": 3}
    trace.reset()
    assert sptrsv_csr.LAUNCHES_F64 == 0


def test_a_cpu_solve_counts_nothing_even_while_profiling(fresh):
    a = datasets.poisson2d(12, dtype=np.float64)
    pre = solvers.ichol(a, device="cpu")
    b = torch.ones(a.shape[0], dtype=torch.float64)
    with profile(activities=[ProfilerActivity.CPU]):
        pre(b)
    assert trace.solve_counts() == {}
    assert set(trace.counters()) == LAUNCH_NAMES


@pytest.fixture
def cuda():
    # decided here, not at import: every test worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def test_one_traced_solve_launch_in_count_every_counts(fresh):
    cpu = torch.device("cpu")
    every = trace.COUNT_EVERY
    assert trace.solve_counts_buffer(cpu, 10) is None   # no profiler
    with profile(activities=[ProfilerActivity.CPU]):
        got = [trace.solve_counts_buffer(cpu, 10) for _ in range(2 * every + 1)]
    assert [i for i, g in enumerate(got) if g is not None] == [0, every,
                                                               2 * every]
    assert trace.solve_counts_buffer(cpu, 10) is None   # stopped
    c = trace.solve_counts()
    assert c["sptrsv_csr.traced_launches"] == 2 * every + 1
    assert c["sptrsv_csr.counted_launches"] == 3
    assert c["sptrsv_csr.launch_rows"] == 30
    assert c["sptrsv_csr.rows"] == 0        # nothing launched on it
    assert every % 2 == 1       # forward and backward solves count in turn


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_counting_solve_gives_the_plain_bits(cuda, fresh, dtype, k):
    a = datasets.poisson2d(120, dtype=dtype)
    n = a.shape[0]
    pre = solvers.ichol(a, device=cuda)
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    b = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (n, k) if k > 1 else n)).to(cuda, tdt)
    plans = (pre.fwd, pre.bwd)
    plain = [p.solve(b) for p in plans]
    torch.cuda.synchronize()
    assert trace.solve_counts() == {}      # no profiler, no buffer touched
    # forward and backward in turn, COUNT_EVERY times: the first forward
    # and the COUNT_EVERY-th launch, a backward, count
    with profile(activities=[ProfilerActivity.CPU]):
        traced = [[p.solve(b) for p in plans]
                  for _ in range(trace.COUNT_EVERY)]
        torch.cuda.synchronize()
    for pair in traced:
        for x, y in zip(plain, pair):
            assert torch.equal(x, y)
    c = trace.solve_counts()
    assert c["sptrsv_csr.traced_launches"] == 2 * trace.COUNT_EVERY
    assert c["sptrsv_csr.counted_launches"] == 2
    assert c["sptrsv_csr.rows"] == c["sptrsv_csr.launch_rows"] == 2 * n
    steps = [c[f"sptrsv_csr.{s}_cycles"] for s in trace.SOLVE_STEPS]
    load, wait, fence, gather, store = steps
    assert min(load, fence, gather, store) > 0
    assert 0 <= wait <= sum(steps)
    assert c["sptrsv_csr.polls"] >= 0
    # after the profiler stops, the plain kernel runs and the sums stay
    again = [p.solve(b) for p in plans]
    torch.cuda.synchronize()
    assert trace.solve_counts() == c
    for x, y in zip(plain, again):
        assert torch.equal(x, y)
