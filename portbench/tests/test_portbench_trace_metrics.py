"""The metrics read from the port's own tracing (``sblas_torch.trace``):
the set-up phases and the sync-free solve's wait share, in traced runs of
the harness at the tests' small sizes on the CPU."""

from __future__ import annotations

import pytest

from portbench import harness
from sblas_torch import trace

from .conftest import run_small

PHASES = ("factor", "levels", "convert", "upload", "build")
# the port's spans are read in the process that ran the port: one chip's
CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]
         if w["chips"] == 1]


def _traced(bench, cell):
    trace.reset()
    res, _ = run_small(bench, cell, trace=True)
    return res


@pytest.mark.parametrize("cell", CELLS)
def test_set_up_phases_are_read_and_fit_inside_the_plan(bench, cell):
    res = _traced(bench, cell)
    got = res["metrics"]
    listed = {m["name"] for m in harness.metrics_for(bench, cell, True)}
    phases = {p: harness.metric_reader(f"setup.{p}_s").read({})
              for p in PHASES}
    for p, v in phases.items():
        if f"setup.{p}_s" in listed:
            assert got[f"setup.{p}_s"]["value"] == v > 0
    if cell.endswith("cg"):         # the CG cells: a preconditioner too
        assert {"convert", "upload", "build"} <= {
            p for p, v in phases.items() if v}
    ic0 = cell == "hpcg-256.ic0-cg"
    assert (phases["factor"] is not None) == ic0
    assert (phases["levels"] is not None) == ic0
    total = sum(v for v in phases.values() if v)
    assert total == pytest.approx(trace.totals()["top_s"], rel=1e-9)
    assert total <= got["setup.plan_s"]["value"]


def test_wait_share_is_none_without_a_card(bench):
    res = _traced(bench, "hpcg-256.ic0-cg")
    assert "sptrsv.wait_pct" not in res["metrics"]
    assert harness.metric_reader("sptrsv.wait_pct").read({}) is None
    assert trace.solve_counts() == {}
