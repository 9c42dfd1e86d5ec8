"""The cell on several cards, ``hpcg-4x256.dist-cg``: its generator's rows
against HPCG's whole matrix, and the cell on gloo ranks of the CPU at its
small size: correct on two ranks and on its own four, not correct under
its control (CG in float32) or with one rank's answers scaled by
``1 + 1e-3``, and correct where one rank's warm-up counted other solves
(:mod:`portbench.tests.dist_cg_fault`)."""

from __future__ import annotations

import pytest
import torch

from portbench import harness
from portbench.generators import hpcg, hpcg_ranks

from .conftest import SEED, run_small, small_config

CELL = "hpcg-4x256.dist-cg"


def two_rank_bench() -> dict:
    """BENCHMARK.json with the cell on two chips."""
    bench = harness.load_benchmark()
    cells = [{**w, "chips": 2} if w["name"] == CELL else w
             for w in bench["workloads"]]
    return {**bench, "workloads": cells}


def run_two_ranks(*, trace: bool = False, traffic: dict | None = None):
    """``(result, lines)`` of the cell at its small size on two ranks."""
    bench = two_rank_bench()
    config = {**small_config(bench, CELL), "process_grid": [1, 1, 2]}
    result, lines, _ = harness.run_cell(
        CELL, SEED, 0.3, trace, device="cpu", bench=bench, config=config,
        traffic=traffic, deadline_s=120.0)
    return result, lines


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("box", [(8, 8, 8), (5, 6, 7)])
def test_the_ranks_rows_are_hpcgs_matrix(bench, world, box):
    cfg = {**harness.config_of(bench, "hpcg-4x256"),
           "nx": box[0], "ny": box[1], "nz": box[2],
           "process_grid": [1, 1, world]}
    whole = hpcg.generate({**cfg, "nz": box[2] * world}, 0, "cpu")
    parts = [hpcg_ranks.generate(cfg, 0, "cpu", rank=r, world=world)
             for r in range(world)]
    rows = box[0] * box[1] * box[2]
    assert [p["row0"] for p in parts] == [r * rows for r in range(world)]
    assert all(p["shape"] == (rows, whole["shape"][0]) for p in parts)
    offsets = [0] + [int(p["indptr"][-1]) for p in parts]
    indptr = torch.cat([parts[0]["indptr"][:1]] + [
        p["indptr"][1:] + sum(offsets[:r + 1]) for r, p in enumerate(parts)])
    assert torch.equal(indptr, whole["indptr"])
    for key in ("indices", "data"):
        got = torch.cat([p[key] for p in parts])
        assert got.dtype == whole[key].dtype
        assert torch.equal(got, whole[key])


def test_the_generator_refuses_another_process_grid(bench):
    cfg = small_config(bench, CELL)
    with pytest.raises(ValueError, match="process grid"):
        hpcg_ranks.generate(cfg, 0, "cpu", rank=0, world=2)


@pytest.mark.parametrize("trace", [False, True])
def test_correct_on_two_ranks(trace):
    res, lines = run_two_ranks(trace=trace)
    assert res["correct"] is True and res["failed"] == 0
    assert res["device"]["count"] == 2
    assert lines[-2].startswith("ranks: 2; ")
    assert "gloo, gloo, halo " in "\n".join(lines)
    c = res["compared"]["rel_residual"]
    assert c["value"] < c["limit"] == 1.001e-8
    assert res["metrics"]["dist.iters" if trace else "solve_ms"]["value"] > 0


def test_control_is_not_correct(bench):
    res, lines = run_small(bench, CELL, control=True)
    assert res["correct"] is False and res["device"]["count"] == 4
    c = res["compared"]["rel_residual"]
    assert not c["value"] < c["limit"]
    assert lines[-1].startswith("compared rel_residual ")


def _planted(kind: str) -> dict:
    return {**harness.traffic_of("dist-cg"), "check_sample": 2,
            "solver": "portbench.tests.dist_cg_fault",
            "fault": {"rank": 1, "kind": kind}}


def test_one_ranks_scaled_answer_is_not_correct():
    res, _ = run_two_ranks(traffic=_planted("scaled"))
    assert res["correct"] is False and res["failed"] > 0
    c = res["compared"]["rel_residual"]
    assert not c["value"] < c["limit"]


def test_the_ranks_keep_the_same_solves_whatever_their_warm_ups():
    """A rank whose warm-up gave it another count of the window's solves
    still keeps rank 0's sample: the check's collectives pair up."""
    res, _ = run_two_ranks(traffic=_planted("slow_warmup"))
    assert res["correct"] is True and res["failed"] == 0

