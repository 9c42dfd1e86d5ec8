"""A cell on several cards: the launcher's ranks (gloo on the CPU here,
NCCL on cards), the line merged from every rank, the faults that end a
run, and the one-chip path that starts no rank at all. The ranks run the
tests' own loop (:mod:`portbench.tests.ranked`), in a cell that only the
tests make."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench import harness, run
from portbench.launch import merge

from .conftest import SEED, run_small, small_config

ROOT = harness.ROOT
CELL = "ranked.dist-cg"
TRAFFIC = {"solver": "portbench.tests.ranked", "tol": 1e-10,
           "maxiter": 500, "work_seed": 7, "check_sample": 3, "warmup": 1,
           "trace_seconds": 0.2, "limits": {"rel_residual": 1e-8}}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def ranked_bench(chips: int) -> dict:
    """BENCHMARK.json with the tests' own cell of ``chips`` chips."""
    bench = harness.load_benchmark()
    config = {"name": "ranked", "source": "the tests' own",
              "file": "portbench/tests/ranked.json", "reduced": [],
              "why": "the tests' own multi-rank loop"}
    cell = {"name": CELL, "config": "ranked", "traffic": "jacobi-cg",
            "chips": chips, "why": "the tests' own multi-rank loop"}
    return {**bench, "configs": [*bench["configs"], config],
            "workloads": [*bench["workloads"], cell]}


CONFIG = small_config(ranked_bench(2), CELL)


def run_ranked(capfd, *, chips=2, device="cpu", trace=False, fault=None,
               deadline_s=120.0):
    """``(exit code, lines of standard output, standard error)`` of the
    tests' cell on ``chips`` ranks, through the command's own path."""
    traffic = {**TRAFFIC, **({"fault": fault} if fault else {})}
    rc = run.run_and_print(CELL, SEED, 0.5, trace, started=None,
                           bench=ranked_bench(chips), device=device,
                           config=CONFIG, traffic=traffic,
                           deadline_s=deadline_s)
    out, err = capfd.readouterr()
    return rc, out.strip().splitlines(), err


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_prints_one_merged_line(capfd, trace):
    rc, out, err = run_ranked(capfd, trace=trace)
    assert rc == 0, err[-3000:]
    assert len(out) == 1
    res = json.loads(out[0])
    keys = list(res)
    assert keys[:5] == KEYS and keys[-1] == "compared"
    assert res["correct"] is True and res["failed"] == 0
    assert res["device"]["count"] == 2
    assert res["device"]["memory_peak_bytes"] == 0      # no card
    want = {m["name"]: m for m in
            harness.metrics_for(ranked_bench(2), CELL, trace)}
    # nothing runs on a device on the CPU
    may_miss = {k for k, m in want.items() if m["source"] == "device_trace"}
    assert set(want) - may_miss <= set(res["metrics"]) <= set(want)
    if trace:
        assert "breakdown" in keys and res["device"]["window_s"] > 0
    err_lines = err.strip().splitlines()
    assert err_lines[-1].startswith("compared rel_residual ")
    n = res["attempted"]
    assert f"ranks: 2; solves [{n}, {n}]" in err
    assert "gloo" in err
    assert res["compared"]["rel_residual"]["value"] < 1e-8


FAULTS = [
    # a wrong answer on rank 1: a line, not correct
    ("wrong", 120.0, 0, "correct [True, False]"),
    # rank 1 raises: no line, its traceback on standard error
    ("raise", 120.0, 1, "planted fault: rank 1 raises"),
    # rank 1 waits before a collective: no line, ended at the deadline
    ("stop", 20.0, 1, "gave no result within 20 s"),
    # rank 1 loads a forbidden module: no line, exit 3
    ("import", 120.0, 3, "forbidden modules loaded: ['jax']"),
]


@pytest.mark.parametrize("kind,deadline_s,code,said", FAULTS)
def test_a_fault_on_one_rank(capfd, kind, deadline_s, code, said):
    rc, out, err = run_ranked(capfd, fault={"rank": 1, "kind": kind},
                              deadline_s=deadline_s)
    assert rc == code, err[-3000:]
    assert said in err
    if kind == "wrong":
        res = json.loads(out[-1])
        assert res["correct"] is False and res["failed"] > 0
        c = res["compared"]["rel_residual"]
        assert not c["value"] < c["limit"]
    else:
        assert out == []
    if kind == "raise":
        assert "rank 1 raised" in err and "Traceback" in err


def test_run_small_runs_a_cell_of_several_chips_as_ranks():
    """The tests' helper takes a cell of several chips as the command
    does: as its ranks."""
    res, lines = run_small(ranked_bench(2), CELL, traffic=TRAFFIC)
    assert res["correct"] is True and res["device"]["count"] == 2
    assert lines[-2].startswith("ranks: 2; ")
    assert CONFIG["nx"] == 16 and CONFIG["kind"] == "portbench.tests.ranked"


def _part(plan_s, solves, value, peak, correct=True, over=0):
    return {"rec": {"plan_s": plan_s, "times": [0.1] * solves,
                    "setup_s": plan_s + 1.0},
            "correct": correct, "over": over,
            "compared": {"rel_residual": (value, 1e-8)}, "peak": peak}


def test_merge_reads_rank_0_and_the_worst_rank():
    parts = [_part(1.0, 5, 2e-9, 30), _part(3.0, 5, 4e-9, 10),
             _part(2.0, 5, 1e-9, 20)]
    m = merge(parts)
    assert m["rec"]["setup_s"] == 2.0 and m["rec"]["plan_s"] == 3.0
    assert m["rec"]["ranks"] == [p["rec"] for p in parts]
    assert m["compared"] == {"rel_residual": (4e-9, 1e-8)}
    assert m["peak"] == 30 and m["correct"] is True and m["over"] == 0
    # one rank not correct, or one rank with another count of solves
    assert merge([_part(1, 5, 1e-9, 1), _part(1, 5, 2e-8, 1, False, 2)]
                 )["over"] == 2
    assert merge([_part(1, 5, 1e-9, 1), _part(1, 5, 2e-8, 1, False, 2)]
                 )["correct"] is False
    assert merge([_part(1, 5, 1e-9, 1), _part(1, 4, 1e-9, 1)]
                 )["correct"] is False
    # a NaN is the worst reading
    nan = merge([_part(1, 5, 1e-9, 1), _part(1, 5, float("nan"), 1, False)])
    assert nan["compared"]["rel_residual"][0] != \
        nan["compared"]["rel_residual"][0]


def test_a_one_chip_run_starts_no_rank():
    """The one-chip path runs in its own process: no process group, no
    child Python process, and the launcher is never imported."""
    code = (
        "import json, subprocess, sys\n"
        "import multiprocessing.process as mpp\n"
        "import torch.distributed as dist\n"
        "started = []\n"
        "class Recording(subprocess.Popen):\n"
        "    def __init__(self, args, *a, **k):\n"
        "        started.append([str(x) for x in args])\n"
        "        super().__init__(args, *a, **k)\n"
        "subprocess.Popen = Recording\n"
        "_start = mpp.BaseProcess.start\n"
        "def start(self):\n"
        "    started.append(['multiprocessing'])\n"
        "    return _start(self)\n"
        "mpp.BaseProcess.start = start\n"
        "from portbench import harness, run\n"
        "from portbench.tests.conftest import small_config\n"
        "b = harness.load_benchmark()\n"
        "cell = 'hpcg-256.jacobi-cg'\n"
        "rc = run.run_and_print(cell, 5, 0.2, False, started=None,\n"
        "    bench=b, device='cpu', config=small_config(b, cell))\n"
        "print(json.dumps({'rc': rc, 'group': dist.is_initialized(),\n"
        "    'launch': 'portbench.launch' in sys.modules,\n"
        "    'pythons': [a for a in started if a[0] == sys.executable\n"
        "                or 'multiprocessing' in a]}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    *lines, last = out.stdout.strip().splitlines()
    assert json.loads(last) == {"rc": 0, "group": False, "launch": False,
                                "pythons": []}
    assert json.loads(lines[-1])["correct"] is True


@pytest.mark.cuda
def test_ranks_over_nccl(card, capfd):
    """On a host with two cards or more: the tests' loop on one rank a
    card, the group under NCCL."""
    chips = torch.cuda.device_count()
    if chips < 2:
        pytest.skip("needs two cards or more: NCCL takes one rank a card")
    rc, out, err = run_ranked(capfd, chips=chips, device="cuda")
    assert rc == 0, err[-3000:]
    res = json.loads(out[-1])
    assert res["correct"] is True and res["device"]["count"] == chips
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["memory_peak_bytes"] > 0
    assert "nccl, nccl" in err
