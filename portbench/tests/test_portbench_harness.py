"""The harness: everything found by name from BENCHMARK.json, the result
line's keys, the forbidden imports, the refusal without a card, and the
byte counts of the roofline shares."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness, roofline
from portbench.solves import cg as cg_solves
from portbench.solves import pagerank as pr_solves
from portbench.spans import Spans

from .conftest import SEED, run_small, small_config

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]
# the cells of the first benchmark, each on one chip
ONE_CHIP = {"hpcg-256.ic0-cg", "gap-kron25.pagerank", "gap-kron25.ppr-k32",
            "hpcg-256.jacobi-cg"}
# counters that only a kernel's CUDA build fills (the solve's cycle sums)
CARD_COUNTERS = {"sptrsv.wait_pct"}


def test_everything_found_by_name(bench):
    for w in bench["workloads"]:
        cfg = harness.config_of(bench, w["config"])
        harness.module("generators", cfg["kind"]).generate
        params = harness.traffic_of(w["traffic"])
        harness.module("solves", params["solver"]).Solves
        for trace in (False, True):
            for m in harness.metrics_for(bench, w["name"], trace):
                assert callable(harness.metric_reader(m["name"]).read)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (harness.PKG / "metrics" / f"{m['name']}.py").exists()


def test_contract_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert harness.metrics_for(bench, w["name"], True)
        assert len(harness.metrics_for(bench, w["name"], False)) >= 2
        assert w["chips"] == 1 or w["name"] not in ONE_CHIP
    fours = [w for w in bench["workloads"] if w["chips"] == 4]
    assert len(fours) <= max(1, len(bench["workloads"]) // 4)
    assert ONE_CHIP <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(bench, cell, trace):
    res, lines = run_small(bench, cell, trace=trace)
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "compared"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    want = {m["name"] for m in harness.metrics_for(bench, cell, trace)}
    got = set(res["metrics"])
    # on the CPU nothing runs on a device: the device-trace metrics and
    # the counters that only a card fills are left out, every other one
    # is there
    device_only = {m["name"] for m in bench["per_layer"]
                   if m["source"] == "device_trace"} | CARD_COUNTERS
    if res["attempted"] < 20:           # too few solves for a tail
        device_only.add("solve_p95_ms")
    assert want - device_only <= got <= want
    for m in res["metrics"].values():
        assert isinstance(m["value"], float) and m["unit"]
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert "breakdown" in keys and res["device"]["window_s"] > 0
    assert lines[-1].startswith("compared ")
    for name, c in res["compared"].items():
        assert c["value"] < c["limit"]
    json.dumps(res)


def test_forbidden_compares_whole_names():
    assert harness.forbidden_modules(["sblas_torch", "sblas_torch.ops",
                                      "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_modules(["sblas.ops", "jax.numpy", "jaxlib",
                                      "flax"]) == ["flax", "jax", "jaxlib",
                                                   "sblas"]


def test_a_run_loads_no_jax_or_sblas():
    """Nor does any rank of a cell of several chips."""
    code = (
        "import json\n"
        "from portbench import harness\n"
        "from portbench.tests.conftest import SEED, small_config\n"
        "b = harness.load_benchmark()\n"
        "found = set()\n"
        "for c in [w['name'] for w in b['workloads']]:\n"
        "    found.update(harness.run_cell(\n"
        "        c, SEED, 0.1, True, device='cpu', bench=b,\n"
        "        config=small_config(b, c))[2])\n"
        "print(json.dumps(sorted(found)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("chips", [1, 4])
def test_refuses_without_the_cells_chips(tmp_path, chips):
    """Exit 2 and no result where torch sees fewer cards than the cell
    asks for: a cell of BENCHMARK.json, and, in a copied tree, a cell
    that asks for four."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= chips:
        pytest.skip(f"there are {chips} card(s) here")
    root, cell = ROOT, CELLS[0]
    if chips > 1:
        bench = harness.load_benchmark()
        cell = "copied.four-chips"
        bench["workloads"].append({**bench["workloads"][0], "name": cell,
                                   "chips": chips})
        (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
        shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        root = tmp_path
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell,
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout.strip() == ""
    assert f"needs {chips} CUDA device(s)" in out.stderr


def test_fails_with_only_the_benchmark(tmp_path):
    """A checkout holding only BENCHMARK.json and portbench/ has no
    program to run: the run fails and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys\n"
            "from portbench import harness\n"
            "from portbench.tests.conftest import run_small\n"
            "run_small(harness.load_benchmark(), sys.argv[1])\n"
            "print('{}')\n")
    out = subprocess.run([sys.executable, "-c", code, CELLS[0]],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "sblas_torch" in out.stderr


def _least_by_route(inputs, params, methods):
    out = {}
    for method in methods:
        spans = Spans(True)
        mod = cg_solves if params["solver"] == "cg" else pr_solves
        s = mod.Solves(inputs, {**params, "method": method}, SEED, "cpu",
                       spans)
        s.build()
        spans.active = True
        s.solve(0)
        name = "spmv" if params.get("k", 1) == 1 else "spmm"
        out[method] = spans.least_s[name] / spans.calls[name]
    return out


def test_bytes_do_not_depend_on_the_route(bench):
    """The least time a call of the SpMV or SpMM ranges is counted from
    the operands: the same on every route of the port."""
    from portbench.generators import hpcg, kron

    cfg = small_config(bench, "hpcg-256.jacobi-cg")
    a = hpcg.generate(cfg, SEED, "cpu")
    p = harness.traffic_of("jacobi-cg")
    least = _least_by_route(a, p, ["csr", "merge", "coo", "ell", "bucket"])
    assert len(set(least.values())) == 1
    g = kron.generate(small_config(bench, "gap-kron25.pagerank"), SEED,
                      "cpu")
    least = _least_by_route(g, harness.traffic_of("pagerank"),
                            ["csr", "merge", "pseg", "bucket"])
    assert len(set(least.values())) == 1
    least = _least_by_route(g, harness.traffic_of("ppr-k32"),
                            ["merge", "pseg", "spmv_passes", "ell"])
    assert len(set(least.values())) == 1


def test_roofline_counts():
    # CSR of 10 rows, 30 nonzeros, f64: values and columns, indptr, x, y
    assert roofline.spmm_bytes(10, 10, 30, 1, 8, 8, False) == \
        30 * 12 + 11 * 4 + 20 * 8
    assert roofline.spmm_bytes(10, 10, 30, 4, 4, 4, True) == \
        30 * 8 + 11 * 4 + 30 * 4 * 4
    assert roofline.sptrsv_bytes(10, 20, 1, 8, 8) == 20 * 12 + 44 + 160
    assert roofline.least_seconds(3.35e12, 0, torch.float32) == 1.0
    assert roofline.least_seconds(0, 34e12, torch.float64) == 1.0


@pytest.mark.cuda
def test_card_run(card):
    """On a card: one short run of the first cell, through the command."""
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
