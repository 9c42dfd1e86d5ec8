"""One run of one cell: generate, set up, warm up, measure, check.

Everything a cell needs is found by name from ``BENCHMARK.json``: the
configuration's file (its ``"kind"`` names ``portbench/generators/<kind>.py``),
the traffic mix's data file ``portbench/traffic/<traffic>.json`` (its
``"solver"`` names ``portbench/solves/<solver>.py``) and each metric's
reader ``portbench/metrics/<metric>.py``. A new cell, mix or metric is new
files and entries; no file here changes for it. A cell on N > 1 cards runs
as N ranks, each through :func:`run` with its ``rank`` and ``world``
(:mod:`portbench.launch`).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch
from torch.profiler import record_function

from . import trace as trace_mod
from .spans import Spans

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# top-level module names no run may load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "sblas")


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_of(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config_of(bench: dict, name: str, root: Path = ROOT) -> dict:
    return json.loads((root / _named(bench["configs"], name,
                                     "config")["file"]).read_text())


def traffic_of(name: str) -> dict:
    return json.loads((PKG / "traffic" / f"{name}.json").read_text())


def module(kind: str, name: str):
    """``portbench.<kind>.<name>`` (``generators``, ``solves``), or the
    module ``name`` where it is a path under the package
    (``portbench.tests.…``: the tests' own generators and loops)."""
    return importlib.import_module(
        name if name.startswith("portbench.") else f"portbench.{kind}.{name}")


def metric_reader(name: str):
    """The reader of metric ``name``: ``portbench/metrics/<name>.py``."""
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(bench: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics (``trace`` False) or per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


class RankFailure(RuntimeError):
    """A rank of a cell on several cards raised, ended without its result,
    or gave none by the deadline (:mod:`portbench.launch`)."""


def forbidden_modules(names=None) -> list:
    """The top-level names in ``names`` (default: ``sys.modules``) that
    are in ``FORBIDDEN``, compared whole: ``sblas_torch`` is not
    ``sblas``."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *,
             bench=None, **kw) -> tuple[dict, list, list]:
    """``(result, lines, forbidden)`` of one run of the cell as the command
    makes it: one chip in this process (:func:`run`), several chips as
    their ranks (:func:`portbench.launch.run_ranks`: raises
    :class:`RankFailure`); ``forbidden``, the forbidden modules loaded by
    every process of the run. ``kw`` as :func:`run` and ``run_ranks`` take
    it."""
    bench = bench or load_benchmark()
    chips = int(cell_of(bench, cell_name)["chips"])
    if chips == 1:
        result, lines = run(cell_name, seed, seconds, trace, bench=bench,
                            **kw)
        return result, lines, forbidden_modules()
    from .launch import run_ranks

    return run_ranks(cell_name, seed, seconds, trace, world=chips,
                     bench=bench, **kw)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        device="cuda", started: float | None = None, bench=None,
        config=None, traffic=None, control: bool = False,
        rank: int = 0, world: int = 1) -> tuple[dict | None, list]:
    """``(result, lines)``: the result line's object and the lines for
    standard error, the numbers compared (``compared <name> <value> limit
    <limit>``) last. ``started``: the ``time.perf_counter()`` reading the
    set-up counts from (default: now);
    ``config``/``traffic`` replace the named files (the tests' small
    sizes); ``control`` runs the port's lower-precision path of the mix's
    ``"control"`` instead (:mod:`portbench.control`). With ``world`` > 1
    this is rank ``rank`` of a running process group: the generator and
    the loop get ``rank`` and ``world``, the ranks keep in step
    (:class:`portbench.launch.Lockstep`), and rank 0 returns the line
    merged from every rank's (:func:`portbench.launch.merge`); the other
    ranks return None for it."""
    t_begin = time.perf_counter() if started is None else started
    bench = bench or load_benchmark()
    cell = cell_of(bench, cell_name)
    cfg = config or config_of(bench, cell["config"])
    params = traffic or traffic_of(cell["traffic"])
    device = torch.device(device)
    ranked, steps = {}, None
    if world > 1:
        from .launch import Lockstep

        ranked, steps = {"rank": rank, "world": world}, Lockstep(rank, world)

    t = time.perf_counter()
    before_s = t - t_begin
    inputs = module("generators", cfg["kind"]).generate(cfg, seed, device,
                                                        **ranked)
    _sync(device)
    gen_s = time.perf_counter() - t
    spans = Spans(bool(trace))
    t = time.perf_counter()
    solves = module("solves", params["solver"]).Solves(
        inputs, params, seed, device, spans, control=control, **ranked)
    _sync(device)
    work_s = time.perf_counter() - t
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    solves.build()
    _sync(device)
    plan_s = time.perf_counter() - t

    warm = int(params.get("warmup", 1))
    t = time.perf_counter()
    for w in range(warm):
        solves.solve(-1 - w)
    per_solve = (time.perf_counter() - t) / warm
    solves.window(max(1, int(seconds / max(per_solve, 1e-9))))
    if steps is not None:
        steps.barrier()
    setup_s = time.perf_counter() - t_begin

    prof, summary = None, None
    trace_s = min(seconds, float(params.get("trace_seconds", 2.0)))
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()
        spans.active = True
    times, i = [], 0
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        if spans.active:
            with record_function(trace_mod.SOLVE):
                solves.solve(i)
        else:
            solves.solve(i)
        t1 = time.perf_counter()
        times.append(t1 - t0)
        i += 1
        stop_trace = spans.active and t1 - t_start >= trace_s
        done = t1 - t_start >= seconds
        if steps is not None:       # rank 0 decides for every rank
            stop_trace, done = steps.decide(stop_trace, done)
        if stop_trace:
            prof.stop()
            spans.active = False
        if done:
            break
    window_s = t1 - t_start
    if spans.active:
        prof.stop()
        spans.active = False
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    if prof is not None:
        summary = trace_mod.summarize(prof.profiler.kineto_results.events(),
                                      tuple(sorted(spans.names)))
        prof = None

    info = solves.info()
    solves.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    compared, over = solves.compare()
    correct = over == 0 and all(v < lim for v, lim in compared.values())

    rec = {"setup_s": setup_s, "times": times, "window_s": window_s,
           "plan_s": plan_s, "info": info, "trace": summary,
           "spans": {"calls": dict(spans.calls),
                     "least_s": dict(spans.least_s)}}
    ranks_line = []
    if steps is not None:
        from .launch import merge

        parts = steps.gather({"rec": rec, "correct": correct, "over": over,
                              "compared": compared, "peak": int(peak)})
        if rank != 0:
            return None, []
        merged = merge(parts)
        rec, correct, over, compared, peak = (
            merged[k] for k in ("rec", "correct", "over", "compared", "peak"))
        ranks_line = [
            f"ranks: {world}; solves {[len(p['rec']['times']) for p in parts]}"
            f", plan_s {[p['rec']['plan_s'] for p in parts]}, peak bytes "
            f"{[p['peak'] for p in parts]}, correct "
            f"{[p['correct'] for p in parts]}"]
    metrics = {}
    for m in metrics_for(bench, cell_name, bool(trace)):
        v = metric_reader(m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(times),
              "failed": int(over), "metrics": metrics, "device": dev}
    if trace and summary is not None:
        dev["busy_s"], dev["window_s"] = summary["busy_s"], \
            summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in compared.items()}
    lines = [f"matrix: {inputs['shape'][0]} rows, "
             f"{inputs['indices'].numel()} nonzeros",
             f"phases: start {before_s:.3f} s, generate {gen_s:.3f} s, "
             f"the work {work_s:.3f} s, port set-up {plan_s:.3f} s, "
             f"a warm-up solve {per_solve:.4f} s, window {window_s:.3f} s, "
             f"{len(times)} solves of {info.get('iterations')} iterations; "
             f"{info.get('route')}"]
    if summary is not None:
        lines.append(
            f"trace: {summary['solves']} solves, {summary['device_events']} "
            f"device operations, {summary['launch_links']} linked to their "
            f"launch; device seconds by range {summary['device_s']}")
    lines += ranks_line
    lines += [f"compared {k} {v!r} limit {lim!r}"
             for k, (v, lim) in compared.items()]
    return result, lines
