"""Start a group of local ranks: :func:`spawn`, and the rank side of the
tests (:func:`run_cases`).

    from sblas_torch.parallel.launch import spawn
    results = spawn(4, fn, arg, device="cpu")   # fn(arg) on 4 ranks

:func:`spawn` starts ``world`` processes through ``torch.multiprocessing``
(start method ``spawn``: each imports afresh, so ``fn`` must be importable
by name from a module that imports no JAX), gives each the environment
``torchrun`` gives its ranks (``MASTER_ADDR``, ``MASTER_PORT`` on a free
port of ``localhost``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``), starts the default group there
(:func:`~sblas_torch.parallel.mesh.init_world`: ``gloo`` on the CPU,
``nccl`` or ``gloo`` on cards by the backend rule), runs ``fn(*args)`` and
returns each rank's result, in rank order. A CPU rank computes on one
thread at a lower priority (``nice`` 10), so that ranks do not crowd out
the host's other work. For ranks on a
card it builds the CUDA kernels first, once, in the calling process. A rank
that raises ends the group: the others are stopped, and :func:`spawn`
raises with that rank's traceback.
"""

from __future__ import annotations

import json
import os
import queue
import socket
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import init_world

# a group's deadline: past it the ranks still running are stopped (a rank
# that waits in a collective for a rank that died waits for ever)
TIMEOUT_S = 1800.0


def free_port() -> int:
    """A TCP port of ``localhost`` that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _child(rank: int, world: int, port: int, device: str, fn, args,
           results) -> None:
    os.environ.update({"MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
                       "RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank),
                       "LOCAL_WORLD_SIZE": str(world)})
    dev = torch.device(device)
    if dev.type == "cpu":
        # CPU ranks check the plans beside other work on the host: one
        # thread each, below its priority, so that they crowd nothing out
        torch.set_num_threads(1)
        os.nice(10)
    elif dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    try:
        init_world(dev)
        results.put((rank, None, fn(*args)))
    except Exception:           # reported to the parent, which raises
        results.put((rank, traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(world: int, fn, *args, device="cuda") -> list:
    """``fn(*args)`` on ``world`` local ranks on ``device`` (``"cpu"``, or
    ``"cuda"``: rank ``r`` on card ``r % device_count``); their results in
    rank order. Raises ``RuntimeError`` naming the first rank that failed,
    or after ``TIMEOUT_S`` seconds."""
    device = str(device)
    if torch.device(device).type == "cuda":
        from ..ops.kernels import _build

        _build.build()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_child, args=(rank, world, port, device, fn,
                                               args, results))
             for rank in range(world)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + TIMEOUT_S
    try:
        # drain the queue before joining: a child blocks on a full pipe
        while len(out) < world:
            try:
                rank, err, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} died (exit "
                                       f"{procs[dead[0]].exitcode})")
                if time.monotonic() > deadline:
                    late = sorted(set(range(world)) - set(out))
                    raise RuntimeError(f"ranks {late} gave no result in "
                                       f"{TIMEOUT_S} s")
                continue
            if err is not None:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{err}")
            out[rank] = value
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return [out[r] for r in range(world)]


def save_matrix(arrays: dict, name: str, a) -> None:
    """Put the CSR ``a`` into ``arrays`` (for ``np.savez``) under ``name``."""
    arrays[f"{name}.shape"] = np.asarray(a.shape, dtype=np.int64)
    for f in ("indptr", "indices", "data"):
        arrays[f"{name}.{f}"] = getattr(a, f)


def load_matrix(arrays, name: str):
    """The CSR that :func:`save_matrix` put under ``name``."""
    from ..formats import CSR

    return CSR(tuple(int(v) for v in arrays[f"{name}.shape"]),
               arrays[f"{name}.indptr"], arrays[f"{name}.indices"],
               arrays[f"{name}.data"])


def _mesh_of(spec: list, device: str):
    from . import make_mesh, make_mesh2d, make_mesh_hier

    kind, *sizes = spec
    make = {"1d": make_mesh, "2d": make_mesh2d, "hier": make_mesh_hier}[kind]
    return make(*sizes, device=device)


def _run_case(case: dict, mesh, arrays) -> tuple:
    from .. import parallel, solvers

    a = load_matrix(arrays, case["matrix"])
    kw = case.get("kw", {})
    if "solver" in case:
        m = solvers.jacobi(a, device=mesh.device) if case.get("jacobi") \
            else None
        x, info = getattr(parallel, case["solver"])(
            a, arrays[case["b"]], mesh=mesh, M=m, **kw)
        return x.cpu().numpy(), info
    plan = getattr(parallel, case["plan"])(a, mesh, **kw)
    y = arrays[case["y"]] if "y" in case else None
    out = plan(arrays[case["x"]], case.get("alpha", 1.0),
               case.get("beta", 0.0), y)
    return out.cpu().numpy(), {"route": plan.local_method,
                               "routes": [r[0] for r in plan.routes]}


def run_cases(workdir: str) -> int:
    """The rank side of the tests. Runs each case of ``workdir/cases.json``
    (``{"device", "cases": [...]}``; a case names a mesh (``["1d", P]``,
    ``["2d", R, C]`` or ``["hier", H, C]``), a plan of
    :mod:`sblas_torch.parallel` or a solver, its keywords, and the arrays of
    ``workdir/arrays.npz`` it takes) on this rank, and writes its output
    arrays to ``workdir/out_<rank>.npz`` and what it reported, or the
    ``ValueError`` it raised, to ``workdir/out_<rank>.json``. Every rank
    makes the same meshes in the same order. Returns the number of
    cases."""
    wd = Path(workdir)
    spec = json.loads((wd / "cases.json").read_text())
    arrays = np.load(wd / "arrays.npz")
    meshes, outs, info = {}, {}, {}
    for case in spec["cases"]:
        key = tuple(case["mesh"])
        if key not in meshes:
            meshes[key] = _mesh_of(case["mesh"], spec["device"])
        try:
            outs[case["id"]], info[case["id"]] = _run_case(
                case, meshes[key], arrays)
        except ValueError as e:     # a refusal, the same on every rank
            info[case["id"]] = {"error": str(e)}
    rank = dist.get_rank()
    np.savez(wd / f"out_{rank}.npz", **outs)
    (wd / f"out_{rank}.json").write_text(json.dumps(info))
    return len(spec["cases"])


def run_group(workdir, world: int, cases: list, arrays: dict,
              device="cpu") -> tuple:
    """:func:`run_cases` on ``world`` spawned ranks: writes ``cases`` and
    ``arrays`` into ``workdir``, runs them, and returns each rank's outputs
    and reports, ``(outs, infos)``, lists in rank order."""
    wd = Path(workdir)
    np.savez(wd / "arrays.npz", **arrays)
    (wd / "cases.json").write_text(json.dumps({"device": str(device),
                                               "cases": cases}))
    counts = spawn(world, run_cases, str(wd), device=device)
    if counts != [len(cases)] * world:
        raise RuntimeError(f"the ranks ran {counts} of {len(cases)} cases")
    outs = [dict(np.load(wd / f"out_{r}.npz")) for r in range(world)]
    infos = [json.loads((wd / f"out_{r}.json").read_text())
             for r in range(world)]
    return outs, infos
