"""A cell on N > 1 cards: one rank process a card, started and watched
here, and one result line that speaks for all of them.

    result, lines, forbidden = run_ranks(cell, seed, seconds, trace,
                                         world=4, started=started)

:func:`run_ranks` builds the port's host library and CUDA kernels once,
in this process (neither build takes a lock, so the ranks must not race
into ``build/``), then starts ``world`` processes (``python -m
portbench.rank``), rank ``r`` on ``cuda:r``, or on the CPU for the tests,
each with the environment ``torchrun`` gives its ranks. Each rank starts
the default process group (NCCL on its card, gloo on the CPU) and runs
:func:`portbench.harness.run` with its ``rank`` and ``world``: the ranks
build and warm up, meet at a barrier, and after each solve rank 0 alone
decides whether the window, or its traced part, is over
(:class:`Lockstep`). Rank 0 merges every rank's record (:func:`merge`)
and hands back the line. A rank that raises, ends without its result, or
gives none within ``deadline_s`` of the ranks' start ends the run: the
others are stopped, and :class:`~portbench.harness.RankFailure`
carries the end of the failing rank's traceback. The benchmark starts its
ranks itself, never through the port's launcher, so that a change to the
port cannot change how the benchmark runs.
"""

from __future__ import annotations

import json
import math
import os
import socket
import subprocess
import sys
import threading
import time
from datetime import timedelta

from . import harness

# the driver ends a run at 360 s: a run that hangs ends here first, with
# the failing rank named; a sound four-card run needs well under half
DEADLINE_S = 300.0
# how long a collective, and the group's start, wait for a slow rank
GROUP_TIMEOUT = timedelta(seconds=180)
# after a first failure, how long the other ranks get to report theirs,
# so that the first to fail, and not a rank it left waiting, is named
GRACE_S = 2.0


def free_port() -> int:
    """A TCP port of ``localhost`` that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def boot_clock() -> float:
    """A clock that every process of the machine reads alike."""
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def build_port(device: str) -> None:
    """The port's host library, and on a card its CUDA kernels, built in
    this process before any rank starts."""
    from sblas_torch import native

    native.build()
    if device.startswith("cuda"):
        from sblas_torch.ops.kernels import _build

        _build.build()


class _Rank:
    """One rank's process, its standard output read to the end on a
    thread (a full pipe would block the rank), and its report: the JSON
    object on its last line."""

    def __init__(self, rank: int, world: int, port: int, job: dict,
                 root):
        env = {**os.environ, "MASTER_ADDR": "localhost",
               "MASTER_PORT": str(port), "RANK": str(rank),
               "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
               "LOCAL_WORLD_SIZE": str(world)}
        self.rank = rank
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "portbench.rank"], cwd=root, env=env,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        self.proc.stdin.write(json.dumps({**job, "rank": rank}).encode())
        self.proc.stdin.close()
        self.out = b""
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        self.seen_ended: float | None = None

    def _read(self) -> None:
        self.out = self.proc.stdout.read()

    def ended(self) -> bool:
        if self.proc.poll() is None:
            return False
        if self.seen_ended is None:
            self.seen_ended = boot_clock()
        return True

    def report(self) -> dict | None:
        """The rank's report once it has ended, or None where its last
        line is none."""
        self.reader.join(timeout=10)
        lines = self.out.decode(errors="replace").strip().splitlines()
        try:
            rep = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            return None
        return rep if isinstance(rep, dict) else None

    def failure(self) -> tuple[float, str] | None:
        """``(when, what)`` of an ended rank that failed, else None."""
        rep, code = self.report(), self.proc.returncode
        if rep is not None and code == 0 and "error" not in rep:
            return None
        if rep is not None and "error" in rep:
            return rep["failed_at"], (f"rank {self.rank} raised (exit "
                                      f"{code}):\n{rep['error'][-6000:]}")
        return self.seen_ended, (f"rank {self.rank} ended with exit {code}"
                                 + (" and gave no result" if rep is None
                                    else ""))

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.reader.join(timeout=10)
        self.proc.stdout.close()


def _watch(ranks: list, deadline_s: float) -> list:
    """Every rank's report, in rank order, once all have ended; raises
    :class:`~portbench.harness.RankFailure` at the first failure or at
    the deadline."""
    deadline = time.monotonic() + deadline_s
    while True:
        ended = [r for r in ranks if r.ended()]
        failed = [f for f in (r.failure() for r in ended) if f]
        if failed:
            time.sleep(GRACE_S)
            failed = [f for f in (r.failure() for r in ranks if r.ended())
                      if f]
            raise harness.RankFailure(min(failed)[1])
        if len(ended) == len(ranks):
            return [r.report() for r in ranks]
        if time.monotonic() > deadline:
            late = [r.rank for r in ranks if not r.ended()]
            raise harness.RankFailure(
                f"ranks {late} gave no result within {deadline_s:g} s of "
                "the ranks' start; every rank stopped")
        time.sleep(0.1)


def run_ranks(cell: str, seed: int, seconds: float, trace: bool, *,
              world: int, device: str = "cuda", started: float | None = None,
              bench: dict | None = None, config: dict | None = None,
              traffic: dict | None = None, control: bool = False,
              deadline_s: float = DEADLINE_S) -> tuple[dict, list, list]:
    """``(result, lines, forbidden)``: rank 0's merged result line and
    lines for standard error, and the forbidden modules that any rank or
    this process loaded. ``started``: the ``time.perf_counter()`` reading
    that ``setup_s`` counts from (default: now); ``device``: ``"cuda"``
    (rank ``r`` on ``cuda:r``) or ``"cpu"``; ``bench``, ``config``,
    ``traffic`` and ``control`` as :func:`portbench.harness.run` takes
    them."""
    age = 0.0 if started is None else time.perf_counter() - started
    born = boot_clock() - age
    build_port(device)
    job = {"cell": cell, "seed": seed, "seconds": seconds,
           "trace": bool(trace), "device": device, "born": born,
           "bench": bench or harness.load_benchmark(), "config": config,
           "traffic": traffic, "control": bool(control), "world": world,
           "parent": os.getpid()}
    port = free_port()
    ranks = []
    try:
        for r in range(world):
            ranks.append(_Rank(r, world, port, job, harness.ROOT))
        reports = _watch(ranks, deadline_s)
    finally:
        for r in ranks:
            r.stop()
    forbidden = set(harness.forbidden_modules())
    for rep in reports:
        forbidden.update(rep["forbidden"])
    return reports[0]["result"], reports[0]["lines"], sorted(forbidden)


def init_group(device: str, rank: int, world: int):
    """Start this rank's default process group from the ``torchrun``
    environment: NCCL on ``cuda:<rank>``, gloo on the CPU. Returns the
    rank's device."""
    import torch
    import torch.distributed as dist

    if device.startswith("cuda"):
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world, timeout=GROUP_TIMEOUT)
    return dev


class Lockstep:
    """What holds one cell's ranks together, over a gloo group on the CPU
    that every rank makes here: the barrier before the window, rank 0's
    word after each solve (is the traced part over, is the window over),
    and each rank's part of the record gathered to rank 0."""

    def __init__(self, rank: int, world: int):
        import torch
        import torch.distributed as dist

        self.dist, self.rank, self.world = dist, rank, world
        self.group = dist.new_group(backend="gloo", timeout=GROUP_TIMEOUT)
        self.word = torch.zeros(2, dtype=torch.uint8)

    def barrier(self) -> None:
        self.dist.barrier(group=self.group)

    def decide(self, stop_trace: bool, over: bool) -> tuple[bool, bool]:
        """Rank 0's ``(stop_trace, over)``, on every rank."""
        if self.rank == 0:
            self.word[0], self.word[1] = stop_trace, over
        self.dist.broadcast(self.word, src=0, group=self.group)
        return bool(self.word[0]), bool(self.word[1])

    def gather(self, part: dict) -> list | None:
        """Every rank's ``part`` in rank order on rank 0; None elsewhere."""
        out = [None] * self.world if self.rank == 0 else None
        self.dist.gather_object(part, out, dst=0, group=self.group)
        return out


def _worst(values: list) -> float:
    """The largest value, a NaN above every number."""
    return max(values, key=lambda v: (math.isnan(v), v))


def merge(parts: list) -> dict:
    """One run's numbers from every rank's part (``rec``, ``correct``,
    ``over``, ``compared``, ``peak``), in rank order: rank 0's record with
    the slowest rank's ``plan_s`` and every record under ``ranks``;
    correct where every rank is and all ran the same solves; the answers
    over their limits summed; each compared number the worst rank's; the
    fullest card's peak."""
    rec = {**parts[0]["rec"],
           "plan_s": max(p["rec"]["plan_s"] for p in parts),
           "ranks": [p["rec"] for p in parts]}
    compared = {}
    for p in parts:
        for name, (value, limit) in p["compared"].items():
            had = compared.get(name, (value, limit))[0]
            compared[name] = (_worst([had, value]), limit)
    solves = {len(p["rec"]["times"]) for p in parts}
    return {"rec": rec,
            "correct": all(p["correct"] for p in parts) and len(solves) == 1,
            "over": sum(p["over"] for p in parts), "compared": compared,
            "peak": max(p["peak"] for p in parts)}
