"""One rank of a cell that runs on several cards, started by
:func:`portbench.launch.run_ranks`:

    python -m portbench.rank < job.json

The job (a JSON object on standard input) names the cell, the seed, the
window, the device, this rank and the world; the ``torchrun`` variables
are in the environment. The rank starts its default process group, runs
:func:`portbench.harness.run` with its rank and world, and prints one JSON
object as the last line of its standard output: rank 0's merged
``result`` and ``lines``, the forbidden modules this process loaded once
its window had closed, and, where it raised, the traceback and when.
"""

from __future__ import annotations

import ctypes
import json
import os
import signal
import sys
import time
import traceback


def _die_with(parent: int) -> None:
    """Have the kernel end this process when the launcher ends, so that no
    rank outlives the run (Linux; elsewhere nothing)."""
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, signal.SIGKILL)           # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        return
    if os.getppid() != parent:
        os._exit(1)


def main() -> int:
    job = json.loads(sys.stdin.read())
    _die_with(int(job["parent"]))
    rank, world = int(job["rank"]), int(job["world"])
    report = {"rank": rank}
    try:
        import torch
        import torch.distributed as dist

        from . import harness, launch

        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        device = launch.init_group(job["device"], rank, world)
        started = time.perf_counter() - (launch.boot_clock()
                                         - float(job["born"]))
        result, lines = harness.run(
            job["cell"], int(job["seed"]), float(job["seconds"]),
            bool(job["trace"]), device=device, started=started,
            bench=job["bench"], config=job["config"],
            traffic=job["traffic"], control=bool(job["control"]),
            rank=rank, world=world)
        dist.destroy_process_group()
        report.update(result=result, lines=lines,
                      forbidden=harness.forbidden_modules())
    except Exception:       # reported to the launcher, which ends the run
        report.update(error=traceback.format_exc(),
                      failed_at=time.clock_gettime(time.CLOCK_BOOTTIME))
    sys.stdout.flush()
    print(json.dumps(report), flush=True)
    return 1 if "error" in report else 0


if __name__ == "__main__":
    raise SystemExit(main())
