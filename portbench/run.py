"""Run one cell of ``BENCHMARK.json`` once and print its result line:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

It exits 2, printing no result, where the cell's chips are not there, and
3 where a forbidden module (``harness.FORBIDDEN``) was loaded. The last
lines on standard error are the numbers compared, each beside its limit;
the last line on standard output is the result. A cell of one chip runs in
this process; a cell of N > 1 chips as N rank processes, one a card
(:mod:`portbench.launch`), and it exits 1, printing no result, where a
rank fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_T0 = time.perf_counter()


def process_age() -> float:
    """Seconds since this process started (``/proc/self/stat``), or since
    this module was imported where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - started
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    started = time.perf_counter() - process_age()

    import torch

    from . import harness

    bench = harness.load_benchmark()
    cell = harness.cell_of(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); torch "
              f"sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    return run_and_print(args.workload, args.seed, args.seconds,
                         bool(args.trace), started=started, bench=bench)


def run_and_print(workload: str, seed: int, seconds: float, trace: bool,
                  *, started: float | None, bench: dict,
                  device: str = "cuda", **overrides) -> int:
    """Run the cell, print its lines and its result; the exit code.
    ``overrides`` (``config``, ``traffic``; ``deadline_s`` for several
    chips) are the tests' small sizes and short limits."""
    from . import harness

    try:
        result, lines, bad = harness.run_cell(
            workload, seed, seconds, trace, device=device, started=started,
            bench=bench, **overrides)
    except harness.RankFailure as e:
        print(f"{workload}: {e}", file=sys.stderr, flush=True)
        return 1
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
