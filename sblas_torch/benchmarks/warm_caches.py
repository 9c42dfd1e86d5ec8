"""Generate the suite's large cases into the matrix cache ahead of a run:
the port of ``benchmarks/warm_caches.py``.

    python -m sblas_torch.benchmarks.warm_caches            # every case
    python -m sblas_torch.benchmarks.warm_caches powerlaw   # names holding it

It runs only the host generators of ``run_suite``'s large cases
(:func:`~sblas_torch.benchmarks.run_suite.large_cases` with the web graph,
``uk-2002-full``), numpy and disk, no card, and saves each into
:mod:`sblas_torch.matrix_cache` under the key ``run_suite --large [--web]``
reads (:func:`~sblas_torch.benchmarks.run_suite.large_key`), so that the
suite's run loads them memory-mapped. Run it beside other work (``nice``)
before ``run_suite --large``; a case already in the cache is only loaded.
It prints a line a case: its nonzeros and seconds.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

from ..matrix_cache import cached_matrix
from .run_suite import large_cases, large_key

# the reference's order: the power-law graph first, the web graph second
ORDER = ("powerlaw-1M-102M", "uk-2002-full", "fem-band-1M-112M",
         "fem-cluster-1M-109M")


def warm(cases: dict, only: str | None = None,
         root: Path | None = None) -> list:
    """Each case of ``cases`` (``{name: generator}``) whose name holds
    ``only`` (every case where it is None) generated into the matrix cache
    under :func:`large_key`, or loaded where it is there. Returns ``(name,
    nnz, seconds)`` a case."""
    done = []
    for name, gen in cases.items():
        if only and only not in name:
            continue
        t0 = time.perf_counter()
        a = cached_matrix(large_key(name), gen, root)
        done.append((name, a.nnz, time.perf_counter() - t0))
        print(f"warm {name}: nnz={a.nnz} in {done[-1][2]:.1f}s", flush=True)
        del a
    return done


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    cases = large_cases(web=True)
    warm({name: cases[name] for name in ORDER},
         argv[0] if argv else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
