"""Generated matrices, kept on disk between runs: the port of
``sblas/plan_cache.py:cached_matrix``. The layout bundles of that module
are not ported: the port's plans pack no TPU layout, and built cold they
take about a second at 1M rows (``SptrsvPlan`` on a 50.2M-nonzero
Cholesky factor 0.64-0.86 s, ``solvers.ichol`` on ``poisson2d(1000)``
with its two solve plans 1.01-1.20 s, on the host of an H100 machine;
PERF.md §6, ``chip_smoke.py`` phase ``host``), where generating the
matrix takes tens of seconds.

    a = cached_matrix("suite-large-fem-band-1M-112M", generate)

The first call runs ``generate()`` and saves the CSR's arrays under
``build/sblas_torch/matrices/<key>/`` (``build/`` is ignored by git); every
later call, in this process or another, loads them memory-mapped
(``np.load(..., mmap_mode="r")``). The arrays are written into a temporary
directory beside the entry and published with one ``os.replace``, so a
reader sees a whole entry or none: two processes that generate the same key
at once both publish (the first wins, the second drops its copy) and both
load the same arrays.
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile
from pathlib import Path
from typing import Callable

import numpy as np

from .formats import CSR
from .native import BUILD_DIR

MATRIX_DIR = BUILD_DIR / "matrices"
_FIELDS = ("indptr", "indices", "data")


def entry_dir(key: str, root: Path | None = None) -> Path:
    """Where the matrix of ``key`` lives (letters, digits, ``.``, ``_``,
    ``@`` and ``-`` only: a key is a directory name)."""
    if not re.fullmatch(r"[\w.@-]+", key):
        raise ValueError(f"bad matrix cache key {key!r}")
    return Path(root if root is not None else MATRIX_DIR) / key


def _load(path: Path) -> CSR:
    shape = tuple(int(v) for v in np.load(path / "shape.npy"))
    arrs = {f: np.load(path / f"{f}.npy", mmap_mode="r") for f in _FIELDS}
    return CSR(shape, arrs["indptr"], arrs["indices"], arrs["data"])


def cached_matrix(key: str, generate: Callable[[], CSR],
                  root: Path | None = None) -> CSR:
    """The CSR ``generate()`` returns, from disk where an earlier call saved
    it (memory-mapped, read-only), else generated, saved and loaded back."""
    path = entry_dir(key, root)
    if (path / "shape.npy").exists():
        return _load(path)
    a = generate()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=f".{key}.", dir=path.parent))
    try:
        for f in _FIELDS:
            np.save(tmp / f"{f}.npy", np.ascontiguousarray(getattr(a, f)))
        # written last: its presence marks a whole entry
        np.save(tmp / "shape.npy", np.asarray(a.shape, dtype=np.int64))
        try:
            os.replace(tmp, path)
        except OSError:
            # another process published the key first: keep its entry
            if not (path / "shape.npy").exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return _load(path)
