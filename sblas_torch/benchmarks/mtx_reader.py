"""Reads a ``.mtx`` file in a process of its own, for its seconds and the
peak RSS of the read alone (``chip_smoke.py`` phase ``host``).

    with MtxReader() as reader:
        rec = reader.read("pwtk.mtx", "host")     # or "plain": numpy parse
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# one read: argv = path, "host" (io.read_mtx as it is) or "plain" (the
# numpy parse), the root to import sblas_torch from. Peak RSS (MB) from
# ru_maxrss, read after each step of the set-up: ``floor`` is what the
# process inherited, then numpy, torch, sblas_torch and the host library
# imported and loaded (``rss_mb``); the read's own is ``peak_rss_mb`` less
# ``base_rss_mb``, where the peak rose above the last of those
READ_MTX = """
import hashlib, json, resource, sys, time


def maxrss_mb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


rss = {"floor": maxrss_mb()}
sys.path.insert(0, sys.argv[3])
import numpy as np
rss["numpy"] = maxrss_mb()
import torch
rss["torch"] = maxrss_mb()
from sblas_torch import io, native
rss["sblas_torch"] = maxrss_mb()
native.load()
rss["native.load"] = maxrss_mb()
if sys.argv[2] == "plain":
    io.parse_coordinate = io.parse_coordinate_plain
t0 = time.perf_counter()
a = io.read_mtx(sys.argv[1], dtype=np.float32)
seconds = time.perf_counter() - t0
peak = maxrss_mb()
h = hashlib.sha256()
for arr in (a.indptr, a.indices, a.data):
    h.update(arr.tobytes())
print(json.dumps({"seconds": seconds, "rss_mb": rss,
                  "base_rss_mb": rss["native.load"], "peak_rss_mb": peak,
                  "peak_observed": peak > rss["native.load"],
                  "cuda_initialized": torch.cuda.is_initialized(),
                  "nnz": int(a.nnz), "sha256": h.hexdigest()[:16]}))
"""

# runs each request line (a JSON list of ``python -c`` arguments) in a new
# process and answers with one JSON line [returncode, stdout, stderr]
_LAUNCHER = """
import json, subprocess, sys
for line in sys.stdin:
    out = subprocess.run([sys.executable, "-c", *json.loads(line)],
                         capture_output=True, text=True)
    print(json.dumps([out.returncode, out.stdout, out.stderr[-4000:]]),
          flush=True)
"""


class MtxReader:
    """Reads ``.mtx`` files with :data:`READ_MTX`, each in a new process
    started by a small launcher process. A process spawned straight from
    a large one records that one's peak RSS as its own when it execs (it
    shares its memory until then, as ``subprocess`` spawns it); spawned
    from the launcher, it records only the launcher's. The launcher ends
    with :meth:`close` or when its parent does (end of its input)."""

    def __init__(self):
        self._proc = subprocess.Popen([sys.executable, "-c", _LAUNCHER],
                                      stdin=subprocess.PIPE,
                                      stdout=subprocess.PIPE, text=True)

    def read(self, path, parse: str = "host") -> dict:
        """:data:`READ_MTX`'s record of ``path``."""
        self._proc.stdin.write(json.dumps(
            [READ_MTX, str(path), parse, str(ROOT)]) + "\n")
        self._proc.stdin.flush()
        rc, out, err = json.loads(self._proc.stdout.readline())
        if rc != 0:
            raise RuntimeError(f"the {parse} read of {path} failed:\n{err}")
        return json.loads(out.strip().splitlines()[-1])

    def close(self) -> None:
        self._proc.stdin.close()
        self._proc.wait(timeout=60)
        self._proc.stdout.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
