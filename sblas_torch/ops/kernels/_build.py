"""Build and load the port's CUDA kernels.

Each ``sblas_torch/csrc/*.cu`` file compiles in its own ``nvcc``
process, all started together, and one more call links the objects into
one shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <tmp>/<name>.o sblas_torch/csrc/<name>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o build/sblas_torch/libsblas_torch_kernels_<h>.so <tmp>/*.o

``<h>`` hashes the sources and the flags, so a library built from other
sources is never loaded. The build happens at first use, from the sources
in the checkout only; ``build/`` is git-ignored. A missing ``nvcc`` or a
failed build raises ``RuntimeError`` with nvcc's output: there is no
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import tempfile
from pathlib import Path

from ...utils.backend import find_nvcc

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "sblas_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")

_LIB: ctypes.CDLL | None = None
_ENTRIES: dict = {}


def sources(src_dir: Path = CSRC) -> list[Path]:
    return sorted(src_dir.glob("*.cu"))


def library_path(src_dir: Path = CSRC, out_dir: Path = BUILD_DIR) -> Path:
    """Where the library built from ``src_dir`` lives: keyed on a hash of
    every ``.cu``/``.cuh`` there and of the nvcc flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in sorted([*src_dir.glob("*.cu"), *src_dir.glob("*.cuh")]):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return out_dir / f"libsblas_torch_kernels_{h.hexdigest()[:16]}.so"


def build(src_dir: Path = CSRC, out_dir: Path = BUILD_DIR) -> Path:
    """Compile the kernels unless the library for these sources exists.

    The compiler's report (``-Xptxas -v``: registers, spills) is kept
    beside the library as ``<name>.log``.
    """
    lib = library_path(src_dir, out_dir)
    if lib.exists():
        return lib
    srcs = sources(src_dir)
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {src_dir}")
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked on PATH and under $CUDA_HOME/bin): the "
            "CUDA kernels of sblas_torch cannot be built")
    out_dir.mkdir(parents=True, exist_ok=True)
    # objects in a temporary directory, the library under a temporary name
    # and then renamed: a concurrent loader never sees a half-written one
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / f"{p.stem}.o" for p in srcs]
        outs = [Path(tmp) / f"{p.stem}.out" for p in srcs]
        procs = []
        for src, obj, out in zip(srcs, objs, outs):
            with open(out, "w") as f:
                procs.append(subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                    stdout=f, stderr=subprocess.STDOUT))
        for proc in procs:
            proc.wait()
        logs = [f"== {src.name}\n{out.read_text()}"
                for src, out in zip(srcs, outs)]
        failed = [(src, proc.returncode) for src, proc in zip(srcs, procs)
                  if proc.returncode != 0]
        if failed:
            raise RuntimeError(
                f"nvcc failed compiling {[(s.name, rc) for s, rc in failed]}:"
                "\n" + "".join(logs))
        so = Path(tmp) / lib.name
        proc = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(so),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}) "
                               f"linking {[p.name for p in srcs]}:\n"
                               f"{proc.stderr}{proc.stdout}")
        lib.with_suffix(".log").write_text("".join(logs))
        os.replace(so, lib)
    return lib


def ptxas_report(log: str) -> list[dict]:
    """Each kernel's registers and spills from the ``-Xptxas -v`` output
    that :func:`build` keeps: ``{"kernel", "registers", "spill_stores",
    "spill_loads"}`` (bytes), the kernel named by its mangled name less the
    anonymous namespace and the parameter list (``15sptrsv_syncfreeIdLi16E``
    is ``sptrsv_syncfree<double, 16>``)."""
    out, name, spill = [], None, (0, 0)
    for ln in log.splitlines():
        if m := re.search(r"Function properties for (\S+)", ln):
            name, spill = m.group(1), (0, 0)
            # _ZN<len><the anonymous namespace's name><the kernel's name>
            if ns := re.match(r"_ZN(\d+)_GLOBAL__N_", name):
                name = name[ns.end(1) + int(ns.group(1)):]
            name = name.split("EEv")[0]
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", ln):
            spill = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", ln)) and name:
            out.append({"kernel": name, "registers": int(m.group(1)),
                        "spill_stores": spill[0], "spill_loads": spill[1]})
            name = None
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first call and then kept."""
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(str(build()))
    return _LIB


def entry(symbol: str, argtypes: list) -> tuple:
    """``(fn, error_string)``: the library's C entry point ``symbol``,
    which returns a ``cudaError_t``, with its argument types set, and the
    library's ``sblas_cuda_error_string`` that names such an error."""
    if symbol not in _ENTRIES:
        lib = load()
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err = lib.sblas_cuda_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _ENTRIES[symbol] = (fn, err)
    return _ENTRIES[symbol]
