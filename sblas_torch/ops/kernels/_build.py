"""Build and load the port's CUDA kernels.

All ``sblas_torch/csrc/*.cu`` files compile in one ``nvcc`` call into one
shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/sblas_torch/libsblas_torch_kernels_<h>.so
         sblas_torch/csrc/*.cu

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
import subprocess
import tempfile
from pathlib import Path

from ...utils.backend import find_nvcc

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "sblas_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB: ctypes.CDLL | None = None


def sources(src_dir: Path = CSRC) -> list[Path]:
    return sorted(src_dir.glob("*.cu"))


def library_path(src_dir: Path = CSRC, out_dir: Path = BUILD_DIR) -> Path:
    """Where the library built from ``src_dir`` lives: keyed on a hash of
    every ``.cu``/``.cuh`` there and of the nvcc flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
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
    # build under a temporary name, then rename: a concurrent loader never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, srcs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}) building "
                f"{[p.name for p in srcs]}:\n{proc.stderr}{proc.stdout}")
        lib.with_suffix(".log").write_text(proc.stderr + proc.stdout)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first call and then kept."""
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(str(build()))
    return _LIB
