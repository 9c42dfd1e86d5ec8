"""The kernel build: nvcc's route, keyed on the sources, never a fallback."""

import os
import shutil
import stat
from pathlib import Path

import pytest

from sblas_torch.ops.kernels import _build


def _no_nvcc(monkeypatch, tmp_path):
    empty = tmp_path / "empty_bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))


def _fake_nvcc(monkeypatch, tmp_path, body: str):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(bindir))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    _no_nvcc(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(out_dir=tmp_path / "out")
    assert not list((tmp_path).glob("out/*.so"))


def test_failed_build_carries_stderr(monkeypatch, tmp_path):
    _fake_nvcc(monkeypatch, tmp_path, 'echo "fatal: boom in spmv_csr.cu" >&2\nexit 2\n')
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="boom in spmv_csr.cu"):
        _build.build(out_dir=out)
    assert not list(out.iterdir())   # no half-written library is left


def test_build_passes_sm90a_and_every_source(monkeypatch, tmp_path):
    # a stand-in nvcc that logs each call and writes its own arguments to
    # the -o file
    calls = tmp_path / "calls.log"
    _fake_nvcc(monkeypatch, tmp_path, f"""
echo "$*" >> "{calls}"
while [ "$1" != "-o" ]; do set -- "$@" "$1"; shift; done
out="$2"; shift 2
echo "$@" > "$out"
echo "ptxas info : Used 30 registers" >&2
""")
    lib = _build.build(out_dir=tmp_path / "out")
    *compiles, link = [c.split() for c in calls.read_text().splitlines()]
    # one compile per source, each for sm_90a at -O3, then one link
    assert "spmv_csr.cu" in {p.name for p in _build.sources()}
    assert sorted(Path(a).name for c in compiles for a in c
                  if a.endswith(".cu")) == \
        sorted(p.name for p in _build.sources())
    for c in compiles:
        assert "arch=compute_90a,code=sm_90a" in c
        assert "-O3" in c and "-c" in c and "-shared" not in c
    assert "arch=compute_90a,code=sm_90a" in link and "-shared" in link
    assert sorted(Path(a).name for a in lib.read_text().split()
                  if a.endswith(".o")) == \
        sorted(f"{p.stem}.o" for p in _build.sources())
    log = lib.with_suffix(".log").read_text()
    assert "registers" in log and "== spmm_bsr.cu" in log


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    out = tmp_path / "out"
    first = _build.library_path(src, out)
    assert first == _build.library_path(src, out)
    assert first.parent == out and first.name.endswith(".so")
    cu = src / "spmv_csr.cu"
    cu.write_text(cu.read_text() + "\n// edited\n")
    assert _build.library_path(src, out) != first
    # a library that exists for exactly these sources is reused, with no
    # compiler at all
    _no_nvcc(monkeypatch, tmp_path)
    lib = _build.library_path(src, out)
    out.mkdir()
    lib.write_bytes(b"")
    assert _build.build(src, out) == lib


def test_build_dir_is_git_ignored():
    root = Path(__file__).resolve().parents[1]
    assert _build.BUILD_DIR == root / "build" / "sblas_torch"
    ignored = (root / ".gitignore").read_text().split()
    assert "build/" in ignored
    assert os.path.isdir(_build.CSRC)
