"""The builds: nvcc's route for the kernels and g++'s for the host
library (factorizations, levels, .mtx parse), each keyed on its sources,
never a fallback."""

import os
import shutil
import stat
from pathlib import Path

import pytest

from sblas_torch import native
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


def test_ptxas_report_names_each_kernel():
    log = """== sptrsv_csr.cu
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115sptrsv_syncfreeIdLi16EEEviiiPKiS2_PKT_S5_S5_PS3_Pi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115sptrsv_syncfreeIdLi16EEEviiiPKiS2_PKT_S5_S5_PS3_Pi
    16 bytes stack frame, 12 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers, 16 bytes cumulative stack size, 4 bytes smem
ptxas info    : Function properties for _ZN44_GLOBAL__N__c6cfbb49_11_spmv_csr_cu_ef5c265c15spmv_csr_vectorIffLi8EEEviPKiS2_PKT_S5_S5_S3_S3_PS3_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
"""
    assert _build.ptxas_report(log) == [
        {"kernel": "15sptrsv_syncfreeIdLi16E", "registers": 48,
         "spill_stores": 12, "spill_loads": 24},
        {"kernel": "15spmv_csr_vectorIffLi8E", "registers": 32,
         "spill_stores": 0, "spill_loads": 0}]
    assert _build.ptxas_report("") == []


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


def test_host_library_builds_into_build_keyed_on_its_source(tmp_path):
    root = Path(__file__).resolve().parents[1]
    assert native.BUILD_DIR == root / "build" / "sblas_torch"
    assert native.HOSTSRC.name == "hostsrc"          # not globbed by nvcc
    srcs = native.sources()
    assert {s.name for s in srcs} >= {"factor.cpp", "levels.cpp", "mtx.cpp"}
    assert not set(srcs) & set(_build.sources())
    copies = [tmp_path / s.name for s in srcs]
    for s, c in zip(srcs, copies):
        shutil.copy(s, c)
    out = tmp_path / "out"
    lib = native.build(copies, out)
    assert lib == native.library_path(copies, out) and lib.exists()
    assert lib.parent == out and lib.name.startswith("libsblas_torch_host_")
    assert native.build(copies, out) == lib          # reused, not rebuilt
    # every source is in the key: editing any one of them moves it
    for c in copies:
        text = c.read_text()
        c.write_text(text + "\n// edited\n")
        assert native.library_path(copies, out) != lib, c.name
        c.write_text(text)
    assert native.library_path(copies, out) == lib
    # the library the package loads is the repository's own, built from
    # every hostsrc/*.cpp
    assert native.library_path() == native.BUILD_DIR / native.library_path(
        srcs, native.BUILD_DIR).name


def test_broken_host_source_raises_with_the_compilers_output(tmp_path):
    src = tmp_path / "factor.cpp"
    src.write_text((native.HOSTSRC / "factor.cpp").read_text().replace(
        "return 0;\n}", "return 0 undeclared_name_in_factor;\n}", 1))
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.build([src, *(s for s in native.sources()
                             if s.name != src.name)], out)
    assert "undeclared_name_in_factor" in str(err.value)
    assert not list(out.glob("*.so"))


def test_host_build_without_gxx_raises(monkeypatch, tmp_path):
    _no_nvcc(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.build(native.sources(), tmp_path / "out")


def test_every_compiled_source_is_package_data():
    # an installed sblas_torch builds its kernels (csrc/*.cu, *.cuh) and
    # its host factorizations (hostsrc/*.cpp) at first use: each file the
    # two builders compile must match a package-data glob
    import tomllib

    root = Path(__file__).resolve().parents[1]
    conf = tomllib.loads((root / "pyproject.toml").read_text())
    globs = conf["tool"]["setuptools"]["package-data"]["sblas_torch"]
    pkg = native.HOSTSRC.parent
    compiled = [*_build.sources(), *_build.CSRC.glob("*.cuh"),
                *native.sources(), *native.HOSTSRC.glob("*.cpp")]
    assert len(native.sources()) >= 3 and _build.sources()
    for src in compiled:
        rel = src.relative_to(pkg)
        assert any(rel.match(g) for g in globs), f"{rel} is not packaged"
