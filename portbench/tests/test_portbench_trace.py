"""Reading the profiler's events: device time by the range that launched
it, busy and idle time, the idle stretches named by what the host did."""

from __future__ import annotations

import pytest
from torch.autograd import DeviceType

from portbench import trace


class Ev:
    def __init__(self, name, start, end, dev=False, corr=0, linked=0):
        self._n, self._s, self._e = name, start, end
        self._d = DeviceType.CUDA if dev else DeviceType.CPU
        self._c, self._l = corr, linked

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l

    def start_thread_id(self):
        return 1


def events():
    """A solve range holding an SpMV range, a dot product and a triangular
    solve range; each event's kind in the first argument."""
    def e(kind, *a, **k):
        return Ev(*a, **k)

    return [
        e("user_annotation", "solve", 0, 100, corr=1),
        e("user_annotation", "spmv", 10, 30, corr=2),
        e("cuda_runtime", "cudaLaunchKernel", 12, 14, corr=501),
        e("cpu_op", "aten::dot", 40, 50, corr=3),
        e("cuda_runtime", "cudaLaunchKernel", 42, 44, corr=502),
        e("user_annotation", "sptrsv", 60, 70, corr=4),
        e("kernel", "spmv_kernel", 20, 45, dev=True, corr=501),
        e("kernel", "dot_kernel", 50, 55, dev=True, corr=502),
        # launched inside the sptrsv range, no runtime event: by its link
        e("kernel", "sptrsv_kernel", 75, 95, dev=True, corr=999, linked=4),
        e("gpu_user_annotation", "spmv", 20, 45, dev=True),
    ]


def test_summary():
    s = trace.summarize(events(), ("spmv", "sptrsv", "precond"))
    assert s["window_s"] == pytest.approx(100e-9)
    assert s["busy_s"] == pytest.approx(50e-9)
    assert s["device_s"]["spmv"] == pytest.approx(25e-9)
    assert s["device_s"]["solve"] == pytest.approx(5e-9)
    assert s["device_s"]["sptrsv"] == pytest.approx(20e-9)
    assert s["host_s"] == {"spmv": [pytest.approx(20e-9)],
                           "sptrsv": [pytest.approx(10e-9)]}
    assert s["device_ops"][0] == ["spmv_kernel", pytest.approx(25e-9)]
    gaps = dict((k, v) for k, v in s["idle_gaps"])
    # idle 0-20 (solve), 55-75 (solve, then sptrsv from 60), 95-100
    assert sum(gaps.values()) == pytest.approx(50e-9)
    assert gaps["solve"] == pytest.approx(45e-9)
    assert s["launch_links"] == 2


def test_a_collectives_range_is_no_device_operation():
    """On several cards the device timeline also holds the range that
    ``torch.distributed`` records around an NCCL kernel: a copy of a host
    range, not a second operation."""
    evs = events() + [
        Ev("nccl:_all_gather_base", 20, 45, dev=True),
        Ev("ncclDevKernel_AllGather_RING_LL", 20, 45, dev=True, corr=503)]
    s = trace.summarize(evs, ("spmv", "sptrsv", "precond"))
    ops = dict((k, v) for k, v in s["device_ops"])
    assert "nccl:_all_gather_base" not in ops
    assert ops["ncclDevKernel_AllGather_RING_LL"] == pytest.approx(25e-9)
    assert s["busy_s"] == pytest.approx(50e-9)
    assert s["device_events"] == 4


def test_no_solve_no_summary():
    assert trace.summarize([], ("spmv",)) is None


def test_a_new_range_is_read_without_an_edit():
    """A range that a solve loop wraps under a new name reaches the trace's
    summary: the harness passes on whatever names ``Spans`` wrapped."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench.spans import Spans

    spans = Spans(True)
    halo = spans.wrap("halo", lambda x: x + 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spans.active = True
        with record_function(trace.SOLVE):
            halo(torch.ones(4))
    s = trace.summarize(prof.profiler.kineto_results.events(),
                        tuple(sorted(spans.names)))
    assert spans.names == {"halo"} and spans.calls["halo"] == 1
    assert len(s["host_s"]["halo"]) == 1
