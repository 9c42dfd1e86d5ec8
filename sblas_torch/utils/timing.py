"""Timing on the card: the port of ``sblas/utils/timing.py``.

Every measurement is the **marginal** cost of one more iteration of a
carry-dependent step, ``(t(hi) - t(lo)) / (hi - lo)``, so fixed costs
(launch of the first kernel, the events themselves) cancel. The ``hi`` and
``lo`` runs are each captured once into a CUDA graph and replayed between
two ``torch.cuda.Event``s: that is the counterpart of the JAX package's
on-device ``fori_loop``, and it keeps the host's per-call Python cost out of
a number that stands for the device. A path that finds no card raises.

GB/s comes from the caller's bytes model, and bandwidth is also reported as
a share of a STREAM triad measured on the same card (the north-star
metric, BASELINE.md).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

# fp32 and fp64 FLOP/s of one H100 SXM outside the tensor cores (NVIDIA's
# data sheet, at the full 700 W power limit): the operations side of a
# bound, by the type the work is done in
FP32_FLOPS = 67e12
FP64_FLOPS = 34e12
# device-memory rate of the same card (data sheet, HBM3): the bytes side of
# a bound. The STREAM triad measured on it (about 3.08 TB/s) is what a
# kernel can reach, and is reported beside it, never in its place
HBM_BYTES_PER_S = 3.35e12


def peak_flops(dtype) -> float:
    """The card's data-sheet rate for work done in ``dtype``: ``FP64_FLOPS``
    for f64, ``FP32_FLOPS`` otherwise (f32, and bf16 values summed in
    f32)."""
    f64 = dtype == torch.float64 if isinstance(dtype, torch.dtype) \
        else np.dtype(dtype) == np.float64
    return FP64_FLOPS if f64 else FP32_FLOPS


@dataclasses.dataclass
class BenchRecord:
    name: str
    seconds_per_iter: float
    flops: float = 0.0
    bytes: float = 0.0
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def gflops(self) -> float:
        return self.flops / self.seconds_per_iter / 1e9

    @property
    def gbps(self) -> float:
        return self.bytes / self.seconds_per_iter / 1e9


def _graph_of(step: Callable, init: torch.Tensor, args, k: int):
    """A CUDA graph of ``k`` chained steps from ``init``."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        c = init
        for _ in range(k):
            c = step(c, *args)
    return g, c


def measure_seconds_per_iter(step: Callable, init: torch.Tensor, *args,
                             iters_lo: int = 5, iters_hi: int = 25,
                             repeats: int = 3) -> float:
    """Marginal seconds per iteration of ``step(carry, *args) -> carry``.

    ``step`` must return a tensor like its carry, so that each iteration
    depends on the one before. The best of ``repeats`` marginal samples is
    returned.
    """
    if not (isinstance(init, torch.Tensor) and init.is_cuda):
        raise RuntimeError("measure_seconds_per_iter times on a CUDA device; "
                           f"got a carry on {getattr(init, 'device', None)}")
    if iters_hi <= iters_lo:
        raise ValueError("iters_hi must exceed iters_lo")
    with torch.cuda.device(init.device):
        # warm on a side stream, as graph capture requires: first launches
        # load modules and fill the caching allocator
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            c = init
            for _ in range(3):
                c = step(c, *args)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graphs = {k: _graph_of(step, init, args, k)
                  for k in (iters_lo, iters_hi)}

        def timed(k):
            g = graphs[k][0]
            g.replay()                      # warm the replay path
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            g.replay()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) * 1e-3

        samples = []
        for _ in range(repeats):
            lo, hi = timed(iters_lo), timed(iters_hi)
            samples.append((hi - lo) / (iters_hi - iters_lo))
    best = min(samples)
    if best <= 0:
        raise RuntimeError(f"iteration time did not scale: {samples}")
    return best


def measure_eager_seconds(fn: Callable, *, reps: int = 3) -> float:
    """Seconds per call of ``fn()`` run eagerly, between two CUDA events
    around ``reps`` calls after one warm-up call: for a library call that a
    CUDA graph may not capture. Host time between the calls is included."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure_eager_seconds times on a CUDA device; "
                           "none here")
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3 / reps


# 256 MiB per array: three of them are over 15x the H100's 50 MB L2
STREAM_BYTES = 256 * (1 << 20)
_STREAM_CACHE: dict = {}


def stream_bandwidth(device=None, *, fresh: bool = False) -> float:
    """Measured STREAM-triad bandwidth (GB/s) of a CUDA device:
    ``x <- x + 2 b`` over f32 arrays of ``STREAM_BYTES``, counted as three
    arrays moved per iteration. ``fresh=True`` measures anew (the ratio
    protocol pairs each kernel sample with its own triad)."""
    device = torch.device(device if device is not None else "cuda")
    key = str(device)
    if not fresh and key in _STREAM_CACHE:
        return _STREAM_CACHE[key]
    n = STREAM_BYTES // 4
    b = torch.ones(n, dtype=torch.float32, device=device)
    x = torch.zeros(n, dtype=torch.float32, device=device)
    per = measure_seconds_per_iter(lambda c, b: torch.add(c, b, alpha=2.0),
                                   x, b, iters_lo=4, iters_hi=16, repeats=2)
    bw = 3 * n * 4 / per / 1e9
    _STREAM_CACHE[key] = bw
    return bw
