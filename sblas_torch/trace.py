"""What the port records of its own work: spans around its set-up, the
kernels' launch counts, and the sync-free solve kernel's cycle sums.

**Spans.** ``span(name, phase)`` is a context manager, and a decorator,
around one step of building a plan or a preconditioner. Each span keeps
its name, phase, parent span and its start and end on ``time.time_ns()``'s
clock, the clock ``torch.profiler`` stamps its host events on; the store
keeps totals of duration and of self time (the duration less what its
child spans cover) by name and by phase, and the newest
``MAX_RECORDS`` spans. Every span is recorded: set-up spans are few and
last milliseconds to seconds. While a ``torch.profiler`` records, a span
also opens ``torch.profiler.record_function(name)``, so that the
profiler's trace (``cli.py --profile``) shows it on its own timeline.

Each span belongs to one of the ``PHASES``: ``factor`` (the numeric
IC(0)/ILU(0) factorization), ``levels`` (dependency levels and the solve
kernel's ticket order), ``convert`` (host format conversions and value
casts), ``upload`` (host-to-device copies) and ``build`` (the plan and
preconditioner constructors, the ``CSR`` constructor's checks and their
other work). A phase's time is the sum of its spans' self time, so the
phases add up to the top-level spans' total.

**Counters.** Each kernel wrapper counts its launches in module attributes
(``LAUNCHES``, ``LAUNCHES_F64``, ...), always on; :data:`COUNTERS` names
them. While a profiler records, every :data:`COUNT_EVERY`-th launch of
the sync-free solve (``ops/kernels/sptrsv_csr.py``) takes its counting
variant, which adds each row's cycles by step (:data:`SOLVE_STEPS`), its
rows and its polls into a buffer that stays on the device
(:func:`solve_counts_buffer`); :func:`counters` copies it to the host when
read. The other launches take the plain kernel: a counting launch is
7.9% slower (an H100, ``hpcg-256``'s IC(0) factors), one in
``COUNT_EVERY`` makes a traced window's solves 0.7-1.2% slower. No span or
counter has a switch of its own: with no profiler recording, a launch
costs one flag read.
"""

from __future__ import annotations

import collections
import functools
import importlib
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

PHASES = ("factor", "levels", "convert", "upload", "build")
# newest spans kept in full; the totals count every span
MAX_RECORDS = 4096

# each kernel build's launch count: (wrapper module under
# sblas_torch.ops.kernels, counter). A wrapper adds one where it launches
# its kernel on the card, and nowhere else
COUNTERS = {"spmv_csr": ("spmv_csr", "LAUNCHES"),
            "spmv_csr_f64": ("spmv_csr", "LAUNCHES_F64"),
            "spmm_bsr": ("spmm_bsr", "LAUNCHES"),
            "spmm_csr": ("spmm_csr", "LAUNCHES"),
            "spmm_csr_f64": ("spmm_csr", "LAUNCHES_F64"),
            "spmm_csr_rows": ("spmm_csr", "LAUNCHES_ROWS"),
            "spmm_csr_rows_f64": ("spmm_csr", "LAUNCHES_ROWS_F64"),
            "spmm_csr_cols": ("spmm_csr", "LAUNCHES_COLS"),
            "spmm_csr_cols_f64": ("spmm_csr", "LAUNCHES_COLS_F64"),
            "sptrsv_csr": ("sptrsv_csr", "LAUNCHES"),
            "sptrsv_csr_f64": ("sptrsv_csr", "LAUNCHES_F64")}

# the counting solve's sums, in the order of its buffer's columns
# (csrc/sptrsv_csr.cu): cycles of each step of a row, then rows and polls
SOLVE_STEPS = ("load", "wait", "fence", "gather", "store")
SOLVE_COUNTS = (*SOLVE_STEPS, "rows", "polls")
# the buffer's slots (a row adds into its ticket's, modulo), and its
# columns
SOLVE_SLOTS = 256
SOLVE_COLUMNS = 8
# the share of a traced window's solve launches that count: the first and
# then every COUNT_EVERY-th. Odd, so that a preconditioner's forward and
# backward solves, launched in turn, are counted in turn
COUNT_EVERY = 7


def recording() -> bool:
    """True while a ``torch.profiler`` records (between its ``start()``
    and ``stop()``)."""
    return _autograd_profiler._is_profiler_enabled


class _Store:
    """Every span's totals, the newest spans, and the counting solve's
    buffers and launches."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()     # each thread's open spans
        self.solve_buffers: dict = {}      # device -> int64 (slots, columns)
        self.clear()

    def clear(self) -> None:
        """Forget the spans and the solve launches (the buffers stay)."""
        with self.lock:
            self.by_name: dict = {}        # name -> [phase, calls, ns, self ns]
            self.top_ns = 0                # top-level spans' durations
            self.records = collections.deque(maxlen=MAX_RECORDS)
            self.traced_launches = 0       # solve launches while recording
            self.solve_launches = 0        # those that counted
            self.solve_launch_rows = 0

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st


_STORE = _Store()


class span:
    """``with span("sblas.<what>", phase):`` or ``@span(...)`` on a
    function: one recorded span (see the module's note). Names begin
    ``sblas.`` (never ``cu``, which a trace reader takes for a CUDA API
    call); ``phase`` is one of :data:`PHASES`. A span object is entered
    once; the decorator makes one a call."""

    __slots__ = ("name", "phase", "start", "child_ns", "range")

    def __init__(self, name: str, phase: str):
        if not name.startswith("sblas."):
            raise ValueError(f"span names begin 'sblas.', got {name!r}")
        if phase not in PHASES:
            raise ValueError(f"phase must be one of {PHASES}, got {phase!r}")
        self.name, self.phase, self.child_ns, self.range = \
            name, phase, 0, None

    def __call__(self, fn):
        name, phase = self.name, self.phase

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name, phase):
                return fn(*args, **kwargs)

        return spanned

    def __enter__(self):
        _STORE.stack().append(self)
        self.start = time.time_ns()
        if recording():
            self.range = record_function(self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        st = _STORE.stack()
        st.pop()
        dur = end - self.start
        parent = st[-1] if st else None
        if parent is not None:
            parent.child_ns += dur
        with _STORE.lock:
            tot = _STORE.by_name.setdefault(self.name, [self.phase, 0, 0, 0])
            tot[1] += 1
            tot[2] += dur
            tot[3] += dur - self.child_ns
            if parent is None:
                _STORE.top_ns += dur
            _STORE.records.append((self.name, self.phase,
                                   parent.name if parent else None,
                                   self.start, end))
        return False


def totals() -> dict:
    """What the spans recorded since the last :func:`reset`:

    - ``"names"``: ``{name: {"phase", "calls", "total_s", "self_s"}}``;
    - ``"phases"``: seconds of self time by phase (phases with spans only);
    - ``"top_s"``: the top-level spans' total, which the phases add up to;
    - ``"spans"``: the newest spans, ``(name, phase, parent name or None,
      start ns, end ns)`` on ``time.time_ns()``'s clock."""
    with _STORE.lock:
        names = {n: {"phase": p, "calls": c, "total_s": ns / 1e9,
                     "self_s": own / 1e9}
                 for n, (p, c, ns, own) in _STORE.by_name.items()}
        phase_ns: dict = {}
        for p, _, _, own in _STORE.by_name.values():
            phase_ns[p] = phase_ns.get(p, 0) + own
        return {"names": names,
                "phases": {p: ns / 1e9 for p, ns in phase_ns.items()},
                "top_s": _STORE.top_ns / 1e9, "spans": list(_STORE.records)}


def _wrapper(module: str):
    return importlib.import_module(f"sblas_torch.ops.kernels.{module}")


def launch_counts() -> dict:
    """Every kernel build's launches so far, by the names of
    :data:`COUNTERS`."""
    return {name: getattr(_wrapper(mod), attr)
            for name, (mod, attr) in COUNTERS.items()}


def solve_counts_buffer(device: torch.device, n: int) -> torch.Tensor | None:
    """The counting solve's buffer on ``device`` (int64, ``SOLVE_SLOTS`` x
    ``SOLVE_COLUMNS``, made at first use) for a launch of ``n`` rows that
    counts: while a profiler records, the first and every
    :data:`COUNT_EVERY`-th. None otherwise, and then the wrapper launches
    the plain solve."""
    if not recording():
        return None
    with _STORE.lock:
        _STORE.traced_launches += 1
        if (_STORE.traced_launches - 1) % COUNT_EVERY:
            return None
        buf = _STORE.solve_buffers.get(device)
        if buf is None:
            buf = _STORE.solve_buffers[device] = torch.zeros(
                (SOLVE_SLOTS, SOLVE_COLUMNS), dtype=torch.int64,
                device=device)
        _STORE.solve_launches += 1
        _STORE.solve_launch_rows += n
    return buf


def solve_counts() -> dict:
    """The counting solve's sums since the last :func:`reset`, over every
    device: ``sptrsv_csr.<step>_cycles`` for each of :data:`SOLVE_STEPS`,
    ``sptrsv_csr.rows``, ``sptrsv_csr.polls``, and the host's count of
    the solve launches while a profiler recorded, of those that counted
    and of the rows they were given (``sptrsv_csr.traced_launches``,
    ``sptrsv_csr.counted_launches``, ``sptrsv_csr.launch_rows``). Each
    buffer is copied to the host once. Empty where no counting launch
    ran."""
    with _STORE.lock:
        bufs = list(_STORE.solve_buffers.values())
        traced = _STORE.traced_launches
        launches, rows = _STORE.solve_launches, _STORE.solve_launch_rows
    if not launches:
        return {}
    sums = [0] * len(SOLVE_COUNTS)
    for buf in bufs:
        for i, v in enumerate(buf.sum(dim=0).tolist()[:len(SOLVE_COUNTS)]):
            sums[i] += int(v)
    out = {f"sptrsv_csr.{s}_cycles": sums[i]
           for i, s in enumerate(SOLVE_STEPS)}
    out["sptrsv_csr.rows"] = sums[len(SOLVE_STEPS)]
    out["sptrsv_csr.polls"] = sums[len(SOLVE_STEPS) + 1]
    out["sptrsv_csr.traced_launches"] = traced
    out["sptrsv_csr.counted_launches"] = launches
    out["sptrsv_csr.launch_rows"] = rows
    return out


def counters() -> dict:
    """:func:`launch_counts` and :func:`solve_counts` in one dict."""
    return {**launch_counts(), **solve_counts()}


def reset() -> None:
    """Clear the spans' store, the counting solve's sums (its buffers are
    zeroed on the device) and every launch count."""
    with _STORE.lock:
        bufs = list(_STORE.solve_buffers.values())
    for buf in bufs:
        buf.zero_()
    _STORE.clear()
    for mod, attr in COUNTERS.values():
        setattr(_wrapper(mod), attr, 0)
