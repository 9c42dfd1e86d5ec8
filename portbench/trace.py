"""Reading a ``torch.profiler`` trace of the traced window.

Every device operation (kernel, copy, set) is attributed to the innermost
benchmark range open on the host when it was launched: the launch's CUDA
runtime event by correlation id, else the CPU operation the profiler
linked it to. The window runs from the first ``solve`` range's start to
the last one's end; ``busy_s`` is the union of device operations inside
it, and each idle stretch is named by what the host was in at its start.
"""

from __future__ import annotations

from collections import defaultdict

from torch.autograd import DeviceType

SOLVE = "solve"
# the prefix of the ranges torch.distributed's NCCL calls record
NCCL_RANGE = "nccl:"


def activity(e, range_names) -> str:
    """The event's kind, from where it ran and its name (the card's torch
    gives events no kind): ``"device"`` (a kernel, copy or set),
    ``"device_range"`` (a host range's copy on the device timeline: the
    benchmark's, or a collective's ``nccl:<op>`` that ``torch.distributed``
    records around its kernels), ``"range"`` (a benchmark range),
    ``"launch"`` (a CUDA API call; their names start with ``cu``) or
    ``"op"`` (a PyTorch operation)."""
    name = e.name()
    if e.device_type() != DeviceType.CPU:
        return "device_range" if name in range_names \
            or name.startswith(NCCL_RANGE) else "device"
    if name in range_names:
        return "range"
    return "launch" if name.startswith("cu") else "op"


def _open_at(spans, queries) -> list:
    """For each host time in ``queries``: ``(innermost range name,
    innermost interval's name if it is an operation, else None)`` over
    the properly nested host intervals ``spans`` (``(start, end, name,
    is_range)``), by one sweep."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out = [("outside", None)] * len(queries)
    stack, j = [], 0
    for qi in sorted(range(len(queries)), key=queries.__getitem__):
        ts = queries[qi]
        while j < len(spans) and spans[j][0] <= ts:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < ts:
            stack.pop()
        if stack:
            name = next((x[2] for x in reversed(stack) if x[3]), "outside")
            out[qi] = (name, None if stack[-1][3] else stack[-1][2])
    return out


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events, layer_ranges) -> dict | None:
    """The traced window's numbers from the profiler's raw events
    (``prof.profiler.kineto_results.events()``) and the names of the
    benchmark's ranges (``Spans.names``): ``window_s``,
    ``busy_s``, per range name ``device_s`` (seconds of device operations
    launched in it) and ``host_s`` (each range's host duration, a list),
    ``device_ops`` and ``idle_gaps`` (seconds by name, largest first).
    None when the trace holds no ``solve`` range."""
    ranges, ops, launch, op_start, dev = [], [], {}, {}, []
    names = (SOLVE, *layer_ranges)
    for e in events:
        kind = activity(e, names)
        if kind == "device":
            dev.append((e.start_ns(), e.end_ns(), e.name(),
                        e.correlation_id(), e.linked_correlation_id()))
        elif kind == "launch":
            launch[e.correlation_id()] = e.start_ns()
        elif kind == "range":
            ranges.append((e.start_ns(), e.end_ns(), e.name(),
                           e.start_thread_id()))
            op_start[e.correlation_id()] = e.start_ns()
        elif kind == "op":
            ops.append((e.start_ns(), e.end_ns(), e.name(),
                        e.start_thread_id()))
            op_start[e.correlation_id()] = e.start_ns()
    solves = [r for r in ranges if r[2] == SOLVE]
    if not solves:
        return None
    main = solves[0][3]
    w0, w1 = min(r[0] for r in solves), max(r[1] for r in solves)
    mine = [(s, e, n, True) for s, e, n, t in ranges if t == main]
    dev = [d for d in dev if d[1] >= w0 and d[0] <= w1]
    at = [launch.get(d[3], op_start.get(d[4], -1)) for d in dev]
    device_s, by_op, busy = defaultdict(float), defaultdict(float), []
    for d, (inner, _) in zip(dev, _open_at(mine, at)):
        s, e, name = d[0], d[1], d[2]
        device_s[inner] += (e - s) / 1e9
        by_op[name[:160]] += (e - s) / 1e9
        busy.append((max(s, w0), min(e, w1)))
    merged = _union(busy)
    busy_s = sum(e - s for s, e in merged) / 1e9

    idle, prev = [], w0
    for s, e in merged + [[w1, w1]]:
        if s > prev:
            idle.append((prev, s))
        prev = max(prev, e)
    gaps = defaultdict(float)
    host = mine + [(s, e, n, False) for s, e, n, t in ops if t == main]
    for (s, e), (rname, op) in zip(idle, _open_at(host, [s for s, _ in idle])):
        gaps[rname if op is None else f"{rname}>{op}"] += (e - s) / 1e9

    host_s = defaultdict(list)
    for s, e, n, t in ranges:
        if t == main and n in layer_ranges and w0 <= s <= w1:
            host_s[n].append((e - s) / 1e9)

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:10]

    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_s,
            "device_s": dict(device_s), "host_s": dict(host_s),
            "device_ops": top(by_op), "idle_gaps": top(gaps),
            "solves": len(solves), "device_events": len(dev),
            "launch_links": sum(1 for d in dev if d[3] in launch)}
