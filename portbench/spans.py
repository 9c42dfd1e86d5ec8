"""Ranges around the benchmark's calls into ``sblas_torch``, for the
traced run: each call into a plan or a preconditioner runs inside a
``torch.profiler.record_function`` range named after its layer, and the
range's least time by :mod:`portbench.roofline` is added up while the
profiler records. With tracing off the port's objects are handed over
bare, so the measured runs carry no range."""

from __future__ import annotations

from collections import defaultdict

from torch.profiler import record_function


class Spans:
    """The names of the ranges wrapped so far, and the ranges' counts and
    least seconds, by range name, over the calls made while ``active``."""

    def __init__(self, on: bool):
        self.on = on
        self.active = False
        self.names: set = set()
        self.calls: dict = defaultdict(int)
        self.least_s: dict = defaultdict(float)

    def wrap(self, name: str, obj, least=None):
        """``obj`` itself with tracing off; else a :class:`Ranged` proxy.
        ``least(args, kwargs)`` gives a call's least seconds."""
        if not self.on:
            return obj
        self.names.add(name)
        return Ranged(obj, name, self, least)


class Ranged:
    """``obj`` with each call inside a range; attributes pass through (so a
    plan keeps the ``shape``/``dtype``/``device`` protocol)."""

    def __init__(self, obj, name: str, spans: Spans, least):
        self._obj, self._name, self._spans, self._least = \
            obj, name, spans, least

    def __getattr__(self, key):
        return getattr(self._obj, key)

    def __call__(self, *args, **kwargs):
        sp = self._spans
        if sp.active:
            sp.calls[self._name] += 1
            if self._least is not None:
                sp.least_s[self._name] += self._least(args, kwargs)
        with record_function(self._name):
            return self._obj(*args, **kwargs)
