"""The port's span recorder: named, nested spans of host time, and counters.

``with span(name, **attrs) as s:`` marks a piece of the program's work: a
driver phase, a graph capture or replay, a host wait on the device.  Spans
nest; the attributes (``tick``, ``n``, ``ok``, ``kind``, ...) say which
piece it was, and ``s.set(...)`` adds to them before the span closes.
``count(name, n)`` adds to a counter.  The port's counters are the zoom
solver's ``zoom.solves``, ``zoom.iterations``, ``zoom.evaluations`` and
``zoom.syncs`` and the evaluations that a graph replay served,
``zoom.replays`` (``gp/opt.py``), and the tick's ``small.pairs``, the
activation test's predictions with variance (``driver._count_pairs``).

**Totals** are always on.  Every closed span adds its duration and one call,
by name, to each active collection (:func:`collect`), and every counter to
each collection's counts: two ``perf_counter_ns`` calls and one dict update
a span.  ``GPLEDriver.run`` collects into the driver's ``totals``, of which
``GPLEDriver.phase_times`` is a view.  A span closed with ``ok=False``
adds to ``<name>_abort`` instead of ``<name>``.  Outside any collection a
span adds nowhere.

**The timeline** is on only inside :func:`timeline`, the one switch.  There
every span also gets an id, its parent's id and its root's id (the
outermost open span: all spans of one ``GPLEDriver.run`` share the run's),
and is kept in the timeline's ``records`` when it closes.  While a
``torch.profiler`` trace is recording, each span is also opened as a
``record_function`` range, so the trace shows the program's spans over the
device's kernels.

The clock is ``time.perf_counter_ns``; a timeline's ``anchor`` pairs it
with the wall clock and the monotonic clock at the timeline's start, to
place its spans on another trace's clock.
"""

from __future__ import annotations

import itertools
import time
from contextlib import contextmanager

import torch

_now = time.perf_counter_ns
#: the active collections, outermost first
_COLLECTIONS: list = []
#: the active timelines
_TIMELINES: list = []
#: the spans open under a timeline, innermost last
_STACK: list = []
_IDS = itertools.count(1)


class Totals:
    """What a collection's spans and counters add up to: ``spans`` maps a
    name to ``[nanoseconds, calls]``, ``counts`` a counter to its count."""

    __slots__ = ("spans", "counts")

    def __init__(self):
        self.spans = {}
        self.counts = {}

    def add(self, name: str, ns: int, calls: int = 1) -> None:
        entry = self.spans.get(name)
        if entry is None:
            self.spans[name] = [ns, calls]
        else:
            entry[0] += ns
            entry[1] += calls

    def seconds(self, name: str) -> float:
        entry = self.spans.get(name)
        return entry[0] * 1e-9 if entry else 0.0

    def calls(self, name: str) -> int:
        entry = self.spans.get(name)
        return entry[1] if entry else 0

    def count(self, name: str) -> int:
        return self.counts.get(name, 0)


class Span:
    """One span, ``span(name, **attrs)``, a context manager (module
    docstring): ``name``, ``attrs``, ``start`` and ``end`` (ns), and under a
    timeline its ``id``, ``parent`` and ``root`` (None otherwise)."""

    __slots__ = ("name", "attrs", "key", "start", "end", "id", "parent", "root", "_range")

    def __init__(self, name: str, **attrs):
        self.name = self.key = name
        self.attrs = attrs
        self.start = self.end = self.id = self.parent = self.root = self._range = None

    def set(self, **attrs) -> None:
        """Add attributes; ``ok=False`` sends the span's time to ``<name>_abort``."""
        self.attrs.update(attrs)
        if "ok" in attrs:
            self.key = self.name if attrs["ok"] else self.name + "_abort"

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9

    def __enter__(self) -> "Span":
        if _TIMELINES:
            self.id = next(_IDS)
            if _STACK:
                self.parent, self.root = _STACK[-1].id, _STACK[-1].root
            else:
                self.root = self.id
            _STACK.append(self)
            if torch._C._autograd._profiler_enabled():
                self._range = torch.autograd.profiler.record_function(self.name)
                self._range.__enter__()
        self.start = _now()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = _now()
        ns = self.end - self.start
        for totals in _COLLECTIONS:
            totals.add(self.key, ns)
        if self.id is not None:
            if self._range is not None:
                self._range.__exit__(None, None, None)
                self._range = None
            while _STACK:
                if _STACK.pop() is self:
                    break
            for tl in _TIMELINES:
                tl.records.append(self)
        return False


span = Span


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of each active collection."""
    for totals in _COLLECTIONS:
        totals.counts[name] = totals.counts.get(name, 0) + n


def add(name: str, seconds: float) -> None:
    """Add ``seconds`` measured elsewhere (the device's, by CUDA events) and
    one call to the span total ``name`` of each active collection."""
    ns = int(round(seconds * 1e9))
    for totals in _COLLECTIONS:
        totals.add(name, ns)


class collect:
    """``with collect(totals) as t:`` -- the block's spans and counters add to
    ``totals`` (a new :class:`Totals` if None), ``t``.  A collection already
    active is not added twice."""

    __slots__ = ("totals", "_added")

    def __init__(self, totals: Totals | None = None):
        self.totals = Totals() if totals is None else totals
        self._added = False

    def __enter__(self) -> Totals:
        if not any(t is self.totals for t in _COLLECTIONS):
            _COLLECTIONS.append(self.totals)
            self._added = True
        return self.totals

    def __exit__(self, *exc) -> bool:
        if self._added:
            _COLLECTIONS.remove(self.totals)
            self._added = False
        return False


class Timeline:
    """The closed spans of a :func:`timeline` in the order they closed, and
    the ``anchor``: ``perf_counter_ns``, ``time_ns`` and ``monotonic_ns`` read
    together at its start."""

    def __init__(self, anchor: dict, records: list):
        self.anchor = anchor
        self.records = records

    def under(self, span: Span) -> "Timeline":
        """``span`` and the spans under it, in the order they closed."""
        ids, kept = {span.id}, []
        for r in reversed(self.records):      # a parent closes after its children
            if r.id in ids or r.parent in ids:
                ids.add(r.id)
                kept.append(r)
        return Timeline(self.anchor, kept[::-1])

    def self_seconds(self) -> dict:
        """Seconds by name of each span less its children's."""
        children = {}
        for r in self.records:
            if r.parent is not None:
                children[r.parent] = children.get(r.parent, 0) + r.end - r.start
        out = {}
        for r in self.records:
            out[r.name] = out.get(r.name, 0.0) + (r.end - r.start - children.get(r.id, 0)) * 1e-9
        return out


@contextmanager
def timeline():
    """Keep every span that closes in the block (module docstring); yields
    the :class:`Timeline`."""
    tl = Timeline(dict(perf=time.perf_counter_ns(), real=time.time_ns(),
                       mono=time.monotonic_ns()), [])
    _TIMELINES.append(tl)
    try:
        yield tl
    finally:
        _TIMELINES.remove(tl)


def current_timeline() -> Timeline | None:
    """The innermost active timeline, or None."""
    return _TIMELINES[-1] if _TIMELINES else None


def open_spans() -> list:
    """The names of the spans open under a timeline, outermost first."""
    return [s.name for s in _STACK]
