"""Hierarchical wall-clock timers (the reference's only profiling tool,
``util/timer.hpp:94-288``): RAII-style scopes, printed with show_timers();
and, below, the port's spans and counters."""

from __future__ import annotations

import contextlib
import functools
import time
from contextlib import contextmanager

from torch.autograd import profiler as _profiler

_TIMES: dict[str, float] = {}
_COUNTS: dict[str, int] = {}
_STACK: list[str] = []


@contextmanager
def timer(name: str):
    _STACK.append(name)
    key = "/".join(_STACK)
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        dt = time.perf_counter() - t0
        _TIMES[key] = _TIMES.get(key, 0.0) + dt
        _COUNTS[key] = _COUNTS.get(key, 0) + 1
        _STACK.pop()


def get_timer(name: str) -> float:
    return _TIMES.get(name, 0.0)


def show_timers():
    for key in sorted(_TIMES):
        depth = key.count("/")
        print(f"{'  ' * depth}{key.rsplit('/', 1)[-1]:<30s} "
              f"{_TIMES[key]:10.3f}s  x{_COUNTS[key]}")


def clear_timers():
    _TIMES.clear()
    _COUNTS.clear()
    _STACK.clear()
    _clear_spans()


# -- The port's spans and counters --------------------------------------
#
# ``timer(name)`` above keeps always-on totals.  ``span(name)`` and
# ``count(name, n)`` record only while a torch profiler runs
# (``torch.profiler.profile``: the benchmark's traced window, or an
# operator's own session); otherwise a span is one flag read and a shared
# no-op, and a count one flag read.  While on, ``timer`` records itself as
# a span too.  A span is (name, start_ns, end_ns, parent, request): both
# times from ``time.time_ns()``, the clock the profiler stamps its host
# events with; `parent` the index of the enclosing span in ``spans()``;
# `request` the id of the outermost ``prover.prove`` or
# ``verifier.verify`` span around it, a new one for each call (None
# outside any).  ``summary()`` reduces the record; ``clear_timers()``
# empties it with the totals.

# The spans that open a request: each public call of the prover and the
# verifier.
REQUESTS = frozenset({"prover.prove", "verifier.verify"})
_NOOP = contextlib.nullcontext()


class _Record:
    """Spans by the order they opened (None while open), the indices of
    the open ones (innermost last), the counters and the requests."""

    def __init__(self):
        self.spans: list = []
        self.open: list[int] = []
        self.counters: dict[str, int] = {}
        self.requests = 0
        self.request: int | None = None


_REC = _Record()


def _clear_spans():
    """A new, empty record; a span still open ends in the old one."""
    global _REC
    _REC = _Record()


class _Span:
    __slots__ = ("name", "rec", "slot", "parent", "request", "opens", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = self.rec = _REC
        self.opens = rec.request is None and self.name in REQUESTS
        if self.opens:
            rec.request = rec.requests
            rec.requests += 1
        self.request = rec.request
        self.parent = rec.open[-1] if rec.open else None
        self.slot = len(rec.spans)
        rec.spans.append(None)
        rec.open.append(self.slot)
        self.t0 = time.time_ns()

    def __exit__(self, *exc):
        t1 = time.time_ns()
        rec = self.rec
        rec.spans[self.slot] = (self.name, self.t0, t1, self.parent,
                                self.request)
        rec.open.pop()
        if self.opens:
            rec.request = None
        return False


def span(name: str):
    """A context manager: records (name, start, end, parent, request)
    while a torch profiler runs, and nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return _NOOP
    return _Span(name)


def spanned(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1):
    """Adds `n` to the counter `name` while a torch profiler runs."""
    if _profiler._is_profiler_enabled:
        counters = _REC.counters
        counters[name] = counters.get(name, 0) + n


def spans() -> list:
    """The spans recorded, in the order they opened; an open one is
    None."""
    return list(_REC.spans)


def _covered_ns(intervals, t0: int, t1: int) -> int:
    """The length of the union of `intervals` clipped to [t0, t1]."""
    total, end = 0, t0
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, t1)
        if e > s:
            total += e - s
            end = e
    return total


def summary() -> dict:
    """The record reduced: per span name its count, total seconds and
    self seconds (each span's duration less the union of its direct
    children's intervals), the counters, and the number of requests."""
    recs = _REC.spans
    children: dict[int, list] = {}
    for s in recs:
        if s is not None and s[3] is not None:
            children.setdefault(s[3], []).append((s[1], s[2]))
    by_name: dict[str, list[int]] = {}
    for slot, s in enumerate(recs):
        if s is None:
            continue
        name, t0, t1 = s[0], s[1], s[2]
        own = t1 - t0 - _covered_ns(children.get(slot, ()), t0, t1)
        acc = by_name.setdefault(name, [0, 0, 0])
        acc[0] += 1
        acc[1] += t1 - t0
        acc[2] += own
    return {"spans": {name: {"count": c, "total_s": t / 1e9,
                             "self_s": o / 1e9}
                      for name, (c, t, o) in by_name.items()},
            "counters": dict(_REC.counters),
            "requests": _REC.requests}


def per_request(name: str, key: str):
    """``summary()``'s `key` ("total_s" or "self_s") of the spans `name`
    over the requests recorded; None where either is missing."""
    s = summary()
    rec = s["spans"].get(name)
    if rec is None or not s["requests"]:
        return None
    return rec[key] / s["requests"]
