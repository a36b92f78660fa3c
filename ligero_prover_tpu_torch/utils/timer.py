"""Hierarchical wall-clock timers (the reference's only profiling tool,
``util/timer.hpp:94-288``): RAII-style scopes, printed with show_timers()."""

from __future__ import annotations

import time
from contextlib import contextmanager

_TIMES: dict[str, float] = {}
_COUNTS: dict[str, int] = {}
_STACK: list[str] = []


@contextmanager
def timer(name: str):
    _STACK.append(name)
    key = "/".join(_STACK)
    t0 = time.perf_counter()
    try:
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
