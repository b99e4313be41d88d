"""The benchmark's own spans around calls into the program's layers.

A span is (name, start, end) on the host's ``time.perf_counter``. For a
generator the span covers each ``next()``: the work the layer did for that
item, not the time its consumer held the item. Spans are kept in memory and
read once the window has closed.
"""

from __future__ import annotations

import contextlib
import functools
import time


class Spans:
    def __init__(self):
        self.rows: list[tuple[str, float, float]] = []

    def add(self, name: str, t0: float, t1: float) -> None:
        self.rows.append((name, t0, t1))

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, t0, time.perf_counter())

    def call(self, fn, name: str):
        """``fn`` with one span around each call."""
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return wrapped

    def gen(self, fn, name: str):
        """Generator function ``fn`` with one span around each ``next()``."""
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            it = iter(fn(*args, **kwargs))
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    self.add(name, t0, time.perf_counter())
                    return
                self.add(name, t0, time.perf_counter())
                yield item
        return wrapped

    def seconds(self, name: str, lo: float, hi: float) -> float:
        """Summed length of the spans ``name`` inside [lo, hi]."""
        return sum(max(0.0, min(b, hi) - max(a, lo))
                   for n, a, b in self.rows if n == name)

    def names(self) -> set:
        return {n for n, _, _ in self.rows}

    def open_at(self, t: float, default: str) -> str:
        """The innermost (latest started) span open at ``t``."""
        best, start = default, float("-inf")
        for n, a, b in self.rows:
            if a <= t < b and a > start:
                best, start = n, a
        return best


@contextlib.contextmanager
def patched(pairs):
    """Set ``obj.attr = value`` for each (obj, attr, value), and restore
    every attribute on exit."""
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in pairs]
    try:
        for obj, attr, value in pairs:
            setattr(obj, attr, value)
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)
