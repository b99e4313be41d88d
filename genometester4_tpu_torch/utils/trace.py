"""The program's spans and counters: one recorder for every layer.

A span is a timed region of one host thread::

    with trace.span("upload", wait=True):
        chunk = chunk.to(device)

and, once it closes, a row: (name, t0, t1, parent, job, wait, counts, id).
``t0`` and ``t1`` are ``time.perf_counter()`` seconds, the clock of whoever
reads the rows beside a device trace. ``parent`` is the id of the span that
was innermost open on the same thread when this one opened (one stack a
thread), ``job`` the id of the root span above it (a root span's job is its
own id). ``wait`` marks a span in which the host thread blocks on the card.
``counts`` holds the counter increments made while this span was the
innermost open one (None when there were none).

``count(name, n)`` always adds to a process total (``totals()``), so launch
counts read the same whether or not anything records; while a span is open
on the thread it also adds to that span's ``counts``.

Spans are recorded only while a ``torch.profiler`` (or the autograd
profiler) is active, or while the program switches recording on with
``recording()`` (glistmaker's ``-D``, ``tools/group_run``), and inside
a span that is recording. Otherwise ``span()`` returns one shared no-op
context after that single check. The profiler's switch is a thread's
own, so work that a span hands to another thread opens its spans inside
``under(parent)`` with ``parent = current()`` taken on the span's
thread: they are that span's children, and record because it does.
Rows are kept in memory, at most ``CAP`` of them; those past the cap are
counted in ``dropped`` and not kept. ``rows()``, ``totals()``,
``total(name)`` and ``reset()`` are the whole reading API.

No span becomes a ``torch.profiler.record_function`` or NVTX range: under a
CUDA profiler such a range is mirrored onto the device timeline as a user
annotation, which a reader of device activity would count as time the card
was busy. Sharing the host clock is how spans and device activity line up.

The module imports no torch: with torch not loaded no profiler can be on.
"""

from __future__ import annotations

import contextlib
import itertools
import sys
import threading
import time
from typing import NamedTuple

CAP = 1 << 20


class Row(NamedTuple):
    name: str
    t0: float
    t1: float
    parent: int | None
    job: int
    wait: bool
    counts: dict | None
    id: int


_rows: list = []
_totals: dict = {}
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
_forced = 0
dropped = 0


def _profiling() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and torch._C._autograd._profiler_enabled()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Span:
    __slots__ = ("name", "wait", "id", "parent", "job", "counts", "t0")

    def __init__(self, name: str, wait: bool):
        self.name = name
        self.wait = wait

    def __enter__(self):
        st = _stack()
        top = st[-1] if st else None
        self.id = next(_ids)
        self.parent = top.id if top else None
        self.job = top.job if top else self.id
        self.counts = None
        st.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        global dropped
        t1 = time.perf_counter()
        st = _stack()
        while st and st.pop() is not self:
            pass
        row = Row(self.name, self.t0, t1, self.parent, self.job, self.wait,
                  self.counts, self.id)
        with _lock:
            if len(_rows) < CAP:
                _rows.append(row)
            else:
                dropped += 1
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, wait: bool = False):
    """A context that records one row on exit while recording is on, or
    inside an open span of this thread; the shared no-op otherwise."""
    if _forced or getattr(_local, "stack", None) or _profiling():
        return _Span(name, wait)
    return _OFF


def current():
    """This thread's innermost open span, or None."""
    st = getattr(_local, "stack", None)
    return st[-1] if st else None


@contextlib.contextmanager
def under(parent):
    """Inside the block, spans opened on this thread are children of
    ``parent`` (an open span of any thread, from ``current()``), in its
    job, and counters with no span of their own open add to its counts.
    Nothing changes when ``parent`` is None."""
    if parent is None:
        yield
        return
    st = _stack()
    st.append(parent)
    try:
        yield
    finally:
        while st and st.pop() is not parent:
            pass


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the total ``name``, and to the innermost open span's
    counts."""
    st = getattr(_local, "stack", None)
    top = st[-1] if st else None
    with _lock:   # a span's counts may be another thread's (``under``)
        _totals[name] = _totals.get(name, 0) + n
        if top is not None:
            if top.counts is None:
                top.counts = {}
            top.counts[name] = top.counts.get(name, 0) + n


@contextlib.contextmanager
def recording(on: bool = True):
    """Record spans inside the block (nothing changes when ``on`` is
    false)."""
    global _forced
    if not on:
        yield
        return
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


def rows() -> list:
    """The rows kept so far, in the order their spans closed."""
    with _lock:
        return list(_rows)


def totals() -> dict:
    with _lock:
        return dict(_totals)


def total(name: str) -> int:
    """The total of one counter (0 before its first count)."""
    with _lock:
        return _totals.get(name, 0)


def reset() -> None:
    """Forget every row, total and drop."""
    global dropped
    with _lock:
        _rows.clear()
        _totals.clear()
        dropped = 0
