"""What the metric readers read from the program's own recorder
(``genometester4_tpu_torch.utils.trace``): its rows inside a run's window.

The program records its spans while a ``torch.profiler`` is active, which
a ``--trace 1`` run's window is, on the host's ``time.perf_counter``, the
clock of the window and of ``trace.DeviceTrace``. A reader keeps only the
rows that lie inside [run.t0, run.t1]. It reads nothing (None) in an
untraced run, in a checkout whose program has no recorder, where no row
lies in the window, and where the recorder dropped rows past its cap (the
window's rows may then be incomplete).
"""

from __future__ import annotations

from gt4bench.trace import _union


def window_rows(run) -> list | None:
    if run.trace is None:
        return None
    try:
        from genometester4_tpu_torch.utils import trace
    except ImportError:
        return None
    if trace.dropped:
        return None
    rows = [r for r in trace.rows() if r.t0 >= run.t0 and r.t1 <= run.t1]
    return rows or None


def _by_id(rows) -> dict:
    return {r.id: r for r in rows}


def self_pct(run, kind: str, parent: str, name: str) -> float | None:
    """The self time (its length less its children's) of the spans
    ``name`` directly under a span ``parent``, in % of the window."""
    rows = window_rows(run) if run.kind == kind else None
    if rows is None:
        return None
    ids = _by_id(rows)
    mine = {r.id for r in rows if r.name == name
            and r.parent in ids and ids[r.parent].name == parent}
    if not mine:
        return None
    s = sum(r.t1 - r.t0 for r in rows if r.id in mine) \
        - sum(r.t1 - r.t0 for r in rows if r.parent in mine)
    return 100.0 * s / run.window_s


def wait_pct(run, kind: str, under: str | None = None) -> float | None:
    """The union of the ``wait`` spans (the host blocked on the card), or
    of those with a span ``under`` above them, in % of the window."""
    rows = window_rows(run) if run.kind == kind else None
    if rows is None:
        return None
    ids = _by_id(rows)

    def inside(r) -> bool:
        while r.parent in ids:
            r = ids[r.parent]
            if r.name == under:
                return True
        return False

    if under is not None and not any(r.name == under for r in rows):
        return None
    waits = [(r.t0, r.t1) for r in rows
             if r.wait and (under is None or inside(r))]
    return 100.0 * sum(b - a for a, b in _union(waits)) / run.window_s


def counted(run, kind: str, *names: str) -> list | None:
    """The window's total of each counter in ``names``, from the counts
    of its rows."""
    rows = window_rows(run) if run.kind == kind else None
    if rows is None:
        return None
    return [sum((r.counts or {}).get(n, 0) for r in rows) for n in names]


def pad_pct(run, kind: str) -> float | None:
    """Padding among the codes sent to the card, in %."""
    got = counted(run, kind, "count.pad", "count.slots")
    if not got or not got[1]:
        return None
    return 100.0 * got[0] / got[1]
