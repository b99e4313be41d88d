"""make_pct.cmp: the list step's share of the window: the whole length of
the program's job roots "list" (``listmaker.make_list``, glistmaker's
listing of the lane: parse, count, merge and the ``.list`` write), in %.
Read from ``genometester4_tpu_torch.utils.trace``."""

from gt4bench.program_spans import window_rows


def read(run):
    rows = window_rows(run) if run.kind == "list" else None
    if rows is None or not any(r.name == "list" for r in rows):
        return None
    s = sum(r.t1 - r.t0 for r in rows if r.parent is None and r.name == "list")
    return 100.0 * s / run.window_s
