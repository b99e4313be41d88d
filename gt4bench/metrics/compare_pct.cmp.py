"""compare_pct.cmp: the compare's share of the window: the whole length of
the program's job roots "compare" (``listcompare.compare_pair`` on the
device route: the inputs' mmaps, the cuts, every part's upload, set
operations and copy back, the outputs), in %. Read from
``genometester4_tpu_torch.utils.trace``."""

from gt4bench.program_spans import window_rows


def read(run):
    rows = window_rows(run) if run.kind == "list" else None
    if rows is None:
        return None
    roots = [r for r in rows if r.parent is None and r.name == "compare"]
    if not roots:
        return None
    return 100.0 * sum(r.t1 - r.t0 for r in roots) / run.window_s
