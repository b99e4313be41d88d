"""compare_ops_pct.cmp: the set operations: the whole length of the
program's spans "ops" directly under "compare" (a part's ``pair_align``
and every ``apply_pair_op``, or ``apply_multi_op``, with the "sync" spans
inside, where the host waits to read a size back), in % of the window."""

from gt4bench.program_spans import window_rows


def read(run):
    rows = window_rows(run) if run.kind == "list" else None
    if rows is None:
        return None
    roots = {r.id for r in rows if r.name == "compare"}
    ops = [r for r in rows if r.name == "ops" and r.parent in roots]
    if not ops:
        return None
    return 100.0 * sum(r.t1 - r.t0 for r in ops) / run.window_s
