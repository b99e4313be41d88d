"""index_pct.katk: the read index's share of the window: the program's job
spans "count_file" (``DBCounter.add_file`` under ``--compile_index``: the
parse, "index_lookup" a chunk, "index_hits") and "index_write"
(``write_index_db``: "build", "write"), their whole length, in %. Read
from ``genometester4_tpu_torch.utils.trace``."""

from gt4bench.program_spans import window_rows

ROOTS = ("count_file", "index_write")


def read(run):
    rows = window_rows(run) if run.kind == "count" else None
    if rows is None or not any(r.name == "index_write" for r in rows):
        return None
    s = sum(r.t1 - r.t0 for r in rows
            if r.parent is None and r.name in ROOTS)
    return 100.0 * s / run.window_s
