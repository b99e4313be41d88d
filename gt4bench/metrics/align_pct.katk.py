"""align_pct.katk: the host traceback's share of the window: the
program's spans "align" (``align_reads``' per-read traceback, divergence
count, filters and row build, ``create_gapped_alignment`` and the
divergence tags) directly under "gassemble", their self time, in %."""

from gt4bench.program_spans import self_pct


def read(run):
    return self_pct(run, "count", "gassemble", "align")
