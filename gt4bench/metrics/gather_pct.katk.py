"""gather_pct.katk: the read gathering's share of the window: the
program's spans "gather" (a region's index lookups, glibc rand()
subsampling and read fetch: ``get_unique_reads``, ``get_read_sequences``)
directly under gassembler's job span "gassemble", in %."""

from gt4bench.program_spans import self_pct


def read(run):
    return self_pct(run, "count", "gassemble", "gather")
