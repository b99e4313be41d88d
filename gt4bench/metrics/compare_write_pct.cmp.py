"""compare_write_pct.cmp: the compare's outputs: the self time of the
program's spans "write" directly under "compare" (the sinks' opening,
each ``_OpSink.append`` and ``close``, with the benchmark's sink in the
writer's place: the host pack of the records and their CRC-32), in % of
the window."""

from gt4bench.program_spans import self_pct


def read(run):
    return self_pct(run, "list", "compare", "write")
