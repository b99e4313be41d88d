"""compare_copyback_pct.cmp: the compare's copies back: the self time of
the program's spans "copyback" directly under "compare" (``_to_host`` of
each output of a part), in % of the window."""

from gt4bench.program_spans import self_pct


def read(run):
    return self_pct(run, "list", "compare", "copyback")
