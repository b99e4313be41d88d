"""compare_upload_pct.cmp: the compare's uploads: the self time of the
program's spans "upload" directly under "compare" (a part's
``keys_from_u64`` over its records' word fields and its pageable copies to
the card), in % of the window."""

from gt4bench.program_spans import self_pct


def read(run):
    return self_pct(run, "list", "compare", "upload")
