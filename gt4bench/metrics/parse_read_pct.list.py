"""parse_read_pct.list: the program's span "read" (the file read or
inflate) inside its "parse" spans, in % of the window: the I/O part of the
host parse. Read from ``genometester4_tpu_torch.utils.trace``."""

from gt4bench.program_spans import self_pct


def read(run):
    return self_pct(run, "list", "parse", "read")
