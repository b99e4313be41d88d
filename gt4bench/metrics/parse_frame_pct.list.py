"""parse_frame_pct.list: the program's span "frame" (the carry join and
the cut at the last whole line or 4-line group) inside its "parse" spans,
in % of the window. Read from ``genometester4_tpu_torch.utils.trace``."""

from gt4bench.program_spans import self_pct


def read(run):
    return self_pct(run, "list", "parse", "frame")
