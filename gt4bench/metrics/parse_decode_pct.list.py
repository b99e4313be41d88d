"""parse_decode_pct.list: the program's span "decode" (the native decode
and the prefix concat) inside its "parse" spans, in % of the window. Read
from ``genometester4_tpu_torch.utils.trace``."""

from gt4bench.program_spans import self_pct


def read(run):
    return self_pct(run, "list", "parse", "decode")
