"""host_wait_pct.katk: the union of the program's ``wait`` spans (the host
blocked on the card: the index compile's "upload_wait", "sync" and
"copyback", the fill's "sw_wait"), in % of the window. Read from
``genometester4_tpu_torch.utils.trace``."""

from gt4bench.program_spans import wait_pct


def read(run):
    return wait_pct(run, "count")
