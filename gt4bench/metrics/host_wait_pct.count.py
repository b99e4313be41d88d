"""host_wait_pct.count: the union of the program's ``wait`` spans (the
host thread blocked on the card: uploads, syncs, copies back), in % of
the window. Read from ``genometester4_tpu_torch.utils.trace``."""

from gt4bench.program_spans import wait_pct


def read(run):
    return wait_pct(run, "count")
