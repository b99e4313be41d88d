"""merge_wait_pct.list: the union of the program's ``wait`` spans under a
"merge" span (the merge's uploads, sync and copies back, the mesh's
column merges included), in % of the window. Read from
``genometester4_tpu_torch.utils.trace``."""

from gt4bench.program_spans import wait_pct


def read(run):
    return wait_pct(run, "list", under="merge")
