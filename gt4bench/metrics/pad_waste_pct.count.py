"""pad_waste_pct.count: the program's counter "count.pad" over
"count.slots" in the window, in %: the padding among the codes the count
step sends to the card. Read from ``genometester4_tpu_torch.utils.trace``."""

from gt4bench.program_spans import pad_pct


def read(run):
    return pad_pct(run, "count")
