"""setops_roofline.cmp: the set-operation pass against its roofline, in %.

Bytes: 12 per record the parts take in (the program's counter
"compare.words_in", both inputs) and 12 per record they give out
("compare.words_out", every operation): what one merge over the records
needs. Time: the card's kernel time inside the program's job roots
"compare", summed over every card from the profiler's trace
(``run.trace.by_device``): every device activity whose name starts with
neither "Memcpy" nor "Memset" (the sort of the aligned keys, the run
marks, ``index_add``, the masks and ``nonzero`` compactions, the key
transforms), clipped to the roots' intervals. The bound is those bytes
over the H100's memory peak (``gt4bench.peaks``). A pass that sorts what
is already sorted reads low here."""

from gt4bench.peaks import roofline_pct
from gt4bench.program_spans import counted, window_rows
from gt4bench.trace import _union

RECORD_BYTES = 12
NOT_KERNELS = ("memcpy", "memset")


def read(run):
    if run.kind != "list" or run.trace is None:
        return None
    rows = window_rows(run)
    got = counted(run, "list", "compare.words_in", "compare.words_out")
    if rows is None or not got or not got[0]:
        return None
    roots = _union((r.t0, r.t1) for r in rows
                   if r.parent is None and r.name == "compare")
    kernel_s = sum(max(0.0, min(b, hi) - max(a, lo))
                   for acts in run.trace.by_device.values()
                   for a, b, name in acts
                   if not name.lower().startswith(NOT_KERNELS)
                   for lo, hi in roots)
    return roofline_pct(RECORD_BYTES * (got[0] + got[1]), kernel_s)
