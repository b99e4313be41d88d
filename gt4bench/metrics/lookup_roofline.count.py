"""lookup_roofline.count: ``ops/lookup.batched_bounds`` (two ``torch.searchsorted`` of the database's words into each sorted chunk) against its roofline, in %.

The bound is the larger of the bytes the window's work needs over the
H100's memory peak and its operations over the integer peak
(``gt4bench.peaks``), divided by the kernels' device time in the trace.
Bytes: per chunk the database's keys read once and two int64 bounds written per word; every window's key read once. The names below are the kernels summed; where a
program change renames or removes them the metric reads nothing, and only
a benchmark change repoints it."""

from gt4bench.peaks import roofline_pct

KERNELS = ("searchsorted",)


def read(run):
    if run.kind != "count" or run.trace is None:
        return None
    return roofline_pct(24 * run.work["db_words"] * run.work["chunks"] + 8 * run.work["windows"], run.trace.kernel_seconds(KERNELS))
