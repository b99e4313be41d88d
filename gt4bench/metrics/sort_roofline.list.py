"""sort_roofline.list: ``torch.sort`` of int64 keys (the library's radix sort) against its roofline, in %.

The bound is the larger of the bytes the window's work needs over the
H100's memory peak and its operations over the integer peak
(``gt4bench.peaks``), divided by the kernels' device time in the trace.
Bytes: 8 bytes read and 8 written per window's key. The names below are the kernels summed; where a
program change renames or removes them the metric reads nothing, and only
a benchmark change repoints it."""

from gt4bench.peaks import roofline_pct

KERNELS = ("radixsort",)


def read(run):
    if run.kind != "list" or run.trace is None:
        return None
    return roofline_pct(16 * run.work["windows"], run.trace.kernel_seconds(KERNELS))
