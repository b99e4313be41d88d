"""extract_roofline.list: kernel A (``csrc/extract.cu``) against its roofline, in %.

The bound is the larger of the bytes the window's work needs over the
H100's memory peak and its operations over the integer peak
(``gt4bench.peaks``), divided by the kernels' device time in the trace.
Bytes: 1 byte read and 8 written per real window (padding excluded). The names below are the kernels summed; where a
program change renames or removes them the metric reads nothing, and only
a benchmark change repoints it."""

from gt4bench.peaks import roofline_pct

KERNELS = ("extract_kernel",)


def read(run):
    if run.kind != "list" or run.trace is None:
        return None
    return roofline_pct(9 * run.work["windows"], run.trace.kernel_seconds(KERNELS))
