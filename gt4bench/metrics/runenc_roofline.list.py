"""runenc_roofline.list: kernel B (``csrc/runmarks.cu``) against its roofline, in %.

The bound is the larger of the bytes the window's work needs over the
H100's memory peak and its operations over the integer peak
(``gt4bench.peaks``), divided by the kernels' device time in the trace.
Bytes: 8 bytes read per window's key, 16 written per unique word of the job's list: one pass, whatever the chunks and merges. The names below are the kernels summed; where a
program change renames or removes them the metric reads nothing, and only
a benchmark change repoints it."""

from gt4bench.peaks import roofline_pct

KERNELS = ("run_encode_kernel",)


def read(run):
    if run.kind != "list" or run.trace is None:
        return None
    return roofline_pct(8 * run.work["windows"] + 16 * run.work["unique"], run.trace.kernel_seconds(KERNELS))
