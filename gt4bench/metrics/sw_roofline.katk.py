"""sw_roofline.katk: kernel C (``csrc/swalign.cu`` ``sw_lanes_kernel``)
against its roofline, in %.

The bound is the larger of the bytes the window's fills need over the
H100's memory peak and their operations over the integer peak
(``gt4bench.peaks``), divided by the kernel's device time in the trace.
From the program's counters: "sw.cells", the cells the fills write (B x
(n_cap + 1) x (m_cap + 1) a launch), and "sw.in_bytes", the references,
reads and lengths they read once. Bytes: 4 B written per cell (an int16
score, an int8 sx and sy) plus the inputs read once. Operations: 30 per
cell (PERF.md's kernel table, row D). The names below are the kernels
summed; where a program change renames or removes them the metric reads
nothing, and only a benchmark change repoints it."""

from gt4bench.peaks import roofline_pct
from gt4bench.program_spans import counted

KERNELS = ("sw_lanes_kernel",)
BYTES_PER_CELL = 4
OPS_PER_CELL = 30


def read(run):
    if run.trace is None:
        return None
    got = counted(run, "count", "sw.cells", "sw.in_bytes")
    if not got or not got[0]:
        return None
    cells, in_bytes = got
    return roofline_pct(BYTES_PER_CELL * cells + in_bytes,
                        run.trace.kernel_seconds(KERNELS),
                        OPS_PER_CELL * cells)
