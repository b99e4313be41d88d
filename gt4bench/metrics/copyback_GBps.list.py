"""copyback_GBps.list: the bytes the program copies back from the card in
the window (its counter "copy.d2h_bytes", read from
``genometester4_tpu_torch.utils.trace``) over the device trace's time in
activities named ``Memcpy DtoH``, in GB/s."""

from gt4bench.program_spans import counted


def read(run):
    got = counted(run, "list", "copy.d2h_bytes")
    if not got or not got[0]:
        return None
    seconds = run.trace.kernel_seconds(("memcpy dtoh",))
    if seconds <= 0:
        return None
    return got[0] / seconds / 1e9
