"""group_call_pct.katk: grouping and calling's share of the window: the
program's spans "group" (the native group phase), "call" (the call phase,
or a failed region's no-call fill) and "print" (``OutputQueue.flush``)
directly under "gassemble", their self time summed, in %."""

from gt4bench.program_spans import self_pct

SPANS = ("group", "call", "print")


def read(run):
    got = [self_pct(run, "count", "gassemble", n) for n in SPANS]
    if all(g is None for g in got):
        return None
    return sum(g for g in got if g is not None)
