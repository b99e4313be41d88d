"""device_idle_pct.list: 1 - the busiest card's busy time (the union of its
device intervals in the profiler's trace) over the window, in %."""


def read(run):
    if run.kind != "list" or run.trace is None:
        return None
    dev = run.trace.busiest()
    if dev is None:
        return None
    return 100.0 * (1.0 - run.trace.busy(dev) / run.window_s)
