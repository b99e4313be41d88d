"""write_pct.list: the share of the window in the ``.list`` output (the sink's packing with ``pack_records``), from the span
"write"."""


def read(run):
    if run.kind != "list":
        return None
    return run.span_pct("write")
