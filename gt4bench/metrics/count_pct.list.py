"""count_pct.list: the share of the window in the count step (``listmaker.count_chunks`` or ``sharding.count_kmers_sharded``: upload, kernel A, sort, kernel B, copy back), from the span
"count"."""


def read(run):
    if run.kind != "list":
        return None
    return run.span_pct("count")
