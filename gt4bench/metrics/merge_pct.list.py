"""merge_pct.list: the share of the window in the merge (each ``next()`` of ``listmaker.merge_sorted_shards``), from the span
"merge"."""


def read(run):
    if run.kind != "list":
        return None
    return run.span_pct("merge")
