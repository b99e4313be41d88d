"""parse_pct.count: the host slab parse's share of the window, from the
span "parse" around each ``next()`` of ``io/fasta.iter_code_slabs``."""


def read(run):
    if run.kind != "count":
        return None
    return run.span_pct("parse")
