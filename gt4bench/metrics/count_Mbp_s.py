"""count_Mbp_s: read bases counted per second: every lane pass of the
window and the final ``finalize``, over the window's whole time."""


def read(run):
    if run.kind != "count" or not run.jobs:
        return None
    return sum(j.bases for j in run.jobs) / run.window_s / 1e6
