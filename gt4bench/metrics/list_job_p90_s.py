"""list_job_p90_s: the 90th percentile (nearest rank) of the window's
job walls."""

import math


def read(run):
    if run.kind != "list" or not run.jobs:
        return None
    walls = sorted(j.t1 - j.t0 for j in run.jobs)
    return walls[math.ceil(0.9 * len(walls)) - 1]
