"""list_Mbp_s: genome bases listed per second: the bases of every job of
the window over the time from the window's start to the end of its last
job, each job run to its end."""


def read(run):
    if run.kind != "list" or not run.jobs:
        return None
    return sum(j.bases for j in run.jobs) / run.window_s / 1e6
