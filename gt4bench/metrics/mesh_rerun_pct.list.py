"""mesh_rerun_pct.list: mesh steps run again, in % of the mesh's count
steps: the program's counters "mesh.reruns" (a step run again after a
bucket overflow) over "mesh.steps" (every step run, reruns included).
Read from ``genometester4_tpu_torch.utils.trace``."""

from gt4bench.program_spans import counted


def read(run):
    got = counted(run, "list", "mesh.reruns", "mesh.steps")
    if not got or not got[1]:
        return None
    return 100.0 * got[0] / got[1]
