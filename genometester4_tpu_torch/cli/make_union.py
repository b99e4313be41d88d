"""MakeUnion / MakeIntersection — binary-reduction drivers over many
lists (reference: scripts/MakeUnion.pl, scripts/MakeIntersection.pl).
The port's copy of ``genometester4_tpu/cli/make_union.py``.

The Perl scripts shell out to glistcompare pairwise in log2(N) rounds
through ``union_K/`` (or ``intrsec_K/``) staging directories. Here each
pairwise step calls the port's glistcompare in-process on ``device``
(None: CUDA; ``main_union(argv, device="cpu")`` runs its PyTorch ops on
the CPU); the staging layout (round directories, ``copy_`` carry-overs,
``<i>_<i+1>`` output names) is preserved so existing workflows keep
working. In a process group (GT4_DIST_*) each pairwise step runs on the
group and process 0 writes every file.
"""

from __future__ import annotations

import os
import shutil
import sys


def _reduce(argv, op_flag: str, out_base: str, device) -> int:
    from genometester4_tpu_torch.cli.glistcompare import main as gc_main

    lists = [a for a in argv if not a.startswith("-")]
    if len(lists) < 2:
        sys.stderr.write("Usage: at least two list files\n")
        return 1
    n = len(lists)
    k = 1
    files = list(lists)
    first = True
    while n != 1:
        if not first:
            d = f"{out_base}_{k - 1}"
            files = sorted(os.path.join(d, f) for f in os.listdir(d))
            n = len(files)
            if n == 2:
                sys.stderr.write(
                    f"glistcompare {files[0]} {files[1]} -o {out_base} "
                    f"{op_flag}\n")
                rc = gc_main([files[0], files[1], "-o", out_base, op_flag],
                             device=device)
                if rc:
                    return rc
                break
        os.makedirs(f"{out_base}_{k}", exist_ok=True)
        i = 0
        while i < n:
            l1 = files[i]
            if i == n - 1:
                dst = os.path.join(f"{out_base}_{k}",
                                   "copy_" + os.path.basename(l1))
                sys.stderr.write(f"cp {l1} {dst}\n")
                _copy(l1, dst)
                break
            l2 = files[i + 1]
            out = os.path.join(f"{out_base}_{k}", f"{i}_{i + 1}")
            sys.stderr.write(f"glistcompare {l1} {l2} -o {out} {op_flag}\n")
            rc = gc_main([l1, l2, "-o", out, op_flag], device=device)
            if rc:
                return rc
            i += 2
        first = False
        n = int(n / 2 + 0.5)
        k += 1
    return 0


def _copy(src: str, dst: str) -> None:
    """Copy a carried-over list; in a process group (GT4_DIST_*) process
    0 copies and the others wait, so no process reads a half-written
    copy in the next round."""
    from genometester4_tpu_torch.parallel import multihost
    if not multihost.is_multiprocess():
        shutil.copy(src, dst)
        return
    import torch.distributed as dist
    if dist.get_rank() == 0:
        shutil.copy(src, dst)
    multihost.barrier()


def main_union(argv=None, device=None) -> int:
    return _reduce(list(sys.argv[1:] if argv is None else argv), "-u",
                   "union", device)


def main_intersection(argv=None, device=None) -> int:
    return _reduce(list(sys.argv[1:] if argv is None else argv), "-i",
                   "intrsec", device)


if __name__ == "__main__":
    name = os.path.basename(sys.argv[0])
    if "inter" in name.lower():
        raise SystemExit(main_intersection())
    raise SystemExit(main_union())
