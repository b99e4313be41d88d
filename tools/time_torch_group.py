#!/usr/bin/env python3
"""glistmaker on a process group of the PyTorch/CUDA port, timed beside
one process.

    python3 tools/time_torch_group.py [--seed 44] [--procs 2 4]

Run from the repository root on a machine with CUDA cards. It writes the
50 Mbp genome-shaped FASTA of ``chip_smoke.py`` (k = 25) and runs, in
turns, glistmaker in this process on cuda:0 and as groups
(``genometester4_tpu_torch.tools.group_run``) of each process count of
--procs: one card a process where there are enough cards (NCCL), and the
same count on card 0 (gloo through pinned memory). Every group's .list
must equal the single process's. For each run it prints the wall
(process start included for a group), each process's ``main()`` wall,
its exchange (wall s, of it staging s, bytes) and the transport, then
the card's name and power limit. Exits non-zero when CUDA is missing or
a .list differs.
"""

from __future__ import annotations

import argparse
import contextlib
import filecmp
import io
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from genometester4_tpu_torch.cli import glistmaker  # noqa: E402
from genometester4_tpu_torch.tools.group_run import launch  # noqa: E402


def one_process(fa: str, out_dir: str) -> float:
    old = os.getcwd()
    os.chdir(out_dir)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = glistmaker.main([fa, "-w", "25", "-o", "g"], device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        os.chdir(old)
    if rc:
        raise SystemExit(f"glistmaker exited {rc}")
    return wall


def group(fa: str, out_dir: str, procs: int, across: bool):
    envs = [{"CUDA_VISIBLE_DEVICES": str(i if across else 0)}
            for i in range(procs)]
    t0 = time.perf_counter()
    res = launch([{"tool": "glistmaker", "argv": [fa, "-w", "25", "-o",
                                                  "g"]}] * procs,
                 [out_dir] * procs, envs, timeout=900, dist_timeout=300)
    wall = time.perf_counter() - t0
    for rank, (rc, _, err, rep) in enumerate(res):
        if rc or rep is None:
            raise SystemExit(f"process {rank} exited {rc}: {err[-2000:]}")
    return wall, [rep for *_, rep in res]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=44)
    ap.add_argument("--procs", type=int, nargs="+", default=[2, 4])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    cards = torch.cuda.device_count()
    with tempfile.TemporaryDirectory(prefix="gt4_group_") as tmp:
        fa = os.path.join(tmp, "genome.fa")
        bases = chip_smoke.genome_bases(args.seed, chip_smoke.GENOME_BP)
        chip_smoke.write_fasta(fa, bases)
        del bases
        ref = os.path.join(tmp, "one")
        os.makedirs(ref)
        one_process(fa, ref)   # warm-up: kernels built, caches filled
        layouts = [(n, across) for n in args.procs
                   for across in (True, False) if not across or n <= cards]
        for n, across in layouts:
            for turn in ("one", "group", "group", "one"):
                d = os.path.join(tmp, f"{turn}_{n}_{across}")
                os.makedirs(d, exist_ok=True)
                if turn == "one":
                    print(f"one process on cuda:0: main() "
                          f"{one_process(fa, d):.3f} s", flush=True)
                    continue
                wall, reps = group(fa, d, n, across)
                if not filecmp.cmp(os.path.join(d, "g_25.list"),
                                   os.path.join(ref, "g_25.list"),
                                   shallow=False):
                    print(f"group of {n}: .list differs", file=sys.stderr)
                    return 1
                os.remove(os.path.join(d, "g_25.list"))
                where = "one card each" if across else "all on cuda:0"
                print(f"group of {n} ({where}, transport "
                      f"{reps[0]['transport']}): wall {wall:.3f} s; "
                      "main() by process " + ", ".join(
                          f"{r['wall']:.3f}" for r in reps) + " s; exchange "
                      "by process (s, staging s, bytes) " + "; ".join(
                          f"{r['exchange']['s']:.3f}, "
                          f"{r['exchange']['stage_s']:.3f}, "
                          f"{r['exchange']['bytes']}" for r in reps)
                      + "; .list identical", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
