"""The control of a cell: the plain reference put in the program's place,
with one guarantee of the configuration broken, judged by the comparison
that decides a run's ``correct``. It has to come out wrong.

    python3 -m gt4bench.control --workload <cell> --seeds <n> [<n> ...]

Each seed makes the cell's inputs at their full size, as a run's set-up
does, and prints the control's readings of the cell's compared numbers
(``glistmaker``: forward-strand lists; ``gmer_counter``: 8-bit counters
over ``--passes`` passes of the lane, by default 2, the fewest a run
makes). The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

from gt4bench import manifest
from gt4bench.run import forbidden_modules, set_cache_dirs


def readings(cell: manifest.Cell, seed: int, passes: int, device: str,
             overrides: dict | None = None) -> dict:
    drv_mod = manifest.driver(cell.config["driver"])
    workdir = tempfile.mkdtemp(prefix="gt4bench-control-")
    try:
        drv = drv_mod.Driver(cell.config, cell.traffic, seed, device,
                             workdir, overrides or {})
        drv.make_inputs()
        return drv.control(passes)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gt4bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--passes", type=int, default=2)
    args = ap.parse_args(argv)
    set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("gt4bench.control: no CUDA device", file=sys.stderr)
        return 3
    cell = manifest.cell(args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        r = readings(cell, seed, args.passes, "cuda")
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "passes": args.passes, "control": r,
                          "seconds": time.perf_counter() - t}), flush=True)
    if forbidden_modules():
        print("gt4bench.control: loaded " + ", ".join(forbidden_modules()),
              file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
