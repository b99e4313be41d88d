#!/usr/bin/env python3
"""Where the time goes in the port's gassembler route.

    python3 tools/profile_torch_gassembler.py [--seed 44]

Run from the repository root on a machine with one CUDA GPU. It builds the
KATK fixture of ``chip_smoke.py``'s katk phase
(``genometester4_tpu_torch/tools/katk_fixture.py``, from --seed) and its
read index (the port's gmer_counter ``--compile_index`` on CUDA), then
prints:

1. wall    ``main()`` wall of three routes, 3 warm runs each, in turns, in
           this one process: the JAX package's host route and the port's
           own host route (``GT4_TPU_DEVICE_SW=0``: native C fill,
           traceback and filters fused per region), and the port on CUDA.
           Every stdout must equal the JAX host route's.
2. host    one port run under cProfile: cumulative seconds of the
           functions each stage of a region runs.
3. device  one port run under ``torch.profiler``: the card's busy time
           (union of its activity intervals) and share of the wall, kernel
           C's time and launches, and the copies.

Exits non-zero when CUDA is missing or the outputs differ.
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
import io
import os
import pstats
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from genometester4_tpu.cli.gassembler import main as jax_main  # noqa: E402
from genometester4_tpu_torch.cli import gassembler as port_cli  # noqa: E402
from genometester4_tpu_torch.cli import (  # noqa: E402
    gmer_counter as port_counter)
from genometester4_tpu_torch.tools import katk_fixture as kf  # noqa: E402

RUNS = 3
GAS = "genometester4_tpu_torch/pipelines/gassemble.py"
# (file, function) whose cumulative time the cProfile'd port run reports
STAGES = [
    (GAS, "get_unique_reads"),
    (GAS, "get_read_sequences"),
    (GAS, "prefetch_device_sw"),
    ("genometester4_tpu_torch/ops/swalign_cuda.py",
     "sw_matrices_batch_device_multi"),
    ("genometester4_tpu_torch/ops/swalign_cuda.py", "_to_numpy"),
    (GAS, "align_reads"),
    ("genometester4_tpu_torch/ops/swalign.py", "sw_traceback"),
    (GAS, "count_divergent"),
    (GAS, "create_gapped_alignment"),
    (GAS, "_group_phase"),
    (GAS, "_recalculate_and_call"),
]


def timed(main, args, **kw):
    """(stdout, main() wall in s to a synchronize)."""
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = main(args, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc:
        raise SystemExit(f"gassembler exited {rc}")
    return out.getvalue(), wall


def jax_host(args):
    os.environ["GT4_TPU_DEVICE_SW"] = "0"
    try:
        return timed(jax_main, args)
    finally:
        del os.environ["GT4_TPU_DEVICE_SW"]


def port_host(args):
    os.environ["GT4_TPU_DEVICE_SW"] = "0"
    try:
        return timed(port_cli.main, args, device="cuda")
    finally:
        del os.environ["GT4_TPU_DEVICE_SW"]


def port(args):
    return timed(port_cli.main, args, device="cuda")


ROUTES = {"jax host": jax_host, "port host": port_host, "port": port}


def device_busy(prof) -> dict:
    """Busy ms of the card (union of its activity intervals) and the
    summed ms of kernel C, of copies each way and of everything else."""
    spans = []
    kinds = {"sw_lanes": 0.0, "dtoh": 0.0, "htod": 0.0, "other": 0.0}
    for e in prof.events():
        # the profiler's own buffer setup shows up as a device activity
        if (e.device_type != DeviceType.CUDA
                or e.name == "Activity Buffer Request"):
            continue
        spans.append((e.time_range.start, e.time_range.end))
        kind = ("sw_lanes" if "sw_lanes_kernel" in e.name else
                "dtoh" if e.name.startswith("Memcpy DtoH") else
                "htod" if e.name.startswith("Memcpy HtoD") else "other")
        kinds[kind] += e.time_range.elapsed_us() / 1e3
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"busy": busy / 1e3, **kinds}


def run(seed: int) -> None:
    with tempfile.TemporaryDirectory(prefix="gt4_profile_gasm_") as tmp:
        kf.write_katk_fixture(tmp, seed)
        old = os.getcwd()
        os.chdir(tmp)
        try:
            if port_counter.main(kf.INDEX_ARGS, device="cuda"):
                raise SystemExit("gmer_counter --compile_index failed")
            warm = kf.ARGS + ["--max_regions", "8"]
            for route in ROUTES.values():
                route(warm)
            walls = {name: [] for name in ROUTES}
            outs = set()
            for i in range(RUNS):
                for name in (list(ROUTES) if i % 2 == 0
                             else list(ROUTES)[::-1]):
                    out, wall = ROUTES[name](kf.ARGS)
                    outs.add(out)
                    walls[name].append(wall)
            if len(outs) != 1:
                raise SystemExit("the routes' stdouts differ")
            for name, w in walls.items():
                print(f"wall {name}: main() s over {RUNS} warm runs in "
                      f"turns: " + " ".join(f"{x:.4f}" for x in w)
                      + f"; median {sorted(w)[len(w) // 2]:.4f}", flush=True)

            prof = cProfile.Profile()
            prof.enable()
            _, wall = port(kf.ARGS)
            prof.disable()
            stats = pstats.Stats(prof).stats
            print(f"host: port run under cProfile, wall {wall:.4f} s; "
                  f"cumulative s per function:")
            for path, func in STAGES:
                cum = sum(v[3] for (f, _, n), v in stats.items()
                          if n == func and f.endswith(path))
                calls = sum(v[1] for (f, _, n), v in stats.items()
                            if n == func and f.endswith(path))
                print(f"  {path}:{func} {cum:.4f} ({calls} calls)")

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                _, wall = port(kf.ARGS)
            busy = device_busy(prof)
            launches = sum(e.count for e in prof.key_averages()
                           if "sw_lanes_kernel" in e.key)
            print(f"device: port run under torch.profiler, wall {wall:.4f} "
                  f"s; card busy {busy['busy']:.3f} ms = "
                  f"{busy['busy'] / 1e3 / wall:.4f} of the wall; kernel C "
                  f"{busy['sw_lanes']:.3f} ms in {launches} launches, DtoH "
                  f"copies {busy['dtoh']:.3f} ms, HtoD copies "
                  f"{busy['htod']:.3f} ms, other {busy['other']:.3f} ms")
        finally:
            os.chdir(old)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=44)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_gassembler: CUDA is not available",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{smi.stdout.strip()}", flush=True)
    run(args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
