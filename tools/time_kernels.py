#!/usr/bin/env python3
"""Time kernels A (extract) and E (merge runs) of the port on one GPU.

    python3 tools/time_kernels.py [--seed 44]

Times whichever ``genometester4_tpu_torch`` is first on the import path,
so two trees compare in one process each, in turns on one card:

    PYTHONPATH=parent python3 tools/time_kernels.py
    PYTHONPATH=.      python3 tools/time_kernels.py

At the shapes of ``chip_smoke.py`` (kernel A: 2^25 codes with 1% 255,
k = 25 and 32, canonical, and the mesh route's 2^23 chunk; kernel E:
n = 2^26 in runs of L = 2^23 with INT64_MAX tails past 6,291,438), each
kernel is timed two ways with CUDA events: the median of 20 single calls
(the smoke's ``ms``: it includes the wrapper's host work before the
launch) and the median over 5 reps of 20 calls queued back to back (the
card's time per call). Each result is checked against the kernel's plain
PyTorch version first. Prints one JSON line per kernel shape, then the
card's name and power limit; exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import numpy as np


def single_ms(torch, fn, reps: int = 20) -> float:
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(torch, fn, count: int = 20, reps: int = 5) -> float:
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(count):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / count)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=44)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_kernels: CUDA is not available", file=sys.stderr)
        return 1
    import genometester4_tpu_torch as pkg
    from genometester4_tpu_torch.ops import _build
    from genometester4_tpu_torch.ops.extract_cuda import extract_kmers_cuda
    from genometester4_tpu_torch.ops.kmers import extract_kmers
    from genometester4_tpu_torch.ops.merge_runs import merge_runs
    from genometester4_tpu_torch.ops.merge_runs_cuda import merge_runs_cuda

    _build.load_library()
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    n = 1 << 25
    codes_np = rng.integers(0, 4, n).astype(np.uint8)
    codes_np[rng.random(n) < 0.01] = 255
    codes = torch.from_numpy(codes_np).to(dev)
    rows = []
    for name, c, k in (("extract 2^25 k=25", codes, 25),
                       ("extract 2^25 k=32", codes, 32),
                       ("extract 2^23 k=25", codes[:1 << 23], 25)):
        got, want = extract_kmers_cuda(c, k), extract_kmers(c, k)
        torch.cuda.synchronize()
        if not torch.equal(got[0], want[0]):
            raise SystemExit(f"{name}: kernel != plain")
        rows.append((name, single_ms(torch, lambda: extract_kmers_cuda(c, k)),
                     queued_ms(torch, lambda: extract_kmers_cuda(c, k))))

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    n, L, cap = 1 << 26, 1 << 23, 6_291_438
    keys = torch.randint(0, 1 << 50, (n // L, L), generator=gen, device=dev)
    keys[:, cap:] = (1 << 63) - 1
    keys = torch.sort(keys, dim=1).values.view(-1)
    got, want = merge_runs_cuda(keys, L), merge_runs(keys, L)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise SystemExit("merge_runs: kernel != plain")
    del got, want
    rows.append(("merge_runs 2^26 L=2^23",
                 single_ms(torch, lambda: merge_runs_cuda(keys, L)),
                 queued_ms(torch, lambda: merge_runs_cuda(keys, L))))

    for name, one, queued in rows:
        print(json.dumps({"kernel": name, "single_call_ms": round(one, 4),
                          "queued_ms": round(queued, 4),
                          "package": pkg.__file__}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
