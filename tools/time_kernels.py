#!/usr/bin/env python3
"""Time kernels A (extract), C and D (Smith-Waterman fill) and E (merge
runs) of the port on one GPU.

    python3 tools/time_kernels.py [--seed 44] [--kernels extract,sw,merge]
                                  [--scan]

Times whichever ``genometester4_tpu_torch`` is first on the import path,
so two trees compare in one process each, in turns on one card:

    PYTHONPATH=parent python3 tools/time_kernels.py
    PYTHONPATH=.      python3 tools/time_kernels.py

At the shapes of ``chip_smoke.py`` (kernel A: 2^25 codes with 1% 255,
k = 25 and 32, canonical, and the mesh route's 2^23 chunk; kernel C: 512
reads, n_cap 200, m_cap 152, ragged references, and 128 reads of 2,000;
kernel D: 128 reads, n 200, m 150, and m 2,000; kernel E: n = 2^26 in
runs of L = 2^23 with INT64_MAX tails past 6,291,438), each kernel is
timed two ways with CUDA events: the median of 20 single calls (the
smoke's ``ms``: it includes the wrapper's host work before the launch)
and the median over 5 reps of 20 calls queued back to back (the card's
time per call). Each result is checked against the kernel's plain
PyTorch version first; a shape the tree's wrapper refuses prints its
error instead of times. ``--scan`` adds kernel D at 128 reads, n 200 and
m = 32 S for strip widths S = 1..8 (queued only): one pass of n + 31
steps each, so the times split a step's cost into a part per column of
the strip and a fixed part. Prints one JSON line per kernel shape, then
the card's name and power limit; exits non-zero without CUDA.
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


def sw_rows(torch, seed: int) -> list:
    """Kernels C and D at the smoke's shapes and at reads of 2,000."""
    from genometester4_tpu_torch.ops.swalign import sw_fill
    from genometester4_tpu_torch.ops.swalign_cuda import (
        sw_fill_lanes_cuda, sw_fill_shared_cuda)

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    rows = []
    for name, (B, n, m), lanes in (
            ("sw_lanes 512x200x152", (512, 200, 152), True),
            ("sw_lanes 128x200x2000", (128, 200, 2000), True),
            ("sw_shared 128x200x150", (128, 200, 150), False),
            ("sw_shared 128x200x2000", (128, 200, 2000), False)):
        refs = rng.integers(0, 4, (B, n)).astype(np.int8)
        reads = rng.integers(0, 4, (B, m)).astype(np.int8)
        nvec = np.full(B, n, np.int32)
        if lanes:   # ragged references, as a gassembler window
            nvec = rng.integers(1, n + 1, B).astype(np.int32)
        else:
            refs[:] = refs[0]
        refs_t, reads_t, nvec_t = (torch.from_numpy(a).to(dev)
                                   for a in (refs, reads, nvec))
        ref_t = refs_t[0].contiguous()
        if lanes:
            def fn():
                return sw_fill_lanes_cuda(refs_t, reads_t, nvec_t)
        else:
            def fn():
                return sw_fill_shared_cuda(ref_t, reads_t)
        try:
            got = fn()
        except (ValueError, RuntimeError) as e:
            rows.append((name, f"refused: {e}", None))
            continue
        want = sw_fill(refs_t, reads_t, nvec_t)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"{name}: kernel != plain")
        del got, want
        rows.append((name, single_ms(torch, fn), queued_ms(torch, fn)))
    return rows


def scan_rows(torch, seed: int) -> list:
    """Kernel D, queued ms, at m = 32 S for S = 1..8 (128 reads, n 200)."""
    from genometester4_tpu_torch.ops.swalign_cuda import sw_fill_shared_cuda

    rng = np.random.default_rng(seed)
    ref = torch.from_numpy(rng.integers(0, 4, 200).astype(np.int8)).cuda()
    rows = []
    for S in range(1, 9):
        reads = torch.from_numpy(
            rng.integers(0, 4, (128, 32 * S)).astype(np.int8)).cuda()
        ms = queued_ms(torch, lambda: sw_fill_shared_cuda(ref, reads))
        rows.append((f"sw_shared 128x200x{32 * S} (S={S})", None, ms))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=44)
    ap.add_argument("--kernels", default="extract,sw,merge",
                    help="comma-separated subset of extract, sw, merge")
    ap.add_argument("--scan", action="store_true",
                    help="also time kernel D at strip widths 1..8")
    args = ap.parse_args(argv)
    which = set(args.kernels.split(","))
    import torch
    if not torch.cuda.is_available():
        print("time_kernels: CUDA is not available", file=sys.stderr)
        return 1
    import genometester4_tpu_torch as pkg
    from genometester4_tpu_torch.ops import _build
    from genometester4_tpu_torch.ops.extract_cuda import extract_kmers_cuda
    from genometester4_tpu_torch.ops.kmers import extract_kmers

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
        if "extract" not in which:
            break
        got, want = extract_kmers_cuda(c, k), extract_kmers(c, k)
        torch.cuda.synchronize()
        if not torch.equal(got[0], want[0]):
            raise SystemExit(f"{name}: kernel != plain")
        rows.append((name, single_ms(torch, lambda: extract_kmers_cuda(c, k)),
                     queued_ms(torch, lambda: extract_kmers_cuda(c, k))))

    del codes
    if "sw" in which:
        rows += sw_rows(torch, args.seed)
    if "merge" in which:
        rows.append(merge_row(torch, args.seed))
    if args.scan:
        rows += scan_rows(torch, args.seed)

    for name, one, queued in rows:
        if isinstance(one, str):
            row = {"kernel": name, "error": one}
        elif one is None:
            row = {"kernel": name, "queued_ms": round(queued, 4)}
        else:
            row = {"kernel": name, "single_call_ms": round(one, 4),
                   "queued_ms": round(queued, 4)}
        print(json.dumps({**row, "package": pkg.__file__}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


def merge_row(torch, seed: int):
    from genometester4_tpu_torch.ops.merge_runs import merge_runs
    from genometester4_tpu_torch.ops.merge_runs_cuda import merge_runs_cuda

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, L, cap = 1 << 26, 1 << 23, 6_291_438
    keys = torch.randint(0, 1 << 50, (n // L, L), generator=gen, device=dev)
    keys[:, cap:] = (1 << 63) - 1
    keys = torch.sort(keys, dim=1).values.view(-1)
    got, want = merge_runs_cuda(keys, L), merge_runs(keys, L)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise SystemExit("merge_runs: kernel != plain")
    del got, want
    return ("merge_runs 2^26 L=2^23",
            single_ms(torch, lambda: merge_runs_cuda(keys, L)),
            queued_ms(torch, lambda: merge_runs_cuda(keys, L)))


if __name__ == "__main__":
    sys.exit(main())
