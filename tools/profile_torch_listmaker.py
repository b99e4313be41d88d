#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's glistmaker route.

    python3 tools/profile_torch_listmaker.py [--seed 44]

Run from the repository root on a machine with one CUDA GPU. It counts
the same input as ``chip_smoke.py`` (a 50 Mbp genome-shaped FASTA from
--seed, k = 25, 2^25-base chunks) and prints:

1. wall    ``make_list`` wall time of 5 warm runs in one process on
           one card, with their median and spread (max - min) / median.
2. phases  the same work split into parse, count (upload, kernel A,
           sort, kernel B, compaction, copy to host), merge (host
           bucketing, upload, sort, kernel B, copy back) and write
           (``ListWriter``), each timed to a synchronize; its .list bytes
           must equal ``make_list``'s.
3. device  the phases again under ``torch.profiler``: the card's busy
           time (union of its activity intervals) and its share of the
           profiled phases' wall, split into device-to-host copies,
           host-to-device copies and everything else, then the ops by
           device time.

Exits non-zero when CUDA is missing or the two .list files differ.
"""

from __future__ import annotations

import argparse
import filecmp
import os
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from chip_smoke import GENOME_BP, K, genome_bases, write_fasta  # noqa: E402
from genometester4_tpu_torch.formats.list_format import (  # noqa: E402
    ListWriter)
from genometester4_tpu_torch.io.fasta import iter_code_slabs  # noqa: E402
from genometester4_tpu_torch.pipelines.listmaker import (  # noqa: E402
    count_chunks, make_list, merge_sorted_shards)

REPS = 5


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_make_list(fa: str, out: str, dev: torch.device) -> float:
    _sync(dev)
    t0 = time.perf_counter()
    make_list([fa], K, out, device=dev)
    _sync(dev)
    return time.perf_counter() - t0


def phases(fa: str, out: str, dev: torch.device) -> dict:
    """make_list's default route (no cutoffs, no spill), one phase at a
    time; returns each phase's seconds."""
    t = {}
    t0 = time.perf_counter()
    slabs = list(iter_code_slabs(fa, K, 1 << 28))
    t["parse"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    shards = [s for codes, _ in slabs
              for s in count_chunks(codes, K, device=dev)]
    _sync(dev)
    t["count"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    merged = list(merge_sorted_shards(shards, device=dev))
    _sync(dev)
    t["merge"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with ListWriter(out, K) as w:
        for words, counts in merged:
            w.append(words, counts)
    t["write"] = time.perf_counter() - t0
    return t


def device_busy(prof) -> dict:
    """Busy microseconds of the card, as the union of its activity
    intervals, and the summed durations of each kind of activity."""
    spans, kinds = [], {"memcpy_dtoh": 0.0, "memcpy_htod": 0.0, "other": 0.0}
    for e in prof.events():
        # the profiler's own buffer setup shows up as a device activity
        if (e.device_type != DeviceType.CUDA
                or e.name == "Activity Buffer Request"):
            continue
        spans.append((e.time_range.start, e.time_range.end))
        kind = ("memcpy_dtoh" if e.name.startswith("Memcpy DtoH") else
                "memcpy_htod" if e.name.startswith("Memcpy HtoD") else
                "other")
        kinds[kind] += e.time_range.elapsed_us()
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"busy_us": busy, **kinds}


def fmt(d: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in d.items())


def run(seed: int, reps: int, length: int, dev: torch.device) -> None:
    with tempfile.TemporaryDirectory(prefix="gt4_profile_") as tmp:
        fa = os.path.join(tmp, "genome.fa")
        write_fasta(fa, genome_bases(seed, length))
        ref = os.path.join(tmp, "make_list.list")
        timed_make_list(fa, ref, dev)   # warm-up: context, allocator
        walls = [timed_make_list(fa, ref, dev) for _ in range(reps)]
        med = statistics.median(walls)
        print(f"wall: {length} bp seed {seed} k={K}, {reps} warm runs (s): "
              + " ".join(f"{w:.4f}" for w in walls)
              + f"; median {med:.4f}, spread (max-min)/median "
              f"{(max(walls) - min(walls)) / med:.4f}", flush=True)

        out = os.path.join(tmp, "phases.list")
        t = phases(fa, out, dev)
        print(f"phases (s): {fmt(t)}; sum {sum(t.values()):.4f}", flush=True)
        if not filecmp.cmp(out, ref, shallow=False):
            raise SystemExit("phase-by-phase .list differs from make_list's")

        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            t = phases(fa, out, dev)
            wall = time.perf_counter() - t0
        busy = device_busy(prof)
        print(f"profiled phases (s): {fmt(t)}; wall {wall:.4f}")
        print(f"device busy {busy['busy_us'] / 1e3:.3f} ms = "
              f"{busy['busy_us'] / 1e6 / wall:.4f} of the profiled wall; "
              f"DtoH copies {busy['memcpy_dtoh'] / 1e3:.3f} ms, HtoD copies "
              f"{busy['memcpy_htod'] / 1e3:.3f} ms, other "
              f"{busy['other'] / 1e3:.3f} ms")
        sort_by = ("self_cuda_time_total" if dev.type == "cuda"
                   else "self_cpu_time_total")
        print(prof.key_averages().table(sort_by=sort_by, row_limit=25,
                                        max_name_column_width=60))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=44)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_listmaker: CUDA is not available",
              file=sys.stderr)
        return 1
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    run(args.seed, REPS, GENOME_BP, torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
