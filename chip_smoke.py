#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py [--seed 44]

Run from the repository root. Phases, each of which must pass:

1. build   nvcc builds the CUDA kernels of genometester4_tpu_torch/csrc.
2. main    glistmaker's counting route, ``make_list(..., device="cuda")``,
           counts the canonical 25-mers of a 50 Mbp genome-shaped FASTA made
           from --seed (GC isochores + planted repeat families) at the default
           2^25-base chunk, so several chunks and the weighted device
           merge run. Both kernels' launch counters must move.
3. oracle  numpy alone (no torch) counts the same 25-mers with np.unique;
           its .list bytes must equal the port's.
4. kernels each CUDA kernel against its plain PyTorch version on the card
           at 2^25 elements: equal bits required (integer contract,
           tolerance 0); median times of both are printed.
5. card    the card's name and power limit from nvidia-smi.

The last two lines of stdout are a JSON object of the kernels and
``{"ok": true, "device": {...}}``. Any failure exits non-zero without
them; so does a machine without CUDA.
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np

K = 25
GENOME_BP = 50_000_000
N_KERNEL = 1 << 25
EXTRACT_KS = (1, 16, 17, 25, 31, 32)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------- input

def genome_bases(seed: int, length: int) -> np.ndarray:
    """Genome-shaped sequence (ASCII ACGT): 100 kb GC isochores with GC
    fraction 0.2 + 0.6 * Beta(2, 2), plus 60 planted repeat families (0.5-5
    kb consensus, 20-200 copies, 1% point mutations per copy, half of the
    copies reverse-complemented)."""
    rng = np.random.default_rng(seed)
    blk = 100_000
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    out = np.empty(length, np.uint8)
    for s in range(0, length, blk):
        gc = rng.beta(2.0, 2.0) * 0.6 + 0.2
        p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
        out[s:s + blk] = rng.choice(alphabet, size=min(blk, length - s), p=p)
    comp = np.zeros(256, np.uint8)
    comp[alphabet] = np.frombuffer(b"TGCA", np.uint8)
    for _ in range(60):
        flen = int(rng.integers(500, 5000))
        fam = rng.choice(alphabet, size=flen)
        for _ in range(int(rng.integers(20, 200))):
            copy = fam.copy()
            nmut = max(1, int(0.01 * flen))
            pos = rng.integers(0, flen, nmut)
            copy[pos] = alphabet[rng.integers(0, 4, nmut)]
            if rng.random() < 0.5:
                copy = comp[copy][::-1]
            at = int(rng.integers(0, length - flen))
            out[at:at + flen] = copy
    return out


def write_fasta(path: str, bases: np.ndarray, width: int = 80) -> None:
    full = len(bases) // width * width
    lines = np.concatenate([bases[:full].reshape(-1, width),
                            np.full((full // width, 1), ord("\n"), np.uint8)],
                           axis=1)
    with open(path, "wb") as f:
        f.write(b">chr1 genome-shaped (isochores + repeat families)\n")
        f.write(lines.tobytes())
        if full < len(bases):
            f.write(bases[full:].tobytes() + b"\n")


# --------------------------------------------------------------- oracle

def oracle_list(path: str, bases: np.ndarray, k: int) -> int:
    """Count canonical k-mers with numpy alone and write the .list file
    (48-byte GT4 4.2 header, then sorted u64 word + u32 count records).
    Returns the number of distinct k-mers."""
    lut = np.full(256, 255, np.uint8)
    for i, ch in enumerate(b"ACGT"):
        lut[ch] = i
    codes = lut[bases].astype(np.uint64)
    check(not (codes == 255).any(), "generator made a non-ACGT base")
    n = len(codes) - k + 1
    fwd = np.zeros(n, np.uint64)
    rc = np.zeros(n, np.uint64)
    for j in range(k):
        fwd = (fwd << np.uint64(2)) | codes[j:j + n]
        rc |= (np.uint64(3) - codes[j:j + n]) << np.uint64(2 * j)
    words, counts = np.unique(np.minimum(fwd, rc), return_counts=True)
    recs = np.empty(len(words), np.dtype([("w", "<u8"), ("c", "<u4")]))
    recs["w"] = words
    recs["c"] = counts
    with open(path, "wb") as f:
        f.write(struct.pack("<IIIIQQQII", 0x47543443, 4, 2, k, len(words),
                            int(counts.sum()), 48, 8, 4))
        recs.tofile(f)
    return len(words)


# -------------------------------------------------------------- timing

def median_ms(torch, fn, reps: int) -> float:
    fn()  # warm-up
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


def max_abs_err(torch, got, want) -> int:
    """Largest |got - want| over integer tensors, exact (0 when equal)."""
    got, want = got.cpu().to(torch.int64), want.cpu().to(torch.int64)
    check(got.shape == want.shape, f"shape {tuple(got.shape)} != "
                                   f"{tuple(want.shape)}")
    bad = torch.nonzero(got != want).flatten()[:1000].tolist()
    return max((abs(int(got[i]) - int(want[i])) for i in bad), default=0)


# ------------------------------------------------------------- phases

def phase_kernels(torch, seed: int) -> dict:
    from genometester4_tpu_torch.ops.encode import SIGN, flag_key
    from genometester4_tpu_torch.ops.extract_cuda import extract_kmers_cuda
    from genometester4_tpu_torch.ops.kmers import extract_kmers
    from genometester4_tpu_torch.ops.runmarks_cuda import run_marks_cuda
    from genometester4_tpu_torch.ops.sortcount import run_marks

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    codes_np = rng.integers(0, 4, N_KERNEL).astype(np.uint8)
    codes_np[rng.random(N_KERNEL) < 0.01] = 255
    codes = torch.from_numpy(codes_np).to(dev)
    res = {}   # name -> [max abs err over all shapes, ms, plain ms at k=K]
    err_a = 0
    for k in EXTRACT_KS:
        for canonical in (True, False):
            kk, kv = extract_kmers_cuda(codes, k, canonical)
            pk, pv = extract_kmers(codes, k, canonical)
            torch.cuda.synchronize()
            err = max_abs_err(torch, kk, pk)
            if k == 32:
                err = max(err, max_abs_err(torch, kv, pv))
            check(err == 0, f"extract kernel != plain at k={k} "
                            f"canonical={canonical} (max abs err {err})")
            err_a = max(err_a, err)
            ms = median_ms(torch, lambda: extract_kmers_cuda(codes, k,
                                                             canonical), 20)
            pms = median_ms(torch, lambda: extract_kmers(codes, k,
                                                         canonical), 5)
            log(f"kernel extract k={k:2d} canonical={int(canonical)} n=2^25: "
                f"{ms:.4f} ms   plain {pms:.4f} ms   equal bits")
            if k == K and canonical:
                res["extract"] = [0, ms, pms]
    res["extract"][0] = err_a

    gen = torch.Generator(device=dev).manual_seed(seed)
    err_b = 0
    for k in (K, 32):
        bits = 2 * k
        hi = torch.randint(0, 1 << max(bits - 32, 0), (N_KERNEL,),
                           generator=gen, device=dev)
        lo = torch.randint(0, 1 << min(bits, 32), (N_KERNEL,),
                           generator=gen, device=dev)
        words = torch.sort((hi << 32) | lo).values
        # ~30% duplicates: those slots repeat their predecessor
        dup = torch.rand(N_KERNEL, generator=gen, device=dev) < 0.3
        idx = torch.arange(N_KERNEL, device=dev)
        idx = torch.where(dup & (idx > 0), idx - 1, idx)
        keys = torch.sort(words[idx] ^ SIGN).values
        if k < 32:   # invalid tail: flagged keys, as extraction makes them
            n_valid = int(N_KERNEL * 0.9)
            keys[n_valid:] = flag_key(bits)
        else:        # k = 32 streams are compacted before the sort
            n_valid = N_KERNEL
        h, t, s = run_marks_cuda(keys, n_valid)
        ph, pt, ps = run_marks(keys, n_valid)
        torch.cuda.synchronize()
        err = max(max_abs_err(torch, h, ph), max_abs_err(torch, t, pt),
                  max_abs_err(torch, s, ps))
        check(err == 0, f"run marks kernel != plain at k={k} "
                        f"(max abs err {err})")
        err_b = max(err_b, err)
        ms = median_ms(torch, lambda: run_marks_cuda(keys, n_valid), 20)
        pms = median_ms(torch, lambda: run_marks(keys, n_valid), 5)
        n_unique, total, chk = (int(v) for v in s.cpu())
        log(f"kernel run_marks k={k} n=2^25 n_valid={n_valid} "
            f"n_unique={n_unique} checksum={chk & 0xFFFFFFFF}: "
            f"{ms:.4f} ms   plain {pms:.4f} ms   equal bits")
        if k == K:
            res["run_marks"] = [0, ms, pms]
    res["run_marks"][0] = err_b
    return res


def run(args) -> None:
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    try:
        from genometester4_tpu_torch.ops import _build
        from genometester4_tpu_torch.ops.extract_cuda import \
            extract_kmers_cuda
        from genometester4_tpu_torch.ops.runmarks_cuda import run_marks_cuda
        from genometester4_tpu_torch.pipelines.listmaker import make_list
    except ImportError as e:
        raise SmokeFailure(f"the port is not importable next to this "
                           f"script: {e}") from e
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")

    # 1. build
    t0 = time.perf_counter()
    so, report = _build.build()
    _build.load_library()
    log(f"build: {time.perf_counter() - t0:.2f} s -> "
        f"{os.path.relpath(so)}")
    for line in report.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    with tempfile.TemporaryDirectory(prefix="gt4_chip_smoke_") as tmp:
        # warm-up on a tiny input: CUDA context, allocator, host parser
        warm = os.path.join(tmp, "warm.fa")
        write_fasta(warm, genome_bases(args.seed + 1, 300_000))
        make_list([warm], K, os.path.join(tmp, "warm.list"), device="cuda")

        # 2. main path
        t0 = time.perf_counter()
        bases = genome_bases(args.seed, GENOME_BP)
        fa = os.path.join(tmp, "genome.fa")
        write_fasta(fa, bases)
        log(f"input: {GENOME_BP} bp genome-shaped FASTA (seed {args.seed}) in "
            f"{time.perf_counter() - t0:.2f} s")
        out = os.path.join(tmp, f"port_{K}.list")
        extract_kmers_cuda.launches = 0
        run_marks_cuda.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hdr = make_list([fa], K, out, device="cuda", debug=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"extract": extract_kmers_cuda.launches,
                    "run_marks": run_marks_cuda.launches}
        log(f"main path: make_list {GENOME_BP} bp seed {args.seed} k={K} "
            f"wall {wall:.3f} s, {hdr.total_count} k-mers ({hdr.total_count / wall / 1e6:.2f} "
            f"M k-mers/s), {hdr.n_words} distinct, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"launches {launches}")
        for name, n in launches.items():
            check(n > 0, f"main path never launched the {name} kernel")

        # 3. oracle
        t0 = time.perf_counter()
        ref = os.path.join(tmp, f"oracle_{K}.list")
        n_ref = oracle_list(ref, bases, K)
        same = filecmp.cmp(out, ref, shallow=False)
        log(f"oracle: numpy np.unique {n_ref} distinct in "
            f"{time.perf_counter() - t0:.2f} s; .list bytes "
            f"{'identical' if same else 'DIFFER'} "
            f"({os.path.getsize(out)} vs {os.path.getsize(ref)} bytes)")
        check(same, "port .list differs from the numpy oracle")
        del bases

    # 4. kernels against their plain versions
    res = phase_kernels(torch, args.seed)

    # 5. card identity
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip())

    rows = []
    for name, src, replaces in (
            ("extract", "genometester4_tpu_torch/csrc/extract.cu",
             "genometester4_tpu/ops/extract_pallas.py:55"),
            ("run_marks", "genometester4_tpu_torch/csrc/runmarks.cu",
             "genometester4_tpu/ops/runmarks_pallas.py:32")):
        err, ms, pms = res[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "ms": round(ms, 4),
                     "plain_ms": round(pms, 4)})
    check("jax" not in sys.modules, "jax was imported")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=44)
    args = ap.parse_args(argv)
    try:
        run(args)
    except (SmokeFailure, ImportError) as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    except Exception:
        import traceback
        traceback.print_exc()
        print("chip_smoke: FAIL", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
