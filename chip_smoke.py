#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py [--seed 44]

Run from the repository root. Phases, each of which must pass:

1. build   nvcc builds the CUDA kernels of genometester4_tpu_torch/csrc,
           one nvcc per source, all started together.
2. main    glistmaker's counting route, ``make_list(..., device="cuda")``,
           counts the canonical 25-mers of a 50 Mbp genome-shaped FASTA made
           from --seed (GC isochores + planted repeat families) at the default
           2^25-base chunk, so several chunks and the weighted device
           merge run. Both kernels' launch counters must move. The merge's
           device passes (weighted count_unique calls, one a rank bucket)
           are logged: more than one, each within its target plus one
           entry per shard, and kernel B launched once a chunk and once a
           pass.
3. oracle  numpy alone (no torch) counts the same 25-mers with np.unique;
           its .list bytes must equal the port's.
3b. mesh   glistmaker's mesh counting route on the same FASTA: ``make_list``
           with ``mesh=make_mesh(8, dp=2, devices=["cuda:0"] * 8)`` (dp=2 x
           kp=4 slots on the one card, S = 8 sources per column, one slab),
           once with GT4_TPU_MESH_MERGE=resort and once with =bitonic. Both
           .list files must equal phase 2's; kernels A and B must launch in
           both runs, kernel E (merge runs) in the bitonic run only.
4a. gmercount  gmer_counter's count mode through the port's CLI on CUDA:
           a text database of 2,000,000 nodes x 2 25-mers (a word of phase
           2's genome and its alt allele, one base changed) and 100 Mbp of
           150 bp FASTQ reads drawn from that genome at 2x with 0.2%
           substitutions, half reverse complemented (four 2^25-base chunks).
           The port's card route and its native host route
           (GT4_TPU_COUNT_IMPL=host) run in this process in turns (card,
           host, host, card); each stdout and stderr must equal the JAX
           package's host route in a subprocess, and kernel A must launch
           on the card route only. Cut to size: users count 30x genomes
           against databases of tens of millions of words; 2x and 4 M
           words keep the phase inside the smoke's time limit. Also timed:
           the card route's stages, and one chunk's count step in JAX's
           join direction (the database searches the sorted chunk) and in
           the other (each window searches the database).
4c. glist  the port's list CLIs in this process on CUDA, each output
           against the JAX CLI's host route (GT4_TPU_COUNT_IMPL=host or
           GT4_TPU_SETOPS_IMPL=host) in a subprocess: (a) glistmaker -w 25
           on phase 2's FASTA (the .list must equal phase 2's; kernels A
           and B must launch) and on phase 4a's reads; (b) glistmaker
           --index on the FASTA, the card route and the port's host route
           in turns (kernel A on the card route only), with the stage
           split; (c) glistcompare -u -i -d -dd on the genome's and the
           reads' lists, the card route (compare_pair) and the host route
           in turns, with peak device memory; (d) glistcompare -u on both
           lists and (b)'s .index, which reaches compare_multi on the card.
           stdout, stderr and every file must be identical. Cut to size:
           users compare whole genomes and 30x read sets; 50 Mbp and 2x
           keep the phase in the smoke's limit.
4d. glistquery  the port's glistquery CLI in this process on CUDA, stdout
           to files, each against the JAX CLI's host route in a subprocess
           (stdout, stderr and rc identical): -l of 4c's reads' .list
           against phase 2's .list and -s of a 5 Mbp slice of 4a's reads
           (a line a window), each on the card route and the host route
           (GT4_TPU_LINK=slow) in turns (card, host, host, card), kernel A
           launching on the -s card route only; --stat, --median,
           --distribution 1000 and --gc. Walls and peak device memory are
           printed. Cut to size: users query whole-genome lists; 50 Mbp
           keeps the phase in the limit.
4e. gmercaller  the port's gmer_caller CLI in this process on CUDA, stdout
           to files, against the JAX CLI's host route
           (GT4_TPU_CALLER_IMPL=host) in subprocesses run beside it:
           FastGT's chain on 4a's counts (2,000,000 nodes, --model diploid:
           node names name no chromosome; --runs 1, --training_size
           20000), the card route and the host route
           (GT4_TPU_CALLER_IMPL=host); a full-model set (2,000,000
           autosomal, 100,000 X and 40,000 Y markers from --seed, FastGT's
           CHR:POS:ID:REF/ALT ids) with
           --runs 0 --coverage 30 --info --header on both routes, and with
           --alternatives --prob_cutoff 0.9 on the card route. Then the
           posterior batch alone on the set's autosomes, card and native in
           turns, bit-equal, as markers/s beside its bound.
4f. extras  (a) 4c.c's glistcompare -u -i -d -dd through the mesh route
           on 4 slots of the card (``make_mesh(devices=["cuda:0"] * 4)``):
           the four files must equal 4c.c's single-card files, and every
           device pass hold at most its target + 2 words; (b) 4a's
           gmer_counter count mode on 4 slots: stdout equal to 4a's, kernel
           A once per chunk; (c) make_union and make_intersection on the
           card over four lists (the genome's, the reads', and the two
           halves of the reads by record), every file, stdout and stderr
           against the JAX CLI's host route in subprocesses; (d) generate_vcf
           on 4e's full-model calls and katk2vcf on phase 4's calls, each
           against the JAX CLI. Bytes are checked before any time prints.
4g. group  glistmaker -w 25 on phase 2's FASTA, 4c.c's glistcompare -u
           -i -d -dd and 4a's gmer_counter, each as a group of two
           processes of the port's CLI (GT4_DIST_* on a free loopback
           port, ``tools.group_run``) sharing the one card, so the
           results travel over gloo through pinned memory (NCCL refuses
           two processes on one card): one 2^25-base chunk a process, 4
           rank buckets over 2 slots, two of 4a's four chunks a process.
           Process 0's files and stdout must equal phases 2, 4c.c and
           4a's; the other process prints and writes nothing; kernels A
           (and B in glistmaker) launch in each process. Each group's
           wall is printed beside one process's; no speed-up is expected.
4. katk    KATK gassembler through the port's CLI on CUDA, over 1,000
           exome-style 200 bp regions (plus one oversized region between
           two regions of more than 200 reads) with 150 bp reads at 40x
           made from --seed; the read index is built by the port's
           gmer_counter --compile_index on CUDA and must equal, byte for
           byte, the one the JAX package's host route builds in a
           subprocess. The port's device route and its own host route
           (GT4_TPU_DEVICE_SW=0: native C fill) run in this process, in
           turns (device, host, host, device). Every run's stdout and
           stderr must equal the JAX package's host route, run in a
           subprocess as the reference, and kernel C must have run in
           fewer launches than regions.
4b. longread  the port's gassembler CLI on CUDA over 24 regions covered
           by reads of 1,500-1,700 bp with ``--max_read_length 1600`` (the
           reads past it cut with a WARNING), so kernel C fills reads 1,600
           columns wide in slabs; its read index is built as in phase 4;
           stdout and stderr must equal the JAX package's host route in a
           subprocess, and kernel C must launch.
5. shared  kernel D's entry point (``sw_pallas_matrices``) over the reads
           of 64 regions; equal to kernel C's entry on the same input.
6. kernels each CUDA kernel against its plain PyTorch version on the card
           at the shapes of its path (kernel A also on codes 1 byte past a
           16-byte boundary; kernel B at k = 25 and 32, unit and u32
           weights, also at n = 2^25 - 12,345, on keys 8 bytes past a
           16-byte boundary and on its edge streams: n = 0, every slot
           invalid, one word over 2^25 slots, 2^25 - 1 distinct keys, runs
           ending on a tile edge and one past it; kernels C and D also on
           reads of 2,000 columns
           and where gap lengths wrap as int8; kernel E also at L = 1, at
           tied keys with 2L below its tile, at L equal to its tile, at an
           odd L and on keys 8 bytes past a 16-byte boundary): equal bits
           required (integer
           contract, tolerance 0); median times of both are printed, with
           each kernel's bound (the larger of its bytes over 3.35 TB/s and
           its integer operations over 16.7 T op/s, from this run's
           inputs) and, for kernels B and E, the one PyTorch call that
           computes the same function (B, with its one host sync:
           torch.unique_consecutive with counts, in turns, equal results
           required; E: a stable segmented torch.sort). Kernel B's host
           syncs in count_unique are counted (set_sync_debug_mode): exactly
           one is required. Also timed:
           kernel A at the mesh route's chunk (2^23), kernel E's partition
           and tile passes (torch.profiler) and one whole mesh merge round
           (merge_sorted_runs with its sortedness check and gather).
7. card    the card's name and power limit from nvidia-smi.

The last two lines of stdout are a JSON object of the kernels and
``{"ok": true, "device": {...}}``. Any failure exits non-zero without
them; so does a machine without CUDA. Nothing of JAX or of the JAX package
is imported here: the JAX package runs only in subprocesses, as the
reference.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import cProfile
import filecmp
import io
import itertools
import json
import os
import pstats
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np

from genometester4_tpu_torch.utils import trace

K = 25
GENOME_BP = 50_000_000
N_KERNEL = 1 << 25
EXTRACT_KS = (1, 5, 16, 17, 25, 31, 32)
N_MESH_CHUNK = 1 << 23   # the mesh route's chunk (kernel A's shape there)

SHARED_REGIONS = 64      # kernel D's path: regions for sw_pallas_matrices
SW_LANES_SHAPE = (512, 200, 152)   # kernel C: window of reads, n_cap, m_cap
SW_SHARED_SHAPE = (128, 200, 150)  # kernel D: reads, n, m
SW_WIDE_SHAPE = (128, 200, 2000)   # kernels C and D on reads of 2,000
# kernel E at the mesh route's first merge round: S2 * cap2 = 8 * 2^23 keys
# in runs of cap2, each run's tail (past cap ~ 6.29 M) the INT64_MAX padding
MERGE_N, MERGE_L, MERGE_CAP = 1 << 26, 1 << 23, 6_291_438
MESH_SLOTS, MESH_DP = 8, 2
# gmer_counter's count phase: text database nodes (2 K-mers each), reads
GMER_NODES = 2_000_000
GMER_READ_BP, GMER_DEPTH, GMER_SUB = 150, 2, 0.002
GMER_COUNTS = "gmer_counts.txt"   # phase 4a's card-route stdout (4e's input)
GMER_CALLS = "gmer_calls.txt"     # 4e's full-model card stdout (4f.d's input)
KATK_CALLS = "katk_calls.txt"     # phase 4's first device-route stdout (4f.d)
MESH_COMPARE_SLOTS = 4            # 4f.a and 4f.b: slots of one card
QUERY_SEQ_BP = 5_000_000          # 4d: glistquery -s on this much of 4a's reads
# 4e: the full-model marker set (autosomal, X, Y) and the chain's training
CALLER_MARKERS = (2_000_000, 100_000, 40_000)
CALLER_TRAINING = 20_000
LINK_BYTES = 64e9   # PCIe 5.0 x16, one direction (the H100 data sheet)
# H100 SXM: HBM bytes/s, and int32 ops/s outside the tensor cores (132 SMs
# x 64 int32 lanes x 1.98 GHz boost)
PEAK_BYTES, PEAK_INT_OPS = 3.35e12, 16.7e12
# integer operations per element that each function needs at the least:
# a rolling canonical word per window (A), neighbour compares and the
# checksum per key (B), the affine recurrence per cell (C, D), a compare
# and select per merged key (E)
OPS_PER = {"extract": 12, "run_marks": 10, "sw_lanes": 30, "sw_shared": 30,
           "merge_runs": 4}


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

def median_ms(torch, fn, reps: int, samples: bool = False):
    """Median ms of ``reps`` calls, each alone between two events (with
    ``samples``: the list of times)."""
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
    return times if samples else statistics.median(times)


def batch_ms(torch, fn, count: int = 20) -> float:
    """ms per call of ``count`` calls queued back to back between two
    events: the card's time per launch once the wrapper's host work
    overlaps the previous launch (``median_ms`` times one call alone)."""
    fn()  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(count):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / count


def bound(name: str, n_bytes: float, n_elems: float):
    """(bound ms, "bytes" or "operations") for ``n_bytes`` moved and
    ``n_elems`` elements of OPS_PER[name] integer operations."""
    by_bytes = n_bytes / PEAK_BYTES * 1e3
    by_ops = n_elems * OPS_PER[name] / PEAK_INT_OPS * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def max_abs_err(torch, got, want) -> int:
    """Largest |got - want| over integer tensors, exact (0 when equal)."""
    check(got.shape == want.shape, f"shape {tuple(got.shape)} != "
                                   f"{tuple(want.shape)}")
    got = got.cpu().to(torch.int64).flatten()
    want = want.cpu().to(torch.int64).flatten()
    bad = torch.nonzero(got != want).flatten()[:1000].tolist()
    return max((abs(int(got[i]) - int(want[i])) for i in bad), default=0)


# ------------------------------------------------------------- phases

def phase_kernels(torch, seed: int) -> dict:
    from genometester4_tpu_torch.ops.extract_cuda import extract_kmers_cuda
    from genometester4_tpu_torch.ops.kmers import extract_kmers

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
            if k == K and canonical:   # codes in, int64 keys out
                res["extract"] = [0, ms, pms, *bound(
                    "extract", 9 * N_KERNEL, N_KERNEL), None]
                qms = batch_ms(torch, lambda: extract_kmers_cuda(codes, k))
                log(f"kernel extract k={k} canonical=1 n=2^25: {qms:.4f} "
                    f"ms per call, 20 back to back")
    # codes 1 byte past a 16-byte boundary (a contiguous slice)
    for k in (K, 32):
        sl = codes[1:]
        kk, kv = extract_kmers_cuda(sl, k)
        pk, pv = extract_kmers(sl, k)
        torch.cuda.synchronize()
        err = max(max_abs_err(torch, kk, pk),
                  max_abs_err(torch, kv, pv) if k == 32 else 0)
        check(err == 0, f"extract kernel != plain on unaligned codes at "
                        f"k={k} (max abs err {err})")
        err_a = max(err_a, err)
    log(f"kernel extract: equal bits on codes 1 byte past a 16-byte "
        f"boundary, n=2^25-1, k={K} and 32")
    chunk = codes[:N_MESH_CHUNK]
    ms = median_ms(torch, lambda: extract_kmers_cuda(chunk, K), 20)
    bbms = batch_ms(torch, lambda: extract_kmers_cuda(chunk, K))
    bms, by = bound("extract", 9 * N_MESH_CHUNK, N_MESH_CHUNK)
    log(f"kernel extract k={K} canonical=1 n=2^23 (the mesh route's chunk): "
        f"{ms:.4f} ms ({bbms:.4f} ms per call, 20 back to back)   bound "
        f"{bms:.4f} ms ({by})")
    res["extract"][0] = err_a

    res["run_marks"] = phase_run_encode(torch, seed)
    count_syncs_check(torch, codes)
    return res


def encode_err(torch, got, want) -> int:
    """Largest difference between two run encodings (unique keys, counts,
    n_unique, total, checksum); 0 when equal."""
    err = max(max_abs_err(torch, got[0], want[0]),
              max_abs_err(torch, got[1], want[1]))
    return max([err] + [abs(a - b) for a, b in zip(got[2:], want[2:])])


def run_encode_bound(n_valid: int, n_unique: int, weighted: bool):
    """Kernel B's bound: each valid key (and weight) read once, each run's
    key and count written once, the 12 bytes of stats."""
    return bound("run_marks", n_valid * (16 if weighted else 8)
                 + n_unique * 16 + 12, n_valid)


def run_edge_streams(torch, gen, k: int):
    """Kernel B's edge streams at k (word bits 2k; k = 32 has no invalid
    key): (name, sorted keys) on the card."""
    from genometester4_tpu_torch.ops import _build
    from genometester4_tpu_torch.ops.encode import SIGN, flag_key

    dev = torch.device("cuda")
    bits = 2 * k
    tile = _build.load_library().gt4_run_encode_tile()

    def runs(lengths):   # distinct random keys, repeated run by run
        lengths = torch.as_tensor(lengths, device=dev)
        m = lengths.numel()
        hi = torch.randint(0, 1 << (bits - 32), (2 * m,), generator=gen,
                           device=dev)
        lo = torch.randint(0, 1 << 32, (2 * m,), generator=gen, device=dev)
        keys = torch.unique(((hi << 32) | lo) ^ SIGN)[:m]
        check(keys.numel() == m, "too few distinct random keys")
        return torch.repeat_interleave(keys, lengths)

    yield "n = 0", torch.zeros(0, dtype=torch.int64, device=dev)
    if k < 32:
        yield "every slot invalid", torch.full((3 * tile + 5,),
                                               flag_key(bits), device=dev)
    yield "one word over all 2^25 slots", runs([N_KERNEL])
    yield "every key distinct, 2^25 - 1", runs(
        torch.ones(N_KERNEL - 1, dtype=torch.int64, device=dev))
    yield ("runs ending on a tile edge and one past it",
           runs([tile, tile + 1, tile - 1, 1, 2 * tile - 1, 1, tile, 3,
                 tile - 3] * 50))


def phase_run_encode(torch, seed: int) -> list:
    """Kernel B against ``run_encode`` on the card, bit for bit: at k = 25
    and 32, unit and random u32 weights (sums wrap past 2^32), on 2^25
    sorted keys with ~30% repeats (k = 25: a 10% invalid tail), on their
    first 2^25 - 12,345 (n not a multiple of the tile), on the same keys 8
    bytes past a 16-byte boundary, and on the edge streams. Times the 2^25
    shapes against their bounds. Returns [max abs err, ms, plain ms, bound
    ms, bound by, library ms] at k = 25 with unit weights."""
    from genometester4_tpu_torch.ops.encode import SIGN, flag_key
    from genometester4_tpu_torch.ops.runmarks_cuda import run_encode_cuda
    from genometester4_tpu_torch.ops.sortcount import run_encode

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = None

    def compare(name, keys, weights, bits):
        got = run_encode_cuda(keys, weights, bits)
        want = run_encode(keys, weights, bits)
        torch.cuda.synchronize()
        err = encode_err(torch, got, want)
        check(err == 0, f"run encode kernel != plain on {name} "
                        f"(max abs err {err})")
        return got

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
            keys[int(N_KERNEL * 0.9):] = flag_key(bits)
        del hi, lo, words, dup, idx
        weights = torch.randint(0, 1 << 32, (N_KERNEL,), generator=gen,
                                device=dev)
        for w in (None, weights):
            mode = "unit" if w is None else "weighted"
            got = compare(f"k={k} {mode} n=2^25", keys, w, bits)
            n_unique, total, chk = got[2:]
            ms = median_ms(torch, lambda: run_encode_cuda(keys, w, bits), 20)
            pms = median_ms(torch, lambda: run_encode(keys, w, bits), 5)
            kms = device_ms(torch, lambda: run_encode_cuda(keys, w, bits),
                            ["run_encode_kernel"])["run_encode_kernel"]
            bms, by = run_encode_bound(total, n_unique, w is not None)
            log(f"kernel run_marks (run encode) k={k} {mode} n=2^25 "
                f"n_valid={total} n_unique={n_unique} checksum={chk}: "
                f"{ms:.4f} ms per call with its one sync (kernel alone "
                f"{kms:.4f} ms, torch.profiler)   plain {pms:.4f} ms   bound "
                f"{bms:.4f} ms ({by})   equal bits")
            if k == K and w is None:
                lms, tms = run_marks_library_ms(torch, keys, bits)
                out = [0, tms, pms, bms, by, lms]
            for name, sub in (
                    ("n = 2^25 - 12,345", slice(0, N_KERNEL - 12_345)),
                    ("keys 8 bytes past a 16-byte boundary", slice(1, None))):
                ks = keys[sub]
                check(sub.start == 0 or ks.data_ptr() % 16 == 8,
                      "keys are 16-byte aligned")
                compare(f"k={k} {mode} {name}", ks,
                        None if w is None else w[sub], bits)
        del keys, weights
        for name, keys in run_edge_streams(torch, gen, k):
            weights = torch.randint(0, 1 << 32, keys.shape, generator=gen,
                                    device=dev)
            for w in (None, weights):
                got = compare(f"k={k} {name}", keys, w, bits)
            log(f"kernel run_marks (run encode) k={k} {name}: "
                f"n={keys.numel()} n_unique={got[2]} total={got[3]}, unit "
                f"and weighted equal bits")
    log(f"kernel run_marks (run encode): equal bits at k={K} and 32, unit "
        f"and weighted, on n = 2^25, 2^25 - 12,345, keys 8 bytes past a "
        f"16-byte boundary and every edge stream")
    return out


def run_marks_library_ms(torch, keys, bits: int):
    """Kernel B from sorted keys to the unique keys and counts on the card,
    its one sync included, against the one PyTorch call that computes the
    same, ``torch.unique_consecutive(return_counts=True)`` on the valid
    keys: equal results required. Timed in turns (B, library, library, B),
    30 calls each. Returns (library ms, kernel B ms), each the median of
    its 60 calls."""
    from genometester4_tpu_torch.ops.runmarks_cuda import run_encode_cuda

    def kernel_b():
        return run_encode_cuda(keys, None, bits)[:2]

    n_valid = run_encode_cuda(keys, None, bits)[3]
    valid = keys[:n_valid]

    def library():
        return torch.unique_consecutive(valid, return_counts=True)

    (w1, c1), (w2, c2) = kernel_b(), library()
    check(torch.equal(w1, w2) and torch.equal(c1, c2),
          "kernel B != torch.unique_consecutive")
    turns = [(who, median_ms(torch, kernel_b if who == "B" else library, 30,
                             samples=True))
             for who in ("B", "library", "library", "B")]
    ms = {who: statistics.median(sum((t for w, t in turns if w == who), []))
          for who in ("B", "library")}
    log(f"kernel run_marks (run encode) k={K} n=2^25 n_valid={n_valid}, in "
        f"turns of 30 calls, kernel B with its one sync against the library "
        f"(torch.unique_consecutive, return_counts): " + ", ".join(
            f"{who} {statistics.median(t):.4f}" for who, t in turns)
        + f" ms; medians B {ms['B']:.4f}, library {ms['library']:.4f} ms; "
        f"equal words and counts")
    return ms["library"], ms["B"]


def count_syncs_check(torch, codes) -> None:
    """Host syncs of ``count_unique`` on one 2^25-code chunk's keys at
    k = K, counted under ``torch.cuda.set_sync_debug_mode("warn")``: it
    must be exactly one (kernel B's read of its stats). Also logs the
    count of the whole ``count_chunk``."""
    import warnings

    from genometester4_tpu_torch.ops.kmers import extract_kmers_best
    from genometester4_tpu_torch.ops.sortcount import count_unique
    from genometester4_tpu_torch.pipelines.listmaker import count_chunk

    keys, _ = extract_kmers_best(codes, K)
    torch.cuda.synchronize()
    syncs = {}
    for name, fn in (
            ("count_unique", lambda: count_unique(keys, word_bits=2 * K)),
            ("count_chunk", lambda: count_chunk(codes, K))):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs[name] = sum("called a synchronizing CUDA operation"
                          in str(w.message) for w in caught)
        torch.cuda.synchronize()
    log(f"host syncs at k={K} on one 2^25-code chunk "
        f"(set_sync_debug_mode warnings): {syncs}")
    check(syncs["count_unique"] == 1,
          f"count_unique made {syncs['count_unique']} host syncs, not 1")


def device_ms(torch, fn, names, reps: int = 5) -> dict:
    """Device ms per call of the kernels whose names contain each of
    ``names``, from ``torch.profiler`` over ``reps`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = dict.fromkeys(names, 0.0)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for name in names:
            if name in e.name:
                us[name] += e.time_range.elapsed_us()
    return {name: v / (reps * 1e3) for name, v in us.items()}


def phase_merge_kernel(torch, seed: int) -> list:
    """Kernel E against ``merge_runs`` on the card: keys, positions and a
    gathered int64 payload bit for bit at the mesh route's shape, at L = 1,
    at tied keys with 2L below the 3840-slot tile, at L equal to the tile,
    at an odd L (tiles crossing spans) and on keys 8 bytes past a 16-byte
    boundary. Times the whole mesh merge round at the path's shape and the
    kernel's two passes. Returns [max abs err, ms, plain ms, bound ms,
    bound by, library ms] at the path's shape."""
    from genometester4_tpu_torch.ops.merge_runs import (merge_runs,
                                                        merge_sorted_runs)
    from genometester4_tpu_torch.ops.merge_runs_cuda import merge_runs_cuda

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    sentinel = (1 << 63) - 1
    out = None
    err_e = 0
    for name, n, L, card in (("path", MERGE_N, MERGE_L, 1 << 50),
                             ("L=1", 1 << 20, 1, 1 << 50),
                             ("ties, 2L=200", 200 * 5000, 100, 5),
                             ("L=tile", 7680 * 128, 3840, 1 << 50),
                             ("odd L", 8 * 99_999, 99_999, 1000),
                             ("keys 8 B past 16", 1 << 22, 1 << 19, 1 << 50)):
        keys = torch.randint(0, card, (n // L, L), generator=gen, device=dev)
        if name == "path":
            keys[:, MERGE_CAP:] = sentinel
        keys = torch.sort(keys, dim=1).values.view(-1)
        if name == "keys 8 B past 16":
            buf = torch.empty(n + 1, dtype=torch.int64, device=dev)
            buf[1:] = keys
            keys = buf[1:]
            check(keys.data_ptr() % 16 == 8, "keys are 16-byte aligned")
        payload = torch.randint(0, 1 << 62, (n,), generator=gen, device=dev)
        got, gpos = merge_runs_cuda(keys, L)
        want, wpos = merge_runs(keys, L)
        torch.cuda.synchronize()
        err = max(max_abs_err(torch, got, want),
                  max_abs_err(torch, gpos, wpos),
                  max_abs_err(torch, payload[gpos], payload[wpos]))
        check(err == 0, f"merge_runs kernel != plain at {name} n={n} L={L} "
                        f"(max abs err {err})")
        err_e = max(err_e, err)
        ms = median_ms(torch, lambda: merge_runs_cuda(keys, L), 20)
        pms = median_ms(torch, lambda: merge_runs(keys, L), 5)
        lms = median_ms(torch, lambda: torch.sort(
            keys.view(-1, 2 * L), dim=1, stable=True), 5)
        bms, by = bound("merge_runs", 20 * n, n)   # keys in; keys, int32 out
        log(f"kernel merge_runs {name} n={n} L={L}: {ms:.4f} ms   plain "
            f"{pms:.4f} ms   library (stable torch.sort) {lms:.4f} ms   "
            f"bound {bms:.4f} ms ({by})   equal bits (keys, positions, "
            f"int64 payload)")
        if out is None:
            out = [err, ms, pms, bms, by, lms]
            split = device_ms(torch, lambda: merge_runs_cuda(keys, L),
                              ["merge_partition_kernel", "merge_tile_kernel"])
            counts = torch.randint(0, 1 << 31, (n,), generator=gen,
                                   device=dev)
            rms = median_ms(torch, lambda: merge_sorted_runs(
                (keys, counts), L), 10)
            log(f"kernel merge_runs {name}: "
                f"{batch_ms(torch, lambda: merge_runs_cuda(keys, L)):.4f} ms "
                f"per call, 20 back to back; partition pass "
                f"{split['merge_partition_kernel']:.4f} ms + tile pass "
                f"{split['merge_tile_kernel']:.4f} "
                f"ms (torch.profiler); one mesh merge round "
                f"merge_sorted_runs((keys, counts), L) {rms:.4f} ms "
                f"(sortedness check with its host sync, kernel E, the "
                f"counts gather): kernel E {ms / rms:.1%} of the round")
            del counts
        del keys, payload, got, gpos, want, wpos
    out[0] = err_e
    return out


@contextlib.contextmanager
def environ(name: str, value):
    """Environment variable ``name`` set to ``value`` (unset for None) for
    the block, restored after it."""
    old = os.environ.pop(name, None)
    if value is not None:
        os.environ[name] = value
    try:
        yield
    finally:
        os.environ.pop(name, None)
        if old is not None:
            os.environ[name] = old


def mesh_slots():
    from genometester4_tpu_torch.parallel.sharding import make_mesh
    return make_mesh(MESH_SLOTS, dp=MESH_DP, devices=["cuda:0"] * MESH_SLOTS)


def phase_mesh(torch, fa: str, tmp: str, single: str, single_wall: float):
    """The mesh counting route on the main path's FASTA in both merge
    modes, each .list equal to the single-chip route's. Returns the
    launches of the bitonic run."""
    from genometester4_tpu_torch.pipelines.listmaker import make_list

    counters = {"extract": "extract", "run_marks": "run_encode",
                "merge_runs": "merge_runs"}
    runs = {}
    for mode in ("resort", "bitonic"):
        mesh = mesh_slots()
        out = os.path.join(tmp, f"mesh_{mode}_{K}.list")
        trace.reset()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        phases = io.StringIO()
        with environ("GT4_TPU_MESH_MERGE", mode), \
                contextlib.redirect_stderr(phases):
            make_list([fa], K, out, device="cuda", mesh=mesh, debug=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for line in phases.getvalue().splitlines():
            log(f"  mesh ({mode}) -D: {line}")
        runs[mode] = {name: trace.total("launch." + kernel)
                      for name, kernel in counters.items()}
        same = filecmp.cmp(out, single, shallow=False)
        log(f"mesh path ({mode}): make_list dp={MESH_DP} x "
            f"kp={MESH_SLOTS // MESH_DP} slots on cuda:0, wall {wall:.3f} s "
            f"(single-chip route {single_wall:.3f} s), peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
            f"{runs[mode]}, .list {'identical' if same else 'DIFFERS'}")
        check(same, f"mesh ({mode}) .list differs from the single-chip "
                    f"route's")
        os.remove(out)
    for mode, n in runs.items():
        check(n["extract"] > 0 and n["run_marks"] > 0,
              f"mesh ({mode}) never launched kernel A or B: {n}")
    check(runs["resort"]["merge_runs"] == 0,
          "kernel E launched in resort mode")
    check(runs["bitonic"]["merge_runs"] > 0,
          "kernel E never launched in bitonic mode")
    return runs["bitonic"]


def _digits(n: int, width: int) -> np.ndarray:
    """ASCII decimal 0..n-1, zero padded to ``width``: uint8[n, width]."""
    i = np.arange(n)
    return np.stack([48 + (i // 10 ** (width - 1 - j)) % 10
                     for j in range(width)], axis=1).astype(np.uint8)


def write_gmer_db(path: str, bases: np.ndarray, seed: int) -> None:
    """db.txt: GMER_NODES lines ``nNNNNNNN 2 REF ALT`` (tab separated), REF
    the K-mer of ``bases`` at a random position and ALT that word with its
    middle base changed."""
    rng = np.random.default_rng(seed)
    lut = np.zeros(256, np.int64)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    n = GMER_NODES
    ref = bases[rng.integers(0, len(bases) - K + 1, n)[:, None]
                + np.arange(K)]
    alt = ref.copy()
    alt[:, K // 2] = np.frombuffer(b"ACGT", np.uint8)[
        (lut[ref[:, K // 2]] + rng.integers(1, 4, n)) % 4]
    tab, nl = np.full((n, 1), 9, np.uint8), np.full((n, 1), 10, np.uint8)
    lines = np.concatenate([np.full((n, 1), ord("n"), np.uint8),
                            _digits(n, 7), tab, np.full((n, 1), ord("2"),
                                                        np.uint8),
                            tab, ref, tab, alt, nl], axis=1)
    lines.tofile(os.path.join(path, "db.txt"))


def write_gmer_reads(path: str, bases: np.ndarray, seed: int) -> int:
    """reads.fq: GMER_READ_BP bp reads drawn from ``bases`` at GMER_DEPTH,
    GMER_SUB of their bases changed to another base, half reverse
    complemented. Returns the number of reads."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    lut = np.zeros(256, np.int64)
    lut[alphabet] = np.arange(4)
    comp = np.zeros(256, np.uint8)
    comp[alphabet] = np.frombuffer(b"TGCA", np.uint8)
    L = GMER_READ_BP
    n = GMER_DEPTH * len(bases) // L
    seq = bases[rng.integers(0, len(bases) - L + 1, n)[:, None]
                + np.arange(L)]
    flat = seq.reshape(-1)
    at = rng.integers(0, flat.size, rng.binomial(flat.size, GMER_SUB))
    flat[at] = alphabet[(lut[flat[at]] + rng.integers(1, 4, len(at))) % 4]
    flip = rng.random(n) < 0.5
    seq[flip] = comp[seq[flip]][:, ::-1]

    def col(text: bytes):
        return np.tile(np.frombuffer(text, np.uint8), (n, 1))

    recs = np.concatenate([col(b"@r"), _digits(n, 7), col(b"\n"), seq,
                           col(b"\n+\n"), col(b"I" * L), col(b"\n")],
                          axis=1)
    recs.tofile(os.path.join(path, "reads.fq"))
    return n


def gmer_count_steps(torch, path: str) -> None:
    """The card route's stages, each to a synchronize, and one 2^25-base
    chunk's count step in both join directions (equal counts required)."""
    from genometester4_tpu_torch.formats.gmerdb import load_text_db
    from genometester4_tpu_torch.io.fasta import iter_code_slabs
    from genometester4_tpu_torch.ops.kmers import extract_kmers_best
    from genometester4_tpu_torch.ops.lookup import batched_bounds
    from genometester4_tpu_torch.pipelines.gmercount import (
        DBCounter, count_step, format_counts)

    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return value

    reads = os.path.join(path, "reads.fq")
    db = stage("parse the text database", lambda: load_text_db(
        os.path.join(path, "db.txt")))
    counter = stage("set-up (decode, sorted table to the card)",
                    lambda: DBCounter(db, device="cuda"))
    stage("reads (host parse, upload, the chunks on the card)",
          lambda: counter.add_file(reads))
    stage("finalize (the accumulator back)", counter.finalize)
    stage("format the counts", lambda: format_counts(
        db, counter.result.clamped(db.count_bits), False, False, True, 0,
        False, io.StringIO()))
    log("gmercount card route stages: " + "; ".join(
        f"{name} {t:.3f} s" for name, t in stages.items()))
    prof = cProfile.Profile()
    prof.runcall(load_text_db, os.path.join(path, "db.txt"))
    top = io.StringIO()
    pstats.Stats(prof, stream=top).sort_stats("tottime").print_stats(6)
    for line in top.getvalue().splitlines():
        if line.strip() and line.lstrip()[0].isdigit():
            log(f"  text database parse, cProfile by own time: "
                f"{' '.join(line.split())}")

    codes_np, _ = next(iter_code_slabs(reads, K))
    codes = torch.from_numpy(codes_np[:N_KERNEL].copy()).cuda()
    db_keys = counter._db_keys
    n = db_keys.numel()
    acc = torch.zeros(n, dtype=torch.int64, device="cuda")
    count_step(codes, K, db_keys, acc, False)
    hits = torch.zeros(n + 1, dtype=torch.int64, device="cuda")
    ones = torch.ones(codes.numel(), dtype=torch.int64, device="cuda")

    def windows_search_db():
        keys, _ = extract_kmers_best(codes, K)
        at = torch.searchsorted(db_keys, keys).clamp_(max=n - 1)
        hit = db_keys[at] == keys   # invalid keys carry the flag bit
        hits.index_add_(0, torch.where(hit, at, n), ones)

    windows_search_db()
    torch.cuda.synchronize()
    check(torch.equal(hits[:n], acc), "the two join directions disagree")
    keys, _ = extract_kmers_best(codes, K)
    skeys = torch.sort(keys).values
    ms = {
        "DB searches the sorted chunk (JAX's direction, the port's)":
            median_ms(torch, lambda: count_step(codes, K, db_keys, acc,
                                                False), 10),
        "  of which kernel A": median_ms(
            torch, lambda: extract_kmers_best(codes, K), 10),
        "  of which torch.sort": median_ms(
            torch, lambda: torch.sort(keys), 10),
        "  of which the two searches": median_ms(
            torch, lambda: batched_bounds(skeys, db_keys), 10),
        "windows search the DB (index_add_ of the hits)":
            median_ms(torch, windows_search_db, 10)}
    log(f"gmercount count step, one chunk of 2^25 codes, {n} DB words, "
        f"equal counts in both join directions: " + "; ".join(
            f"{name} {t:.4f} ms" for name, t in ms.items()))


def phase_gmercount(torch, path: str, bases: np.ndarray, seed: int) -> int:
    """gmer_counter's count mode through the port's CLI: the card route
    and the port's host route in turns, each against the JAX package's
    host route in a subprocess. Returns the card route's walls and the
    reference's stderr; the first card run's stdout stays in
    ``path``/GMER_COUNTS for phases 4e and 4f.b."""

    t0 = time.perf_counter()
    write_gmer_db(path, bases, seed)
    n_reads = write_gmer_reads(path, bases, seed)
    windows = n_reads * (GMER_READ_BP - K + 1)
    log(f"gmercount input: text database of {GMER_NODES} nodes x 2 "
        f"{K}-mers, {n_reads} FASTQ reads of {GMER_READ_BP} bp "
        f"({n_reads * GMER_READ_BP} bp, {windows} windows; seed {seed}) in "
        f"{time.perf_counter() - t0:.2f} s")
    args = ["-db", "db.txt", "reads.fq"]
    want, ref_wall = reference_cli(path, "gmer_counter", args,
                                   GT4_TPU_COUNT_IMPL="host")
    check(want.returncode == 0, f"JAX host-route gmer_counter failed: "
                                f"{want.stderr.decode(errors='replace')}")
    lines = want.stdout.count(b"\n")
    log(f"gmercount reference: JAX package host route in a subprocess, "
        f"main() wall {ref_wall:.3f} s ({windows / ref_wall / 1e6:.2f} M "
        f"windows/s), {lines} stdout lines")
    walls = {"card": [], "host": []}
    launches = None
    for route in ("card", "host", "host", "card"):
        trace.reset()
        torch.cuda.reset_peak_memory_stats()
        rc, out, err, wall = _port_gmer_counter(torch, path, args,
                                                route == "card")
        n_launch = trace.total("launch.extract")
        if launches is None:   # the main path's run
            launches = n_launch
            with open(os.path.join(path, GMER_COUNTS), "wb") as f:
                f.write(out)
        walls[route].append(wall)
        log(f"gmercount port {route} route: main() wall {wall:.3f} s "
            f"({windows / wall / 1e6:.2f} M windows/s), peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, kernel A "
            f"launches {n_launch}")
        check(rc == 0, f"port gmer_counter ({route} route) exited {rc}")
        check(out == want.stdout, f"port gmer_counter ({route} route) "
                                  f"stdout differs from the reference")
        check(err == want.stderr, f"port gmer_counter ({route} route) "
                                  f"stderr differs: {err[-500:]!r}")
        check((n_launch > 0) == (route == "card"),
              f"{route} route launched kernel A {n_launch} times")
    log(f"gmercount: stdout ({len(want.stdout)} bytes) of all four port runs "
        f"byte-identical to the JAX host route; in this process, in turns: "
        f"card route {walls['card'][0]:.3f} and {walls['card'][1]:.3f} s, "
        f"the port's host route {walls['host'][0]:.3f} and "
        f"{walls['host'][1]:.3f} s; kernel A launches on the gmercount path "
        f"{launches}")
    gmer_count_steps(torch, path)
    return {"walls": walls["card"], "stderr": want.stderr}


def _port_glistmaker(torch, path: str, args: list, card_route: bool):
    """The port's glistmaker CLI on its card route or, for ``--index``,
    its native host route (GT4_TPU_COUNT_IMPL=host)."""
    from genometester4_tpu_torch.cli.glistmaker import main
    return _port_main(torch, main, path, args, "GT4_TPU_COUNT_IMPL",
                      None if card_route else "host")


def _port_glistcompare(torch, path: str, args: list, card_route: bool):
    """The port's glistcompare CLI on its card route or its native host
    route (GT4_TPU_SETOPS_IMPL=host)."""
    from genometester4_tpu_torch.cli.glistcompare import main
    return _port_main(torch, main, path, args, "GT4_TPU_SETOPS_IMPL",
                      None if card_route else "host")


def _glist_reference(path: str, module: str, args: list, env: str):
    """The JAX CLI ``module`` on its host route (``env``=host) in a
    subprocess in ``path``; it must exit 0 (on a machine without jax this
    shows that the host route imports none)."""
    r, wall = reference_cli(path, module, args, **{env: "host"})
    check(r.returncode == 0, f"JAX host-route {module} {args} failed: "
                             f"{r.stderr.decode(errors='replace')[-2000:]}")
    return r, wall


def _check_same_run(what, got, want, files):
    """A port run's (rc, stdout, stderr) equal to the reference process's,
    and each (port file, reference file) pair byte-identical."""
    rc, out, err = got
    check(rc == 0, f"{what} exited {rc}: "
                   f"{err.decode(errors='replace')[-2000:]}")
    check(out == want.stdout, f"{what} stdout differs from the JAX host "
                              f"route's: {out[-300:]!r}")
    check(err == want.stderr, f"{what} stderr differs from the JAX host "
                              f"route's: {err[-300:]!r}")
    for mine, ref in files:
        check(same_file(mine, ref), f"{what}: {os.path.basename(mine)} "
                                    f"differs from the JAX host route's")


def phase_glist(torch, tmp: str, fa: str, genome_list: str) -> dict:
    """The port's glistmaker and glistcompare CLIs on CUDA (4c.a-4c.d),
    every output against the JAX CLI's host route in a subprocess. Returns
    kernel A's and B's launches in 4c.a and A's in 4c.b's first card
    run, and under "compare" 4c.c's argv, output, card walls and peaks and
    the files of its last card run (4f.a's reference). The reads' .list of
    4c.a stays in ``glist_port`` for phases 4d and 4f."""
    from genometester4_tpu_torch.pipelines import listcompare

    jd, pd = os.path.join(tmp, "glist_jax"), os.path.join(tmp, "glist_port")
    os.makedirs(jd)
    os.makedirs(pd)
    reads = os.path.join(tmp, "reads.fq")
    out = {}

    # 4c.a: .list mode on the genome, then on the reads (4c.c's input)
    for name, src in (("cli", fa), ("reads", reads)):
        args = [src, "-w", str(K), "-o", name]
        want, ref_wall = _glist_reference(jd, "glistmaker", args,
                                          "GT4_TPU_COUNT_IMPL")
        trace.reset()
        torch.cuda.reset_peak_memory_stats()
        rc, o, e, wall = _port_glistmaker(torch, pd, args, True)
        la = {"extract": trace.total("launch.extract"),
              "run_marks": trace.total("launch.run_encode")}
        mine = os.path.join(pd, f"{name}_{K}.list")
        ref = os.path.join(jd, f"{name}_{K}.list")
        _check_same_run(f"port glistmaker {name}", (rc, o, e), want,
                        [(mine, ref)])
        check(min(la.values()) > 0, f"glistmaker {name} launches {la}")
        if name == "cli":
            check(same_file(mine, genome_list),
                  "glistmaker's .list differs from phase 2's")
            out.update(la)
        log(f"glist 4c.a glistmaker {os.path.basename(src)} -w {K}: card "
            f"main() wall {wall:.3f} s, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
            f"{la}; JAX host route {ref_wall:.3f} s; .list "
            f"({os.path.getsize(mine)} bytes), stdout and stderr identical "
            f"to the JAX host route's"
            + ("; .list identical to phase 2's" if name == "cli" else ""))
        os.remove(ref)
        if name == "cli":
            os.remove(mine)
    reads_list = os.path.join(pd, f"reads_{K}.list")

    # 4c.b: --index, the card route and the port's host route in turns
    args = [fa, "-w", str(K), "-o", "idx", "--index"]
    want, ref_wall = _glist_reference(jd, "glistmaker", args,
                                      "GT4_TPU_COUNT_IMPL")
    ref_index = os.path.join(jd, f"idx_{K}.index")
    log(f"glist 4c.b reference: JAX host route --index main() wall "
        f"{ref_wall:.3f} s, {os.path.getsize(ref_index)} bytes")
    walls = {"card": [], "host": []}
    for route in ("card", "host", "host", "card"):
        trace.reset()
        torch.cuda.reset_peak_memory_stats()
        with trace.recording():
            rc, o, e, wall = _port_glistmaker(torch, pd, args,
                                              route == "card")
        n = trace.total("launch.extract")
        # the stages: the spans right under the run's "index" span
        rows = trace.rows()
        job = next(r.id for r in rows if r.name == "index")
        stages = {r.name: r.t1 - r.t0 for r in rows if r.parent == job}
        mine = os.path.join(pd, f"idx_{K}.index")
        _check_same_run(f"port glistmaker --index ({route} route)",
                        (rc, o, e), want, [(mine, ref_index)])
        check((n > 0) == (route == "card"),
              f"--index {route} route launched kernel A {n} times")
        if route == "card" and "index_extract" not in out:
            out["index_extract"] = n
        walls[route].append(wall)
        log(f"glist 4c.b port --index {route} route: main() wall "
            f"{wall:.3f} s, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"kernel A launches {n}; stages " + "; ".join(
                f"{k} {v:.3f} s" for k, v in stages.items())
            + "; .index identical to the JAX host route's")
        os.remove(mine)
    log(f"glist 4c.b: in turns, card route {walls['card'][0]:.3f} and "
        f"{walls['card'][1]:.3f} s, the port's host route "
        f"{walls['host'][0]:.3f} and {walls['host'][1]:.3f} s")

    # 4c.c: two lists, four outputs in one run, routes in turns
    args = [genome_list, reads_list, "-u", "-i", "-d", "-dd", "-o", "cmp"]
    want, ref_wall = _glist_reference(jd, "glistcompare", args,
                                      "GT4_TPU_SETOPS_IMPL")
    names = [f"cmp_{K}_union.list", f"cmp_{K}_intrsec.list",
             f"cmp_{K}_0_diff1.list", f"cmp_{K}_0_diff2.list"]
    sizes = {n: os.path.getsize(os.path.join(jd, n)) // 12 for n in names}
    log(f"glist 4c.c reference: JAX host route glistcompare -u -i -d -dd "
        f"main() wall {ref_wall:.3f} s; records {sizes}")
    walls = {"card": [], "host": []}
    peaks = []
    for i, route in enumerate(("card", "host", "host", "card")):
        torch.cuda.reset_peak_memory_stats()
        rc, o, e, wall = _port_glistcompare(torch, pd, args, route == "card")
        _check_same_run(f"port glistcompare ({route} route)", (rc, o, e),
                        want, [(os.path.join(pd, n), os.path.join(jd, n))
                               for n in names])
        walls[route].append(wall)
        if route == "card":
            peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        log(f"glist 4c.c port glistcompare {route} route: main() wall "
            f"{wall:.3f} s, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; four "
            f"files identical to the JAX host route's")
        if i < 3:   # the last card run's files stay for 4f.a
            for n in names:
                os.remove(os.path.join(pd, n))
    for n in names:
        os.remove(os.path.join(jd, n))
    out["compare"] = {"args": args, "files": [os.path.join(pd, n)
                                              for n in names],
                      "run": (want.stdout, want.stderr),
                      "walls": walls["card"], "peaks": peaks}
    log(f"glist 4c.c: in turns, card route {walls['card'][0]:.3f} and "
        f"{walls['card'][1]:.3f} s, the port's host route "
        f"{walls['host'][0]:.3f} and {walls['host'][1]:.3f} s")

    # 4c.d: three sources, one an .index: compare_multi on the card
    args = [genome_list, reads_list, ref_index, "-u", "-o", "multi"]
    want, ref_wall = _glist_reference(jd, "glistcompare", args,
                                      "GT4_TPU_SETOPS_IMPL")
    name = f"multi_{K}_union.list"
    compare_multi = listcompare.compare_multi
    calls = []

    def counted(*a, **kw):
        calls.append(kw.get("device"))
        return compare_multi(*a, **kw)
    listcompare.compare_multi = counted
    try:
        torch.cuda.reset_peak_memory_stats()
        rc, o, e, wall = _port_glistcompare(torch, pd, args, True)
    finally:
        listcompare.compare_multi = compare_multi
    _check_same_run("port glistcompare, three sources", (rc, o, e), want,
                    [(os.path.join(pd, name), os.path.join(jd, name))])
    check(calls == ["cuda"], f"compare_multi calls {calls}: the .index "
                             f"input did not reach the card route")
    log(f"glist 4c.d port glistcompare -u on two .lists and the .index: "
        f"compare_multi on the card, main() wall {wall:.3f} s, peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"({os.path.getsize(os.path.join(jd, name)) // 12} records); JAX "
        f"host route {ref_wall:.3f} s; union identical")
    for path in (os.path.join(pd, name), os.path.join(jd, name), ref_index):
        os.remove(path)
    return out


def _port_main_to_file(torch, main, path: str, args: list, env: str, value,
                       stdout_path: str):
    """``_port_main`` with stdout sent to the file ``stdout_path`` (whose
    ``buffer`` takes the native formatter's bytes); returns (rc, stderr
    bytes, wall s to a synchronize)."""
    err = io.StringIO()
    old = os.getcwd()
    os.chdir(path)
    try:
        with open(stdout_path, "w") as f:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with environ(env, value), contextlib.redirect_stdout(f), \
                    contextlib.redirect_stderr(err):
                rc = main(args, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        os.chdir(old)
    return rc, err.getvalue().encode(), wall


@contextlib.contextmanager
def stage_timer(torch, stages: dict, targets):
    """Within the block, each (owner, attribute, label) of ``targets`` is
    wrapped so that its calls add their time, to a synchronize, to
    ``stages[label]``; the attributes are restored after it. Nested
    targets count in both labels."""
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in
             targets]

    def timed(fn, label):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                stages[label] = (stages.get(label, 0.0)
                                 + time.perf_counter() - t0)
        return wrapper

    for (owner, name, fn), (_, _, label) in zip(saved, targets):
        setattr(owner, name, timed(fn, label))
    try:
        yield stages
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def _stage_text(stages: dict) -> str:
    return "; ".join(f"{k} {v:.3f} s" for k, v in stages.items())


def _check_same_output(what, rc, err, mine, ref):
    """A port run's rc and stderr equal to the reference's ``ref``
    (process, wall, stdout file), and its stdout file ``mine``
    byte-identical to the reference's."""
    r = ref[0]
    check(rc == r.returncode, f"{what} exited {rc}, the JAX host route "
                              f"{r.returncode}: {err.decode()[-1000:]}")
    check(err == r.stderr, f"{what} stderr differs from the JAX host "
                           f"route's: {err[-300:]!r} vs {r.stderr[-300:]!r}")
    check(same_file(mine, ref[2]),
          f"{what} stdout differs from the JAX host route's")


def _references(path: str, module: str, runs: dict, **env) -> dict:
    """The JAX CLI ``module`` on its host route, one subprocess per entry
    of ``runs`` (name -> argv), all at once; each stdout to
    ``ref_<name>.out`` in ``path``. Returns name -> (process, wall,
    stdout path); each must exit as the port is required to."""
    with concurrent.futures.ThreadPoolExecutor(len(runs)) as ex:
        jobs = {name: (ex.submit(reference_cli, path, module, args,
                                 os.path.join(path, f"ref_{name}.out"),
                                 **env),
                       os.path.join(path, f"ref_{name}.out"))
                for name, args in runs.items()}
        return {name: (*job.result(), out)
                for name, (job, out) in jobs.items()}


def phase_glistquery(torch, tmp: str, genome_list: str, reads_list: str,
                     reads_fq: str) -> int:
    """4d: the port's glistquery CLI on CUDA: -l of the reads' list
    against the genome's and -s of a QUERY_SEQ_BP slice of the reads, the
    card route and the host route (GT4_TPU_LINK=slow) in turns; --stat,
    --median, --distribution 1000 and --gc. Every stdout (a file), stderr
    and rc against the JAX CLI's host route in a subprocess. Returns
    kernel A's launches in the first -s card run."""
    from genometester4_tpu_torch.cli.glistquery import main
    from genometester4_tpu_torch.io import fasta
    from genometester4_tpu_torch.pipelines import listquery as lq

    # the card route's split (first card run of each): set-up, the work
    # on the card (nested: the emits inside -s's count there too), emits
    targets = [(lq.ListQuery, "_device_table", "table to the card"),
               (lq.ListQuery, "lookup_device", "lookups (keys up, counts "
                                               "back)"),
               (fasta, "load_file", "whole-file parse"),
               (lq, "_search_fasta_bulk_device", "kernel A, canonical, "
                                                 "lookups, copies, emits"),
               (lq, "_emit_records", "native record formatter and write")]
    qd = os.path.join(tmp, "glistquery")
    os.makedirs(qd)
    n_reads = QUERY_SEQ_BP // GMER_READ_BP
    slice_fq = os.path.join(qd, "reads_slice.fq")
    with open(reads_fq, "rb") as f, open(slice_fq, "wb") as g:
        g.writelines(itertools.islice(f, 4 * n_reads))
    windows = n_reads * (GMER_READ_BP - K + 1)
    runs = {"l": [genome_list, "-l", reads_list],
            "s": [genome_list, "-s", slice_fq]}
    stats = {"stat": ["--stat"], "median": ["--median"],
             "distribution": ["--distribution", "1000"], "gc": ["--gc"]}
    t0 = time.perf_counter()
    refs = _references(qd, "glistquery", {
        **runs, **{name: [genome_list, *flag] for name, flag in
                   stats.items()}})
    log(f"glistquery 4d reference: the JAX host route in {len(refs)} "
        f"subprocesses at once, {time.perf_counter() - t0:.3f} s; main() "
        f"walls " + "; ".join(f"{n} {r[1]:.3f} s" for n, r in refs.items())
        + f"; -l {os.path.getsize(refs['l'][2])} bytes, -s "
        f"{os.path.getsize(refs['s'][2])} bytes ({n_reads} reads, "
        f"{windows} windows) of stdout")
    launches = None
    for name, args in runs.items():
        walls = {"card": [], "host": []}
        for route in ("card", "host", "host", "card"):
            mine = os.path.join(qd, f"port_{name}.out")
            trace.reset()
            torch.cuda.reset_peak_memory_stats()
            split = route == "card" and not walls["card"]
            with (stage_timer(torch, {}, targets) if split
                  else contextlib.nullcontext({})) as stages:
                rc, err, wall = _port_main_to_file(
                    torch, main, qd, args, "GT4_TPU_LINK",
                    None if route == "card" else "slow", mine)
            n = trace.total("launch.extract")
            _check_same_output(f"port glistquery -{name} ({route} route)",
                               rc, err, mine, refs[name])
            if name == "s":
                check((n > 0) == (route == "card"),
                      f"-s {route} route launched kernel A {n} times")
                if launches is None:
                    launches = n
            walls[route].append(wall)
            log(f"glistquery 4d -{name} port {route} route: main() wall "
                f"{wall:.3f} s, peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
                f"kernel A launches {n}; stdout identical to the JAX host "
                f"route's" + (f"; stages {_stage_text(stages)}" if split
                              else ""))
            os.remove(mine)
        log(f"glistquery 4d -{name}: in turns, card route "
            f"{walls['card'][0]:.3f} and {walls['card'][1]:.3f} s, the "
            f"port's host route {walls['host'][0]:.3f} and "
            f"{walls['host'][1]:.3f} s; JAX host route {refs[name][1]:.3f} s"
            + (f" ({windows / min(walls['card']) / 1e6:.2f} M windows/s on "
               f"the card)" if name == "s" else ""))
    for name, flag in stats.items():
        mine = os.path.join(qd, f"port_{name}.out")
        rc, err, wall = _port_main_to_file(torch, main, qd,
                                           [genome_list, *flag],
                                           "GT4_TPU_LINK", None, mine)
        _check_same_output(f"port glistquery {' '.join(flag)}", rc, err,
                           mine, refs[name])
        with open(mine) as f:
            text = f.read()
        log(f"glistquery 4d {' '.join(flag)}: main() wall {wall:.3f} s "
            f"(JAX host route {refs[name][1]:.3f} s), identical; "
            f"{text.splitlines()[-1] if name != 'distribution' else str(text.count(chr(10))) + ' lines'}")
    shutil.rmtree(qd)
    return launches


def write_caller_markers(path: str, seed: int):
    """gmer_counter-style counts of CALLER_MARKERS (autosomal, X, Y)
    markers, the model of ``tests/test_gmercaller.synth_counts`` (a male:
    diploid autosomes, haploid X and Y; negative binomial counts as a
    Gamma-Poisson mixture at mean 30) drawn in bulk. Returns the
    autosomes' uint16 pairs, what gmer_caller's parse gives them."""
    rng = np.random.default_rng(seed)
    n_a, n_x, n_y = CALLER_MARKERS
    mean = 30

    def nb(m):
        return rng.poisson(rng.gamma(10, np.maximum(m, 1e-3) / 10))

    gt = rng.choice(3, n_a, p=[0.7, 0.25, 0.05])
    a = nb(np.choose(gt, [mean, mean / 2, 0.5]))
    b = nb(np.choose(gt, [0.5, mean / 2, mean]))
    chrom = rng.integers(1, 23, n_a)
    xa, xb = nb(np.full(n_x, mean / 2)), nb(np.full(n_x, 0.5))
    ya, yb = nb(np.full(n_y, mean / 2)), nb(np.full(n_y, 0.5))
    # FastGT's marker ids, CHR:POS:ID:REF/ALT (generate_vcf parses them)
    with open(os.path.join(path, "markers.txt"), "w") as f:
        f.write("".join(f"{c}:{1000 + i}:m{i}:A/G\t2\t{x}\t{y}\n"
                        for i, (c, x, y) in
                        enumerate(zip(chrom.tolist(), a.tolist(),
                                      b.tolist()))))
        for name, ca, cb in (("X", xa, xb), ("Y", ya, yb)):
            f.write("".join(f"{name}:{1000 + i}:{name}m{i}:C/T\t2\t{x}\t{y}"
                            "\n" for i, (x, y) in
                            enumerate(zip(ca.tolist(), cb.tolist()))))
    return np.stack([a, b], axis=1).astype(np.uint16)


def caller_batch_timing(torch, calls: np.ndarray) -> None:
    """The posterior batch alone on the full-model set's autosomes (the
    --runs 0 --coverage 30 parameters): the card route (host q table and
    prior, fan-out on the card, a[best], sum and best back) and the
    native batch (with the a[best] gather print_genotypes does), in turns;
    markers/s beside the bound: bytes on the card over 3.35 TB/s plus the
    bytes over the link over 64 GB/s."""
    from genometester4_tpu_torch.models import fastgt_native as native
    from genometester4_tpu_torch.models.genotype import (
        genotype_best_device, posterior_tables)
    from genometester4_tpu_torch.pipelines.gmercall import DEFAULT_PARAMS

    flat = np.ascontiguousarray(calls.reshape(-1))
    n = len(calls)
    params = DEFAULT_PARAMS.copy()
    params[4] = 30
    pB = native.allele_freq(flat)
    a, sums, best = native.genotype_batch(flat, pB, params)
    top, s2, b2 = genotype_best_device(flat, pB, params, "cuda")
    check(np.array_equal(top.view(np.uint64),
                         a[np.arange(n), best].view(np.uint64))
          and np.array_equal(s2.view(np.uint64), sums.view(np.uint64))
          and np.array_equal(b2, best),
          "the card's posterior batch differs from the native batch")

    def card():
        return genotype_best_device(flat, pB, params, "cuda")

    def host():
        a, sums, best = native.genotype_batch(flat, pB, params)
        return a[np.arange(n), best], sums, best

    walls = {"card": [], "host": []}
    for route in ("card", "host", "host", "card"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (card if route == "card" else host)()
        walls[route].append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    posterior_tables(flat, pB, params)
    table = time.perf_counter() - t0
    bound_s = (n * (4 + 20) / PEAK_BYTES) + n * (4 + 20) / LINK_BYTES
    log(f"gmercaller 4e posterior batch alone, {n} markers, equal bits to "
        f"the native batch: in turns card " + ", ".join(
            f"{t:.4f} s ({n / t / 1e6:.2f} M markers/s)"
            for t in walls["card"]) + "; native " + ", ".join(
            f"{t:.4f} s ({n / t / 1e6:.2f} M markers/s)"
            for t in walls["host"]) + f"; of the card's, the host q table "
        f"and prior {table:.4f} s; bound {bound_s * 1e3:.4f} ms "
        f"({n / bound_s / 1e6:.1f} M markers/s: 24 B a marker on the card "
        f"over 3.35 TB/s and over the link at 64 GB/s)")


def phase_gmercaller(torch, tmp: str, seed: int) -> None:
    """4e: the port's gmer_caller CLI on CUDA: FastGT's chain on phase
    4a's counts (--model diploid, a short training) and a full-model set,
    the card route and the host route (GT4_TPU_CALLER_IMPL=host) in turns,
    every stdout (a file), stderr and rc against the JAX CLI's host route,
    whose subprocesses run beside the port's runs; then the posterior
    batch alone. The full model's card stdout stays in ``tmp``/GMER_CALLS
    for 4f.d."""
    from genometester4_tpu_torch.cli.gmer_caller import main
    from genometester4_tpu_torch.models import fastgt_native, genotype
    from genometester4_tpu_torch.pipelines import gmercall

    targets = [(gmercall, "build_line_table", "line table"),
               (gmercall, "get_pair_median", "medians"),
               (gmercall, "parse_calls", "call parse"),
               (fastgt_native, "train_model", "training"),
               (genotype, "genotype_best_device", "posterior batch"),
               (genotype, "genotype_batch_device", "posterior batch"),
               (gmercall, "print_genotypes", "print (the batch inside)")]
    cd = os.path.join(tmp, "gmercaller")
    os.makedirs(cd)
    chain = os.path.join(tmp, GMER_COUNTS)
    t0 = time.perf_counter()
    calls = write_caller_markers(cd, seed)
    log(f"gmercaller 4e input: {GMER_NODES} nodes of phase 4a's counts; "
        f"{sum(CALLER_MARKERS)} synthetic markers {CALLER_MARKERS} "
        f"(autosomal, X, Y; seed {seed}) in {time.perf_counter() - t0:.2f} s")
    cases = {
        "chain": (["--model", "diploid", "--runs", "1", "--training_size",
                   str(CALLER_TRAINING), "--info", chain], 2),
        "full": (["--runs", "0", "--coverage", "30", "--info", "--header",
                  "markers.txt"], 2),
        "alternatives": (["--runs", "0", "--coverage", "30",
                          "--alternatives", "--prob_cutoff", "0.9",
                          "markers.txt"], 1)}
    with concurrent.futures.ThreadPoolExecutor(len(cases)) as ex:
        refs = {name: ex.submit(reference_cli, cd, "gmer_caller", args,
                                os.path.join(cd, f"ref_{name}.out"),
                                GT4_TPU_CALLER_IMPL="host")
                for name, (args, _) in cases.items()}
        for name, (args, n_runs) in cases.items():
            walls = []
            for route in ("card", "host")[:n_runs]:
                mine = os.path.join(cd, f"port_{name}.out")
                torch.cuda.reset_peak_memory_stats()
                with (stage_timer(torch, {}, targets) if route == "card"
                      else contextlib.nullcontext({})) as stages:
                    rc, err, wall = _port_main_to_file(
                        torch, main, cd, args, "GT4_TPU_CALLER_IMPL",
                        None if route == "card" else "host", mine)
                ref = (*refs[name].result(),
                       os.path.join(cd, f"ref_{name}.out"))
                _check_same_output(f"port gmer_caller {name} ({route} "
                                   f"route)", rc, err, mine, ref)
                with open(mine, "rb") as f:
                    lines = sum(chunk.count(b"\n") for chunk in
                                iter(lambda: f.read(1 << 24), b""))
                walls.append(wall)
                log(f"gmercaller 4e {name} port {route} route: main() wall "
                    f"{wall:.3f} s ({lines} lines, "
                    f"{lines / wall / 1e6:.3f} M lines/s), peak device "
                    f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
                    f" GiB; stdout identical to the JAX host route's "
                    f"(main() {ref[1]:.3f} s, run beside the port's)"
                    + (f"; stages {_stage_text(stages)}" if stages else ""))
                if (name, route) == ("full", "card"):
                    shutil.move(mine, os.path.join(tmp, GMER_CALLS))
                else:
                    os.remove(mine)
    caller_batch_timing(torch, calls)
    shutil.rmtree(cd)



def reference_cli(path: str, module: str, args: list, stdout_path=None,
                  func: str = "main", **env):
    """A CLI of the JAX package on its host route in a subprocess in
    ``path`` (``JAX_PLATFORMS=cpu``: its host routes import no jax): the
    read index's set-up and the reference output. Returns (the finished
    process, the wall of the CLI's ``main`` in s, or None if it raised).
    With ``stdout_path`` its stdout goes to that file (``stdout`` of the
    process is then None); ``func`` names the entry point (make_union's
    are ``main_union`` and ``main_intersection``). Safe to run from
    several threads at once."""
    fd, wall_file = tempfile.mkstemp(prefix=".main_wall", dir=path)
    os.close(fd)
    os.remove(wall_file)
    code = ("import sys, time\n"
            f"from genometester4_tpu.cli.{module} import {func} as main\n"
            "t = time.perf_counter()\n"
            "rc = main(sys.argv[2:])\n"
            "with open(sys.argv[1], 'w') as f:\n"
            "    f.write(repr(time.perf_counter() - t))\n"
            "sys.exit(rc)\n")
    repo = os.path.dirname(os.path.abspath(__file__))
    with contextlib.ExitStack() as stack:
        out = (stack.enter_context(open(stdout_path, "wb"))
               if stdout_path else subprocess.PIPE)
        r = subprocess.run(
            [sys.executable, "-c", code, wall_file, *args], cwd=path,
            stdout=out, stderr=subprocess.PIPE, timeout=900,
            env={**os.environ, "PYTHONPATH": repo, "JAX_PLATFORMS": "cpu",
                 **env})
    wall = None
    if os.path.exists(wall_file):
        with open(wall_file) as f:
            wall = float(f.read())
        os.remove(wall_file)
    return r, wall


def _port_main(torch, main, path: str, args: list, env: str, value):
    """A CLI ``main`` of the port in this process on CUDA, in ``path``,
    with the environment variable ``env`` set to ``value`` (unset for
    None); returns (rc, stdout bytes, stderr bytes, wall s to a
    synchronize)."""
    out, err = io.StringIO(), io.StringIO()
    old = os.getcwd()
    os.chdir(path)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with environ(env, value), contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = main(args, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        os.chdir(old)
    return rc, out.getvalue().encode(), err.getvalue().encode(), wall


def _port_gassembler(torch, path: str, args: list, device_route: bool):
    """The port's gassembler CLI on its device route (kernel C) or its host
    route (GT4_TPU_DEVICE_SW=0, the native C fill)."""
    from genometester4_tpu_torch.cli.gassembler import main as gassembler
    return _port_main(torch, gassembler, path, args, "GT4_TPU_DEVICE_SW",
                      None if device_route else "0")


def _port_gmer_counter(torch, path: str, args: list, card_route: bool):
    """The port's gmer_counter CLI on its card route (kernel A) or its
    native host route (GT4_TPU_COUNT_IMPL=host)."""
    from genometester4_tpu_torch.cli.gmer_counter import main as counter
    return _port_main(torch, counter, path, args, "GT4_TPU_COUNT_IMPL",
                      None if card_route else "host")


def same_file(a: str, b: str, block: int = 1 << 26) -> bool:
    """Byte equality of two files (a read index is 2 GiB), block by
    block."""
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x = fa.read(block)
            if x != fb.read(block):
                return False
            if not x:
                return True


def build_read_index(torch, path: str) -> str:
    """``db.idx`` in ``path`` from the port's gmer_counter --compile_index
    on CUDA (kernel A must launch), held byte for byte against the JAX
    package's host route building ``ref.idx`` in a subprocess; ref.idx is
    deleted after. Returns a log line."""
    from genometester4_tpu_torch.tools import katk_fixture as kf

    trace.reset()
    rc, out, err, wall = _port_gmer_counter(torch, path, kf.INDEX_ARGS, True)
    launches = trace.total("launch.extract")
    check(rc == 0, f"port gmer_counter --compile_index exited {rc}: "
                   f"{err.decode(errors='replace')[-2000:]}")
    check(launches > 0, "port gmer_counter --compile_index never launched "
                        "kernel A")
    ref_args = ["ref.idx" if a == "db.idx" else a for a in kf.INDEX_ARGS]
    r, ref_wall = reference_cli(path, "gmer_counter", ref_args,
                                GT4_TPU_COUNT_IMPL="host")
    check(r.returncode == 0, f"JAX gmer_counter --compile_index failed: "
                             f"{r.stderr.decode(errors='replace')[-2000:]}")
    check((out, err) == (r.stdout, r.stderr),
          "port gmer_counter --compile_index output differs from JAX's")
    ref = os.path.join(path, "ref.idx")
    same = same_file(os.path.join(path, "db.idx"), ref)
    size = os.path.getsize(ref)
    os.remove(ref)
    check(same, "the port's read index differs from the JAX host route's")
    return (f"read index by the port's gmer_counter --compile_index on CUDA "
            f"in {wall:.3f} s (kernel A launches {launches}; JAX host route "
            f"{ref_wall:.3f} s), {size} bytes identical to the JAX host "
            f"route's")


def phase_katk(torch, path: str, seed: int):
    """KATK gassembler on CUDA: the port's device route and its own host
    route in turns, each against the JAX package's host route. Returns
    (kernel C launches of the main path's run, the regions' SW inputs);
    that run's stdout stays in ``path``/KATK_CALLS for 4f.d."""
    from genometester4_tpu_torch.pipelines import gassemble as port_gas
    from genometester4_tpu_torch.tools import katk_fixture as kf

    inputs = kf.write_katk_fixture(path, seed)
    with open(os.path.join(path, "regions.txt")) as f:
        n_regions = sum(1 for _ in f)
    n_reads = sum(len(reads) for _, reads in inputs)
    log(f"katk input: {n_regions} regions ({kf.REGIONS} of "
        f"{kf.REGION_BP} bp + 1 oversized), {n_reads} reads of "
        f"{kf.READ_BP} bp (seed {seed}); "
        f"{build_read_index(torch, path)}")

    # warm-up of the reference: its native library build, page cache
    reference_cli(path, "gassembler", kf.ARGS + ["--max_regions", "8"],
                  GT4_TPU_DEVICE_SW="0")
    t0 = time.perf_counter()
    want, ref_wall = reference_cli(path, "gassembler", kf.ARGS,
                                   GT4_TPU_DEVICE_SW="0")
    process_wall = time.perf_counter() - t0
    check(want.returncode == 0, f"JAX host-route gassembler failed: "
                                f"{want.stderr.decode(errors='replace')}")
    lines = want.stdout.count(b"\n")
    log(f"katk reference: JAX package host route (native C SW) in a "
        f"subprocess, main() wall {ref_wall:.3f} s (the whole process "
        f"{process_wall:.3f} s), {lines} stdout lines")

    # warm-up of both port routes: CUDA context, allocator, pinned pool,
    # the port's native library build
    for route in (True, False):
        _port_gassembler(torch, path, kf.ARGS + ["--max_regions", "8"],
                         route)

    # the JAX window loop would gather cached regions again here: a
    # prefetch for an uncached (oversized) region with its successor cached
    cache_skips = 0
    prefetch = port_gas.Assembler.prefetch_device_sw

    def watched(self, regions, idx):
        nonlocal cache_skips
        if (idx + 1 < len(regions) and id(regions[idx]) not in self._sw_cache
                and id(regions[idx + 1]) in self._sw_cache):
            cache_skips += 1
        return prefetch(self, regions, idx)

    walls = {"device": [], "host": []}
    launches = None
    port_gas.Assembler.prefetch_device_sw = watched
    try:
        for route in ("device", "host", "host", "device"):
            trace.reset()
            torch.cuda.reset_peak_memory_stats()
            rc, out, err, wall = _port_gassembler(torch, path, kf.ARGS,
                                                  route == "device")
            n_launch = trace.total("launch.sw_lanes")
            if launches is None:   # the main path's run
                launches = n_launch
                with open(os.path.join(path, KATK_CALLS), "wb") as f:
                    f.write(out)
            walls[route].append(wall)
            log(f"katk port {route} route: main() wall {wall:.3f} s "
                f"({n_regions / wall:.1f} regions/s), peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
                f"kernel C launches {n_launch}")
            check(rc == 0, f"port gassembler ({route} route) exited {rc}")
            check(out == want.stdout, f"port gassembler ({route} route) "
                                      f"stdout differs from the reference")
            check(err == want.stderr,
                  f"port gassembler ({route} route) stderr differs from "
                  f"the reference: {err[-500:]!r} vs {want.stderr[-500:]!r}")
            check((n_launch > 0) == (route == "device"),
                  f"{route} route launched kernel C {n_launch} times")
    finally:
        port_gas.Assembler.prefetch_device_sw = prefetch
    log(f"katk: stdout ({len(want.stdout)} bytes) and stderr "
        f"({len(want.stderr)} bytes) of all four port runs byte-identical "
        f"to the JAX host route; in this process, in turns: device route "
        f"{walls['device'][0]:.3f} and {walls['device'][1]:.3f} s, the "
        f"port's host route {walls['host'][0]:.3f} and "
        f"{walls['host'][1]:.3f} s; prefetches past cached regions "
        f"{cache_skips}")
    check(0 < launches < n_regions, f"kernel C launches {launches} not in "
                                    f"1..{n_regions - 1}")
    check(cache_skips > 0, "the oversized region never followed a cached "
                           "window: the cache skip was not exercised")
    return launches, inputs


def phase_longread(torch, path: str, seed: int) -> int:
    """The port's gassembler CLI on CUDA over the long-read fixture with
    ``--max_read_length 1600``, against the JAX package's host route in a
    subprocess. Returns kernel C's launches in the port's run."""
    from genometester4_tpu_torch.tools import katk_fixture as kf

    n_reads = kf.write_long_read_fixture(path, seed)
    log(f"longread: {build_read_index(torch, path)}")
    t0 = time.perf_counter()
    want, ref_wall = reference_cli(path, "gassembler", kf.LONG_ARGS,
                                   GT4_TPU_DEVICE_SW="0")
    check(want.returncode == 0, f"JAX host-route gassembler failed: "
                                f"{want.stderr.decode(errors='replace')}")
    cut = want.stderr.count(b"WARNING: Read is longer")
    check(cut > 0, "no read was cut at --max_read_length")
    log(f"longread input: {kf.LONG_REGIONS} regions, {n_reads} reads of "
        f"{kf.LONG_READ_BP[0]}-{kf.LONG_READ_BP[1]} bp (seed {seed}), "
        f"{cut} cut at --max_read_length 1600; JAX host route "
        f"{time.perf_counter() - t0:.2f} s (its main() {ref_wall:.3f} s)")
    trace.reset()
    rc, out, err, wall = _port_gassembler(torch, path, kf.LONG_ARGS, True)
    launches = trace.total("launch.sw_lanes")
    log(f"longread port device route: main() wall {wall:.3f} s, kernel C "
        f"launches {launches}, stdout {len(out)} bytes, stderr {len(err)} "
        f"bytes")
    check(rc == 0, f"port gassembler exited {rc} on long reads")
    check(out == want.stdout, "port gassembler stdout differs from the "
                              "reference on long reads")
    check(err == want.stderr, f"port gassembler stderr differs from the "
                              f"reference on long reads: {err[-500:]!r}")
    check(launches > 0, "kernel C never launched on long reads")
    log("longread: stdout and stderr byte-identical to the JAX host route")
    return launches


def phase_shared(torch, inputs) -> int:
    """Kernel D's entry point over the reads of SHARED_REGIONS regions,
    each equal to kernel C's entry on the same input. Returns D's
    launches."""
    from genometester4_tpu_torch.ops.swalign_cuda import (
        sw_matrices_batch_device, sw_pallas_matrices)

    batch = inputs[2:2 + SHARED_REGIONS]
    trace.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = [sw_pallas_matrices(ref, reads, device="cuda")
           for ref, reads in batch]
    wall = time.perf_counter() - t0
    launches = trace.total("launch.sw_shared")
    n_reads = sum(len(reads) for _, reads in batch)
    log(f"shared path: sw_pallas_matrices (kernel D) over {len(batch)} "
        f"regions, {n_reads} reads, wall {wall:.3f} s, launches {launches}")
    check(launches == len(batch), "kernel D did not run once per region")
    for (ref, reads), mats in zip(batch, got):
        for a, b in zip(mats, sw_matrices_batch_device(ref, reads,
                                                       device="cuda")):
            check(a.dtype == b.dtype and np.array_equal(a, b),
                  "kernel D's entry differs from kernel C's")
    log("shared: every matrix equal to kernel C's entry")
    return launches


def _sw_case(rng, B, n, m, ragged):
    """Codes with 2% N; with ``ragged``, per-lane reference lengths and
    reads padded with 6 past a random length."""
    refs = rng.integers(0, 4, (B, n)).astype(np.int8)
    refs[rng.random((B, n)) < 0.02] = 4
    reads = rng.integers(0, 4, (B, m)).astype(np.int8)
    reads[rng.random((B, m)) < 0.02] = 4
    nvec = np.full(B, n, np.int32)
    if ragged:
        nvec = rng.integers(1, n + 1, B).astype(np.int32)
        mlen = rng.integers(max(1, m - 52), m + 1, B)
        reads[np.arange(m)[None, :] >= mlen[:, None]] = 6
    return refs, reads, nvec


def _sw_bound(name, lanes, B, n, m, nvec):
    """(bound ms, by) of a fill: the cells this run's reference lengths
    need; codes in, 4 B a cell out."""
    cells = int(np.minimum(np.maximum(nvec, 0), n).sum()) * m
    in_bytes = (B if lanes else 1) * n + B * m + (4 * B if lanes else 0)
    return bound(name, in_bytes + 4 * B * (n + 1) * (m + 1), cells)


def phase_sw_kernels(torch, seed: int) -> dict:
    """Kernels C and D against ``sw_fill`` on the card, at the shapes of
    their paths, on reads of 2,000 columns (eight 256-column slabs) and at
    a shape whose gap lengths wrap as int8."""
    from genometester4_tpu_torch.ops.swalign import sw_fill
    from genometester4_tpu_torch.ops.swalign_cuda import (
        sw_fill_lanes_cuda, sw_fill_shared_cuda)

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    res = {}

    def err_of(got, want):
        torch.cuda.synchronize()
        return max(max_abs_err(torch, a, b) for a, b in zip(got, want))

    for name, shape in (("sw_lanes", SW_LANES_SHAPE),
                        ("sw_shared", SW_SHARED_SHAPE),
                        ("sw_lanes", SW_WIDE_SHAPE),
                        ("sw_shared", SW_WIDE_SHAPE)):
        B, n, m = shape
        lanes = name == "sw_lanes"
        refs, reads, nvec = _sw_case(rng, B, n, m, ragged=lanes)
        refs_t, reads_t, nvec_t = (torch.from_numpy(a).to(dev)
                                   for a in (refs, reads, nvec))
        if lanes:
            def kernel():
                return sw_fill_lanes_cuda(refs_t, reads_t, nvec_t)
        else:
            ref_t = refs_t[0].contiguous()
            refs_t = ref_t.expand(B, -1)

            def kernel():
                return sw_fill_shared_cuda(ref_t, reads_t)

        def plain():
            return sw_fill(refs_t, reads_t, nvec_t)

        err = err_of(kernel(), plain())
        check(err == 0, f"{name} kernel != plain at {shape} (max abs err "
                        f"{err})")
        ms = median_ms(torch, kernel, 20)
        qms = batch_ms(torch, kernel)
        pms = median_ms(torch, plain, 3)
        bms, by = _sw_bound(name, lanes, B, n, m, nvec)
        log(f"kernel {name} B={B} n={n} m={m}: {ms:.4f} ms ({qms:.4f} ms "
            f"per call, 20 back to back)   plain {pms:.4f} ms   bound "
            f"{bms:.4f} ms ({by})   equal bits")
        if name in res:   # the wide shape: its error joins the row's
            res[name][0] = max(res[name][0], err)
        else:
            res[name] = [err, ms, pms, bms, by, None]

    # gaps past 127: the int8 wrap of gap lengths in sx and sy
    n = m = 300
    ref = rng.integers(0, 4, n).astype(np.int8)
    reads = np.stack([np.concatenate([ref[:140], rng.integers(0, 4, 160)]),
                      np.concatenate([rng.integers(0, 4, 10), ref[:150],
                                      rng.integers(0, 4, 140)])])
    reads = reads.astype(np.int8)
    ref_t = torch.from_numpy(ref).to(dev)
    reads_t = torch.from_numpy(reads).to(dev)
    refs_t = ref_t.expand(2, -1)
    nvec_t = torch.full((2,), n, dtype=torch.int32, device=dev)
    want = sw_fill(refs_t, reads_t, nvec_t)
    check(int(want[1].min()) == -128, "wrap case does not wrap")
    for name, got in (("sw_lanes", sw_fill_lanes_cuda(
            refs_t.contiguous(), reads_t, nvec_t)),
            ("sw_shared", sw_fill_shared_cuda(ref_t, reads_t))):
        err = err_of(got, want)
        check(err == 0, f"{name} kernel != plain where gap lengths wrap "
                        f"(max abs err {err})")
        res[name][0] = max(res[name][0], err)
    log("kernels sw_lanes and sw_shared: equal bits where gap lengths wrap "
        "(n = m = 300)")
    return res


@contextlib.contextmanager
def merge_passes(seen: dict):
    """Within the block, what ``make_list``'s merge does: each
    ``merge_sorted_shards`` call's number of shards in ``seen["shards"]``,
    and the entries of each weighted ``count_unique`` (one device pass of
    the merge, a bucket that more than one shard reaches) in
    ``seen["passes"]``; unweighted calls (a chunk's count) in
    ``seen["chunks"]``."""
    from genometester4_tpu_torch.pipelines import listmaker

    merge, count = listmaker.merge_sorted_shards, listmaker.count_unique
    seen.update(shards=[], passes=[], chunks=0)

    def merged(shards, *a, **kw):
        shards = list(shards)
        seen["shards"].append(sum(1 for w, _ in shards if len(w)))
        return merge(shards, *a, **kw)

    def counted(keys, weights=None, *a, **kw):
        if weights is None:
            seen["chunks"] += 1
        else:
            seen["passes"].append(keys.numel())
        return count(keys, weights, *a, **kw)
    listmaker.merge_sorted_shards = merged
    listmaker.count_unique = counted
    try:
        yield seen
    finally:
        listmaker.merge_sorted_shards = merge
        listmaker.count_unique = count


def _with(main, **kw):
    """A CLI ``main`` that ``_port_main`` can call, with ``kw`` added."""
    return lambda args, device: main(args, device=device, **kw)


def phase_mesh_compare(torch, tmp: str, compare: dict) -> None:
    """4f.a: 4c.c's glistcompare -u -i -d -dd through the mesh route
    (buckets of the target, at least one a slot, dealt over the slots) on
    MESH_COMPARE_SLOTS slots of the card; the four files must equal 4c.c's
    last card run's, and no device pass may hold more than the target + 2
    words."""
    from genometester4_tpu_torch.cli.glistcompare import main
    from genometester4_tpu_torch.ops import setops
    from genometester4_tpu_torch.parallel.sharding import make_mesh
    from genometester4_tpu_torch.pipelines import listcompare

    md = os.path.join(tmp, "glist_mesh")
    os.makedirs(md)
    mesh = make_mesh(devices=["cuda:0"] * MESH_COMPARE_SLOTS)
    cuts, passes = [], []
    bucket_cuts, align = listcompare.bucket_cuts, setops.pair_align

    def cut(words, target, n_min=1):
        cuts.append((target, n_min))
        return bucket_cuts(words, target, n_min)

    def aligned(k1, c1, k2, c2):
        passes.append(k1.numel() + k2.numel())
        return align(k1, c1, k2, c2)
    listcompare.bucket_cuts, setops.pair_align = cut, aligned
    try:
        torch.cuda.reset_peak_memory_stats()
        rc, o, e, wall = _port_main(torch, _with(main, mesh=mesh), md,
                                    compare["args"], "GT4_TPU_SETOPS_IMPL",
                                    None)
    finally:
        listcompare.bucket_cuts, setops.pair_align = bucket_cuts, align
    check((rc, o, e) == (0, *compare["run"]),
          f"mesh glistcompare exited {rc} or printed otherwise: {e[-300:]!r}")
    target = listcompare.DEFAULT_BUCKET
    check(cuts == [(target, MESH_COMPARE_SLOTS)],
          f"the mesh route's cuts {cuts}")
    check(len(passes) >= MESH_COMPARE_SLOTS and max(passes) <= target + 2,
          f"the mesh route's device passes {passes}, target {target}")
    for mine in compare["files"]:
        name = os.path.basename(mine)
        check(same_file(os.path.join(md, name), mine),
              f"mesh glistcompare: {name} differs from 4c.c's")
    log(f"glist 4f.a port glistcompare -u -i -d -dd on the mesh route "
        f"({MESH_COMPARE_SLOTS} slots of cuda:0; {len(passes)} device "
        f"passes of " + ", ".join(str(n) for n in passes) + f" words, "
        f"target {target}): four files identical to 4c.c's single-card "
        f"files; main() wall {wall:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (4c.c card "
        f"route " + ", ".join(f"{w:.3f}" for w in compare["walls"])
        + " s, peak " + ", ".join(f"{p:.2f}" for p in compare["peaks"])
        + " GiB)")
    shutil.rmtree(md)


def phase_mesh_count(torch, tmp: str, count: dict) -> int:
    """4f.b: 4a's gmer_counter count mode on MESH_COMPARE_SLOTS slots of
    the card; stdout and stderr must equal 4a's and kernel A launch once
    per chunk. Returns kernel A's launches."""
    from genometester4_tpu_torch.cli.gmer_counter import main
    from genometester4_tpu_torch.parallel.sharding import make_mesh
    from genometester4_tpu_torch.pipelines import gmercount

    mesh = make_mesh(devices=["cuda:0"] * MESH_COMPARE_SLOTS)
    chunks = []
    count_step = gmercount.count_step

    def counted(codes, *a):
        chunks.append(codes.numel())
        return count_step(codes, *a)
    gmercount.count_step = counted
    try:
        trace.reset()
        torch.cuda.reset_peak_memory_stats()
        rc, o, e, wall = _port_main(torch, _with(main, mesh=mesh), tmp,
                                    ["-db", "db.txt", "reads.fq"],
                                    "GT4_TPU_COUNT_IMPL", None)
    finally:
        gmercount.count_step = count_step
    launches = trace.total("launch.extract")
    with open(os.path.join(tmp, GMER_COUNTS), "rb") as f:
        want = f.read()
    check((rc, e) == (0, count["stderr"]),
          f"mesh gmer_counter exited {rc} or its stderr differs: {e!r}")
    check(o == want, "mesh gmer_counter stdout differs from 4a's")
    check(launches == len(chunks) >= MESH_COMPARE_SLOTS,
          f"kernel A launches {launches} for {len(chunks)} chunks")
    log(f"gmercount 4f.b port gmer_counter on the mesh route "
        f"({MESH_COMPARE_SLOTS} slots of cuda:0, {len(chunks)} chunks dealt "
        f"round-robin): stdout identical to 4a's; kernel A launches "
        f"{launches}; main() wall {wall:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (4a card "
        f"route " + ", ".join(f"{w:.3f}" for w in count["walls"]) + " s)")
    return launches


GROUP_PROCS = 2   # 4g: processes of the group, all on the one card


def _group(tool: str, argv: list, cwd: str):
    """4g: GROUP_PROCS processes of the port's ``tool`` CLI on CUDA as one
    group (``tools.group_run.launch``, GT4_DIST_* on a free loopback
    port). Returns the processes' (rc, stdout, stderr, report) and the
    group's wall in s, process start included."""
    from genometester4_tpu_torch.tools.group_run import launch
    t0 = time.perf_counter()
    res = launch([{"tool": tool, "argv": argv}] * GROUP_PROCS,
                 [cwd] * GROUP_PROCS, timeout=600, dist_timeout=300)
    wall = time.perf_counter() - t0
    for rank, (rc, out, err, rep) in enumerate(res):
        check(rc == 0 and rep is not None,
              f"4g {tool} process {rank} exited {rc}: {err[-2000:]}")
        check(rank == 0 or out == b"",
              f"4g {tool} process {rank} printed {len(out)} bytes")
    return res, wall


def _group_log(what: str, res, wall: float, single: list) -> None:
    mains = ", ".join(f"{rep['wall']:.3f}" for *_, rep in res)
    log(f"group 4g.{what}: {GROUP_PROCS} processes on cuda:0, transport "
        f"{res[0][3]['transport']}; group wall {wall:.3f} s (process "
        f"start included), main() walls by process {mains} s; one process "
        f"on the card " + ", ".join(f"{w:.3f}" for w in single) + " s; "
        f"exchange by process (wall s, of it staging s, bytes) "
        + "; ".join(f"{rep['exchange']['s']:.3f}, "
                    f"{rep['exchange']['stage_s']:.3f}, "
                    f"{rep['exchange']['bytes']}" for *_, rep in res)
        + "; launches by process "
        + "; ".join(str(rep["launches"]) for *_, rep in res))


def phase_group(tmp: str, fa: str, genome_list: str, single_wall: float,
                compare: dict, count: dict) -> None:
    """4g: glistmaker, glistcompare and gmer_counter on a group of
    GROUP_PROCS processes sharing the one card (gloo, staged through
    pinned memory: NCCL refuses two processes on one card), on phase 2's
    FASTA, 4c.c's lists and 4a's database and reads; process 0's files
    and stdout must equal phases 2, 4c.c and 4a's, the others print and
    write nothing, and each process launches kernel A (and B in
    glistmaker). One card serves both, so no speed-up is expected, and
    none is claimed."""
    t0 = time.perf_counter()
    gd = os.path.join(tmp, "group")
    os.makedirs(gd)
    # a: glistmaker on the genome, one 2^25-base chunk a process
    res, wall = _group("glistmaker", [fa, "-w", str(K), "-o", "grp"], gd)
    mine = os.path.join(gd, f"grp_{K}.list")
    check(sorted(os.listdir(gd)) == [f"grp_{K}.list"],
          f"4g glistmaker wrote {os.listdir(gd)}")
    check(same_file(mine, genome_list),
          "4g glistmaker's .list differs from phase 2's")
    for *_, rep in res:
        check(rep["launches"]["extract"] > 0
              and rep["launches"]["run_marks"] > 0,
              f"4g glistmaker launches {rep['launches']}")
        check(rep["transport"] == "gloo", f"4g transport {rep['transport']}")
    os.remove(mine)
    _group_log("a glistmaker -w 25 (.list identical to phase 2's)", res,
               wall, [single_wall])
    # b: glistcompare -u -i -d -dd on 4c.c's lists, 4 parts over 2 slots
    res, wall = _group("glistcompare", compare["args"], gd)
    check(res[0][1] == compare["run"][0],
          "4g glistcompare stdout differs from 4c.c's")
    for want in compare["files"]:
        got = os.path.join(gd, os.path.basename(want))
        check(same_file(got, want),
              f"4g glistcompare: {os.path.basename(want)} differs")
    check(len(os.listdir(gd)) == len(compare["files"]),
          f"4g glistcompare wrote {os.listdir(gd)}")
    shutil.rmtree(gd)
    _group_log("b glistcompare -u -i -d -dd (four files identical to "
               "4c.c's)", res, wall, compare["walls"])
    # c: gmer_counter count mode on 4a's database and reads
    res, wall = _group("gmer_counter", ["-db", "db.txt", "reads.fq"], tmp)
    with open(os.path.join(tmp, GMER_COUNTS), "rb") as f:
        check(res[0][1] == f.read(), "4g gmer_counter stdout differs from "
                                     "4a's")
    for *_, rep in res:
        check(rep["launches"]["extract"] > 0,
              f"4g gmer_counter launches {rep['launches']}")
    _group_log("c gmer_counter (stdout identical to 4a's)", res, wall,
               count["walls"])
    log(f"group 4g: {time.perf_counter() - t0:.1f} s in all; two processes "
        f"share one card here, so no speed-up is expected or claimed")


def _tree(path: str) -> dict:
    """Every file under ``path`` by its relative name -> its size."""
    out = {}
    for root, _, files in os.walk(path):
        for name in files:
            full = os.path.join(root, name)
            out[os.path.relpath(full, path)] = os.path.getsize(full)
    return out


def phase_extra_clis(torch, tmp: str, genome_list: str,
                     reads_list: str) -> None:
    """4f.c and 4f.d's generate_vcf: make_union and make_intersection over
    four lists (the genome's, the reads', and the lists of the two halves
    of the reads by record, made by the port's glistmaker on the card) on
    the card, and generate_vcf on 4e's full-model calls, each against the
    JAX CLI (make_union on its host route) in a subprocess, the three run
    beside the port's runs; rc, stdout, stderr and every file equal."""
    from genometester4_tpu_torch.cli import generate_vcf, make_union

    ud = os.path.join(tmp, "extra")
    inputs = os.path.join(ud, "in")
    os.makedirs(inputs)
    reads = os.path.join(tmp, "reads.fq")
    with open(reads, "rb") as f:
        data = f.read()
    rec = data.index(b"\n@") + 1   # every record has the same length
    half = len(data) // rec // 2 * rec
    lists = [genome_list, reads_list]
    for name, part in (("h1", data[:half]), ("h2", data[half:])):
        with open(os.path.join(inputs, f"{name}.fq"), "wb") as f:
            f.write(part)
        rc, _, e, _ = _port_glistmaker(torch, inputs, [f"{name}.fq", "-w",
                                                       str(K), "-o", name],
                                       True)
        check(rc == 0, f"glistmaker on the reads' half {name} exited {rc}")
        lists.append(os.path.join(inputs, f"{name}_{K}.list"))
    del data
    # name: (the port's entry, the JAX module and entry, argv)
    runs = {"make_union": (make_union.main_union, "main_union", lists),
            "make_intersection": (make_union.main_intersection,
                                  "main_intersection", lists),
            "generate_vcf": (lambda a, device: generate_vcf.main(a), "main",
                             [os.path.join(tmp, GMER_CALLS)])}
    with concurrent.futures.ThreadPoolExecutor(len(runs)) as ex:
        refs = {}
        for name, (_, func, args) in runs.items():
            os.makedirs(os.path.join(ud, f"jax_{name}"))
            refs[name] = ex.submit(
                reference_cli, os.path.join(ud, f"jax_{name}"),
                "generate_vcf" if name == "generate_vcf" else "make_union",
                args, None, func, GT4_TPU_SETOPS_IMPL="host")
        for name, (fn, _, args) in runs.items():
            pd, jd = (os.path.join(ud, f"{side}_{name}")
                      for side in ("port", "jax"))
            os.makedirs(pd)
            rc, o, e, wall = _port_main(torch, fn, pd, args,
                                        "GT4_TPU_SETOPS_IMPL", None)
            r, ref_wall = refs[name].result()
            check((rc, o, e) == (r.returncode, r.stdout, r.stderr)
                  and rc == 0, f"port {name} exited {rc} (JAX "
                               f"{r.returncode}) or printed otherwise: "
                               f"{e[-300:]!r}")
            tree = _tree(pd)
            check(tree == _tree(jd), f"{name}: the files differ: {tree} vs "
                                     f"{_tree(jd)}")
            for f in tree:
                check(same_file(os.path.join(pd, f), os.path.join(jd, f)),
                      f"{name}: {f} differs from the JAX CLI's")
            lines = o.count(b"\n")
            log(f"4f.{'d' if name == 'generate_vcf' else 'c'} port {name} "
                + (f"on 4e's calls: {lines} lines of stdout"
                   if name == "generate_vcf" else
                   f"over 4 lists on the card: {len(tree)} files "
                   f"({sum(tree.values())} bytes)")
                + ", rc, stdout and stderr identical to the JAX CLI's"
                + ("" if name == "generate_vcf" else " (on its host route)")
                + f"; main() wall {wall:.3f} s (JAX {ref_wall:.3f} s, run "
                f"beside it)")
            shutil.rmtree(pd)
            shutil.rmtree(jd)
    shutil.rmtree(ud)


def phase_katk2vcf(torch, path: str) -> None:
    """4f.d: the port's katk2vcf on phase 4's gassembler calls against the
    JAX CLI in a subprocess: rc, stdout and stderr equal."""
    from genometester4_tpu_torch.cli import katk2vcf

    args = ["--chr_dir", "chr", KATK_CALLS]
    r, ref_wall = reference_cli(path, "katk2vcf", args)
    rc, o, e, wall = _port_main(torch, lambda a, device: katk2vcf.main(a),
                                path, args, "GT4_TPU_COUNT_IMPL", None)
    check((rc, o, e) == (r.returncode, r.stdout, r.stderr) and rc == 0,
          f"port katk2vcf exited {rc} (JAX {r.returncode}) or printed "
          f"otherwise: {e[-300:]!r}")
    lines = o.count(b"\n")
    log(f"4f.d port katk2vcf on phase 4's calls: {lines} lines "
        f"of stdout, rc, stdout and stderr identical to the JAX CLI's; "
        f"main() wall {wall:.3f} s (JAX {ref_wall:.3f} s)")


def run(args) -> None:
    t_start = time.perf_counter()
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    try:
        from genometester4_tpu_torch.ops import _build
        from genometester4_tpu_torch.pipelines.listmaker import (
            DEFAULT_MERGE_BUCKET, make_list)
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
        for mode in ("resort", "bitonic"):
            with environ("GT4_TPU_MESH_MERGE", mode):
                make_list([warm], K, os.path.join(tmp, "warm.list"),
                          device="cuda", mesh=mesh_slots())

        # 2. main path
        t0 = time.perf_counter()
        bases = genome_bases(args.seed, GENOME_BP)
        fa = os.path.join(tmp, "genome.fa")
        write_fasta(fa, bases)
        log(f"input: {GENOME_BP} bp genome-shaped FASTA (seed {args.seed}) in "
            f"{time.perf_counter() - t0:.2f} s")
        out = os.path.join(tmp, f"port_{K}.list")
        trace.reset()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with merge_passes({}) as merges:
            hdr = make_list([fa], K, out, device="cuda", debug=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"extract": trace.total("launch.extract"),
                    "run_marks": trace.total("launch.run_encode")}
        log(f"main path: make_list {GENOME_BP} bp seed {args.seed} k={K} "
            f"wall {wall:.3f} s, {hdr.total_count} k-mers ({hdr.total_count / wall / 1e6:.2f} "
            f"M k-mers/s), {hdr.n_words} distinct, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"launches {launches}")
        for name, n in launches.items():
            check(n > 0, f"main path never launched the {name} kernel")
        check(len(merges["shards"]) == 1,
              f"make_list merged {len(merges['shards'])} times")
        n_shards, sizes = merges["shards"][0], merges["passes"]
        target = DEFAULT_MERGE_BUCKET
        log(f"main path merge: {n_shards} shards of {merges['chunks']} "
            f"chunks, {sum(sizes)} entries in {len(sizes)} device passes "
            f"(rank buckets, target {target}): "
            + ", ".join(str(n) for n in sizes))
        check(len(sizes) > 1 and max(sizes) <= target + n_shards,
              f"merge passes {sizes} for {n_shards} shards, target "
              f"{target}")
        check(launches["run_marks"] == merges["chunks"] + len(sizes),
              f"kernel B launched {launches['run_marks']} times for "
              f"{merges['chunks']} chunks and {len(sizes)} merge passes")

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

        # 3b. mesh: the mesh counting route in both merge modes
        mesh_launches = phase_mesh(torch, fa, tmp, out, wall)
        launches["merge_runs"] = mesh_launches["merge_runs"]

        # 4a. gmercount: gmer_counter's count mode on the same genome
        count = phase_gmercount(torch, tmp, bases, args.seed)

        # 4c. glist: the glistmaker and glistcompare CLIs on the genome,
        # 4a's reads and the genome's .index
        glist = phase_glist(torch, tmp, fa, out)
        log(f"glist: kernel launches in 4c.a (the genome) and 4c.b (the "
            f"first card --index run) "
            f"{ {k: v for k, v in glist.items() if k != 'compare'} }")
        del bases

        # 4d. glistquery on the genome's list, 4c's reads' list and a
        # slice of 4a's reads
        reads_list = os.path.join(tmp, "glist_port", f"reads_{K}.list")
        n = phase_glistquery(torch, tmp, out, reads_list,
                             os.path.join(tmp, "reads.fq"))
        log(f"glistquery: kernel A launches in the first -s card run {n}")

        # 4e. gmer_caller on 4a's counts and a full-model marker set
        phase_gmercaller(torch, tmp, args.seed)

        # 4f. the mesh routes of glistcompare and gmer_counter on slots of
        # the card, make_union/make_intersection and generate_vcf
        phase_mesh_compare(torch, tmp, glist["compare"])
        phase_mesh_count(torch, tmp, count)
        phase_extra_clis(torch, tmp, out, reads_list)

        # 4g. glistmaker, glistcompare and gmer_counter on a process group
        phase_group(tmp, fa, out, wall, glist["compare"], count)

    with tempfile.TemporaryDirectory(prefix="gt4_chip_smoke_katk_") as tmp:
        # 4. katk: gassembler's region alignment through kernel C
        launches["sw_lanes"], inputs = phase_katk(torch, tmp, args.seed)
        # 4f.d: katk2vcf on its calls
        phase_katk2vcf(torch, tmp)

    with tempfile.TemporaryDirectory(prefix="gt4_chip_smoke_long_") as tmp:
        # 4b. longread: kernel C on reads past one 256-column slab
        phase_longread(torch, tmp, args.seed)

    # 5. kernel D's own path
    launches["sw_shared"] = phase_shared(torch, inputs)

    # 6. kernels against their plain versions
    res = phase_kernels(torch, args.seed)
    res.update(phase_sw_kernels(torch, args.seed))
    res["merge_runs"] = phase_merge_kernel(torch, args.seed)

    log(f"smoke: phases 1-6, 4f and 4g in "
        f"{time.perf_counter() - t_start:.1f} s")

    # 7. card identity
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
             "genometester4_tpu/ops/runmarks_pallas.py:32"),
            ("sw_lanes", "genometester4_tpu_torch/csrc/swalign.cu",
             "genometester4_tpu/ops/swalign_pallas.py:182"),
            ("sw_shared", "genometester4_tpu_torch/csrc/swalign.cu",
             "genometester4_tpu/ops/swalign_pallas.py:46"),
            ("merge_runs", "genometester4_tpu_torch/csrc/merge_runs.cu",
             "genometester4_tpu/ops/bitonic_merge_pallas.py:47")):
        err, ms, pms, bms, by, lms = res[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "ms": round(ms, 4),
                     "plain_ms": round(pms, 4), "bound_ms": round(bms, 4),
                     "bound_by": by,
                     "library_ms": None if lms is None else round(lms, 4)})
    check(not [m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "genometester4_tpu")],
          "jax or the JAX package was imported")
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
