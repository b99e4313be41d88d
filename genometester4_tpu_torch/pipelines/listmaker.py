"""glistmaker's device counting route: FASTA/FASTQ -> sorted ``.list``.

Port of the device branch of ``genometester4_tpu/pipelines/listmaker.py``
(``count_chunks``, ``merge_sorted_shards``, ``make_list``)::

  host slab parse                  genometester4_tpu.io.fasta (reused)
  -> 2^25-base code chunks         pad_pow2_chunk
  -> extract + canonicalize        kernel A (ops.extract_cuda)
  -> sort int64 keys               torch.sort
  -> run head/tail marks           kernel B (ops.runmarks_cuda)
  -> compact on the device         keys[head], counts from nonzero(tail)
  -> host prefix-bucketed merge    weighted count_unique per bucket
  -> ListWriter                    genometester4_tpu.formats (reused)

Output bytes are identical to the JAX package's. Not ported here: the
host-native route and its cost model (``device`` is explicit instead),
the multi-device mesh, multihost counting and ``make_index``.
"""

from __future__ import annotations

import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

from genometester4_tpu.formats.list_format import (ListHeader, ListWriter,
                                                   read_list, write_list)
from genometester4_tpu.io.fasta import iter_code_slabs
from genometester4_tpu_torch.ops.encode import keys_from_u64, u64_from_keys
from genometester4_tpu_torch.ops.kmers import extract_kmers_best
from genometester4_tpu_torch.ops.sortcount import count_unique
from genometester4_tpu_torch.utils.device import resolve_device

# 2^25 bases per chunk: ~1 GB of device memory per chunk (codes, int64
# keys, sort scratch), the same chunking as the JAX package so both
# produce the same shard boundaries.
DEFAULT_CHUNK_BASES = 1 << 25
# Target number of entries merged on the device at once.
DEFAULT_MERGE_BUCKET = 1 << 25


def pad_pow2_chunk(chunk: np.ndarray, cap_limit: int) -> np.ndarray:
    """Pad a chunk with invalid bytes up to the next power of two (at
    least 1024, at most ``cap_limit``), so that the CUDA caching allocator
    sees a handful of sizes instead of one per input length."""
    cap = 1 << max(10, math.ceil(math.log2(max(len(chunk), 2))))
    cap = min(cap, cap_limit)
    if len(chunk) < cap:
        chunk = np.concatenate(
            [chunk, np.full(cap - len(chunk), 255, np.uint8)])
    return chunk


def _compact(skeys, head, tail):
    """Run words and tail positions of a marked stream, on the device."""
    return skeys[head], torch.nonzero(tail).flatten()


def _to_host_counts(counts: torch.Tensor) -> np.ndarray:
    # values are < 2^32; the int32 cast keeps their bits and halves the copy
    return counts.to(torch.int32).cpu().numpy().view(np.uint32)


def count_chunks(codes: np.ndarray, k: int,
                 chunk_bases: int = DEFAULT_CHUNK_BASES,
                 canonical: bool = True, device=None):
    """Yield per-chunk sorted unique (words u64, counts u32) numpy arrays.

    ``codes`` is the uint8 code array from the parser. Chunks overlap by
    k-1 bases so no window is lost at a seam; the extraction marks the
    trailing k-1 windows of every chunk invalid, so each window is counted
    in exactly one chunk.
    """
    dev = resolve_device(device)
    n = len(codes)
    step = chunk_bases - (k - 1)
    if n <= k - 1:
        return
    for start in range(0, max(n - (k - 1), 1), step):
        chunk = pad_pow2_chunk(codes[start:start + chunk_bases], chunk_bases)
        keys, valid = extract_kmers_best(
            torch.from_numpy(chunk).to(dev), k, canonical)
        if valid is not None:   # k = 32: no flag bit, drop invalid keys
            keys = keys[valid]
        skeys, head, tail, _, n_unique = count_unique(keys, word_bits=2 * k)
        if n_unique == 0:
            continue
        words, tails = _compact(skeys, head, tail)
        # unit weights: a run's count is the distance between its tail
        # and the previous run's tail
        counts = torch.diff(tails + 1, prepend=tails.new_zeros(1))
        yield u64_from_keys(words), _to_host_counts(counts)


def merge_sorted_shards(shards, target_bucket: int = DEFAULT_MERGE_BUCKET,
                        device=None):
    """Merge sorted (words, counts) shards into one global sorted stream.

    The u64 word space is cut into equal prefix buckets, sized so each
    bucket's input fits the device at once; every shard is split at the
    same boundaries on the host, each bucket is merged with the weighted
    ``count_unique`` on the device, and the sorted buckets are yielded in
    ascending order. Counts add with u32 wrap-around like the reference's
    counters.
    """
    dev = resolve_device(device)
    shards = [s for s in shards if len(s[0])]
    if not shards:
        return
    total = sum(len(w) for w, _ in shards)
    n_buckets = 1 << max(0, math.ceil(math.log2(max(1, total / target_bucket))))
    # bucket b owns words in [b, b+1) * 2^64 / n_buckets
    if n_buckets > 1:
        bounds = (np.arange(1, n_buckets, dtype=np.uint64)
                  * np.uint64(2 ** 64 // n_buckets))
    else:
        bounds = np.empty(0, dtype=np.uint64)
    splits = [np.searchsorted(w, bounds) for w, _ in shards]
    for b in range(n_buckets):
        parts_w, parts_c = [], []
        for (w, c), sp in zip(shards, splits):
            a = 0 if b == 0 else sp[b - 1]
            z = len(w) if b == n_buckets - 1 else sp[b]
            if z > a:
                parts_w.append(w[a:z])
                parts_c.append(c[a:z])
        if not parts_w:
            continue
        if len(parts_w) == 1:
            # single source: already sorted and unique
            yield np.asarray(parts_w[0]), np.asarray(parts_c[0])
            continue
        keys = keys_from_u64(np.concatenate(parts_w)).to(dev)
        weights = torch.from_numpy(
            np.concatenate(parts_c).astype(np.int64)).to(dev)
        skeys, head, tail, incl, _ = count_unique(keys, weights)
        words, tails = _compact(skeys, head, tail)
        tp = incl[tails]
        counts = torch.diff(tp, prepend=tp.new_zeros(1)) & 0xFFFFFFFF
        yield u64_from_keys(words), _to_host_counts(counts)


def _print_phase_debug(hdr, n_words_in, t_parse, t_count, t_write):
    """-D phase accounting in the JAX package's format (after the
    reference's token accumulators, src/glistmaker.c:355-359): Read =
    slab parse, Sort = the device count, Write tmp = merge + final write."""
    sys.stderr.write("Words %d, unique %d\n"
                     % (hdr.total_count, hdr.n_words))
    for phase, nw, dt in (("Read", n_words_in, t_parse),
                          ("Sort", n_words_in, t_count),
                          ("Write tmp", hdr.n_words, t_write)):
        rate = int(nw / dt) & 0xFFFFFFFF if dt > 0 else 0
        sys.stderr.write("%s %d words at %.2f (%d words/s)\n"
                         % (phase, nw, dt, rate))


def make_list(input_files, word_length: int, output_path: str,
              min_count: int = 1, max_count: int = 0xFFFFFFFF,
              chunk_bases: int = DEFAULT_CHUNK_BASES,
              canonical: bool = True, debug: int = 0,
              spill_bytes: int | None = None,
              slab_bytes: int = 1 << 28, device=None) -> ListHeader:
    """Full glistmaker run: files -> .list at ``output_path``.

    ``device``: ``None`` or ``"cuda"`` runs the CUDA kernels, ``"cpu"``
    their plain PyTorch versions; there is no automatic fallback.
    ``debug`` > 0 prints per-phase counters to stderr. ``spill_bytes``
    (default 6 GiB, env GT4_SPILL_BYTES) is the in-RAM budget of counted
    shards before they spill to tmp .list files (dir GT4_TPU_TMPDIR)
    that the merge then reads as mmaps. ``min_count``/``max_count`` are
    the -c/--max cutoffs, applied after the merge.
    """
    dev = resolve_device(device)
    if spill_bytes is None:
        spill_bytes = int(os.environ.get("GT4_SPILL_BYTES", 6 << 30))
    tmpdir = os.environ.get("GT4_TPU_TMPDIR") or None
    t_parse = t_count = 0.0
    n_words_in = 0
    shards = []
    ram_bytes = 0
    tmp_files = []

    def spill(shards):
        nonlocal ram_bytes
        out = []
        for w, c in shards:
            if isinstance(w, np.memmap) or len(w) == 0:
                out.append((w, c))
                continue
            fd, tmp = tempfile.mkstemp(suffix=".list", dir=tmpdir)
            os.close(fd)
            write_list(tmp, word_length, w, c)
            tmp_files.append(tmp)
            _, mw, mc = read_list(tmp, mmap=True)
            out.append((mw, mc))
        ram_bytes = 0
        return out

    try:
        for path in input_files:
            slabs = iter_code_slabs(path, word_length, slab_bytes)
            while True:
                t0 = time.time()
                item = next(slabs, None)
                t_parse += time.time() - t0
                if item is None:
                    break
                codes, meta = item
                t0 = time.time()
                for w, c in count_chunks(codes, word_length, chunk_bases,
                                         canonical, dev):
                    shards.append((w, c))
                    ram_bytes += w.nbytes + c.nbytes
                    if ram_bytes > spill_bytes:
                        shards = spill(shards)
                t_count += time.time() - t0
                n_words_in += max(0, meta.total_bases - (word_length - 1)
                                  * meta.n_records)
        t_merge0 = time.time()
        cut = min_count > 1 or max_count != 0xFFFFFFFF
        with ListWriter(output_path, word_length) as w:
            for words, counts in merge_sorted_shards(shards, device=dev):
                if cut:
                    keep = counts >= np.uint32(min_count)
                    if max_count != 0xFFFFFFFF:
                        keep &= counts <= np.uint32(max_count)
                    words, counts = words[keep], counts[keep]
                w.append(words, counts)
        hdr = ListHeader(word_length, w.n_words, w.total_count)
        if debug:
            _print_phase_debug(hdr, n_words_in, t_parse, t_count,
                               time.time() - t_merge0)
    finally:
        for tmp in tmp_files:
            try:
                os.unlink(tmp)
            except OSError:
                pass
    return hdr
