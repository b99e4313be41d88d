"""gmer_counter: count DB k-mers in sequencing reads, and build KATK's read
index (``--compile_index``). Port of
``genometester4_tpu/pipelines/gmercount.py``.

Reference pipeline (src/gmer_counter.c:625-872): the FASTA reader emits
canonical words into 10 Mi-word tables; worker threads walk the trie per
word and bump the flat count table. Count mode here, per 2^25-base
chunk::

  host slab parse                  io.fasta.iter_code_slabs
  -> chunk up through pinned memory, padded as pad_pow2_chunk
  -> canonical windows             kernel A (ops.kmers.extract_kmers_best)
  -> sort the int64 keys           torch.sort
  -> each DB word's lower and      ops.lookup.batched_bounds
     upper bound in the sorted
     window stream
  -> acc += upper - lower          int64 accumulator of DB size, on the
                                   device; read back once, in finalize

The DB's words search the chunk, as in JAX (``gmercount.py:74-116``):
the searches are as many as the DB's words, not the windows. For k <= 31
an invalid window carries flag bit 2k and sorts past every DB word; for
k = 32 it carries the word 0, so the invalid windows of a chunk are taken
off the DB word 0's count on the device (no compaction, no host sync).

On a mesh (``DBCounter(mesh=...)``, or by default with more than one
CUDA card and GT4_TPU_MESH != 0, as in JAX), count mode deals the chunks
round-robin over the mesh's slots: each runs ``count_step`` on its
slot's device, against that device's copy of the DB's keys and into that
device's accumulator; ``finalize`` sums the accumulators on slot 0's
device (JAX's per-round ``psum``, ``gmercount.py:119-162``, once at the
end). Index mode stays on one device, as in JAX. In a process group
(GT4_DIST_*, ``parallel.multihost``) count mode takes the group's mesh
instead, over the host route too: chunk g goes to global slot g mod
(dp * kp), each process counts its own, and ``finalize`` sums the count
vector (and ``--stats``' valid windows) over the group, JAX's one psum;
index mode stays per process.

Index mode, per chunk: kernel A's forward windows, their canonical words
(``ops.encode.canonical``), ``dir = canonical != forward``, the lookup of
each window in the sorted DB (``ops.lookup.batched_lookup``), and the
hits' (code, position, dir) compacted in stream order
(``ops.sortcount.sort_compact``) and copied to the host, where the record
mapping, the decode and ``build_read_index`` run as in JAX.

Routes: the device route runs on ``device`` (CUDA when None; ``"cpu"``
runs every step's plain PyTorch version, which is what the CPU tests
compare with JAX). ``GT4_TPU_COUNT_IMPL=host`` takes the native host
route instead (extract + radix sort + a merge of the two sorted streams
in count mode, ``fgx_index_hits`` in index mode), as JAX has it. The JAX
package's placement cost model (``auto``) is not ported.

Count semantics match the reference: per-occurrence increments clamp at
65535 (16-bit) or 2^32-1 (src/gmer_counter.c:790-795) — with pure
increments that equals min(total, limit), so totals accumulate in u64
and clamp at the end. A code that decodes outside the node/kmer tables
makes the reference print a "DB inconsistency" error; we reproduce the
message.
"""

from __future__ import annotations

import ctypes
import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from genometester4_tpu_torch.formats.gmerdb import GmerDB
from genometester4_tpu_torch.ops.encode import SIGN, flag_key, keys_from_u64
from genometester4_tpu_torch.ops.kmers import extract_kmers_best
from genometester4_tpu_torch.ops.lookup import batched_bounds, batched_lookup
from genometester4_tpu_torch.ops.sortcount import sort_compact
from genometester4_tpu_torch.parallel import multihost
from genometester4_tpu_torch.pipelines.listmaker import (forward_windows,
                                                         pow2_cap)
from genometester4_tpu_torch.utils import trace
from genometester4_tpu_torch.utils.device import resolve_device
from genometester4_tpu_torch.utils.native import get_lib

# 2^25-base chunks, as the JAX package and make_list: ~1 GB of device
# memory per chunk (codes, int64 keys, sort scratch)
DEFAULT_CHUNK_BASES = 1 << 25


@dataclass
class CountStats:
    """--stats accumulators (src/gmer_counter.c:69-80,292-302)."""
    n_seq: int = 0          # nucleotides + Ns
    n_nucl: int = 0         # valid ACGTU
    n_gc: int = 0           # C/G among valid
    n_kmers_total: int = 0  # canonical words emitted
    n_kmers: int = 0        # words that hit the DB
    n_kmer_gc: int = 0      # G+C bases inside hit words


@dataclass
class CountResult:
    counts: np.ndarray                      # u64[n_kmers] unclamped totals
    stats: CountStats = field(default_factory=CountStats)

    def clamped(self, count_bits: int) -> np.ndarray:
        limit = np.uint64(65535 if count_bits == 16 else 0xFFFFFFFF)
        return np.minimum(self.counts, limit)


def count_step(codes: torch.Tensor, k: int, db_keys: torch.Tensor,
               acc: torch.Tensor, zero_word: bool):
    """One chunk of count mode on the device of ``codes`` (uint8, 255 =
    invalid): ``acc[i]`` (int64, one per DB key) grows by the number of
    valid windows whose canonical word is ``db_keys[i]``. ``zero_word``:
    the DB's first key is the word 0. Returns the chunk's number of valid
    windows as a device tensor (reading it is the caller's sync)."""
    keys, valid = extract_kmers_best(codes, k, canonical=True)
    skeys = torch.sort(keys).values
    lower, upper = batched_bounds(skeys, db_keys)
    acc += upper - lower
    if valid is None:   # k <= 31: the invalid keys sort last, flagged
        return torch.searchsorted(skeys, flag_key(2 * k))
    n_valid = valid.sum()
    if zero_word:       # k = 32: the invalid windows counted as word 0
        acc[:1] -= valid.numel() - n_valid
    return n_valid


def index_step(codes: torch.Tensor, k: int, db_keys: torch.Tensor,
               db_codes: torch.Tensor):
    """One chunk of index mode on the device of ``codes``: the DB hits of
    the valid windows in stream order, as (n_hit, code [n_hit] of
    ``db_codes``' dtype, window position int64 [n_hit], is reverse
    complement bool [n_hit], n_valid device tensor)."""
    # dir = canonical word != forward word (src/gmer_counter.c:911)
    can, is_rc, valid = forward_windows(codes, k)
    found, code, _ = batched_lookup(db_keys, db_codes, can ^ SIGN)
    pos = torch.arange(codes.numel(), device=codes.device)
    n_hit, hcode, hpos, hdir = sort_compact(found & valid, code, pos, is_rc)
    return n_hit, hcode, hpos, hdir, valid.sum()


class DBCounter:
    """Accumulates DB k-mer counts across files/chunks.

    With ``build_index=True`` every hit's (code, record, position,
    direction) is also collected — the data for --compile_index
    (src/gmer_counter.c:523-623). ``device``: where the device route runs
    (None: CUDA); unused on the host route (``GT4_TPU_COUNT_IMPL=host``).
    ``mesh``: a ``parallel.sharding.Mesh`` whose slots count mode's chunks
    go to in turn (an accumulator a device, summed on slot 0's device by
    ``finalize``); by default ``make_mesh()``
    with more than one CUDA card, unless GT4_TPU_MESH=0. Index mode runs
    on ``device`` alone.
    """

    def __init__(self, db: GmerDB, chunk_bases: int = DEFAULT_CHUNK_BASES,
                 collect_stats: bool = False, build_index: bool = False,
                 device=None, mesh=None):
        self.db = db
        self.chunk_bases = chunk_bases
        self.collect_stats = collect_stats
        self.build_index = build_index
        # per-hit arrays in stream order, one entry per add_file
        self.hits: list[dict] = []
        self.result = CountResult(np.zeros(db.n_kmers, np.uint64))
        n = len(db.sorted_words)
        self._finalized = False
        # unique DB word -> flat slot via the reference's code decode
        # (garbage summed codes of duplicate k-mers decode out of range
        # and are dropped with the reference's stderr message)
        node, kmer, ok = db.decode(db.sorted_codes)
        self._slot_ok = ok
        self._slot_of_unique = np.zeros(n, np.int64)
        self._slot_of_unique[ok] = db.flat_slot(node[ok], kmer[ok])
        # a process group overrides the host route in count mode
        group = (not build_index and mesh is None
                 and multihost.is_multiprocess())
        self._host = (os.environ.get("GT4_TPU_COUNT_IMPL") == "host"
                      and not group)
        self._grouped = False
        if self._host:
            # the native kernels read the sorted DB from host memory
            self._hw = np.ascontiguousarray(db.sorted_words, np.uint64)
            if build_index:
                self._hc = np.ascontiguousarray(db.sorted_codes, np.uint32)
                self._hit_bufs = None
            else:
                self._host_acc = np.zeros(n, np.uint64)
        else:
            self._dev = resolve_device(device)
            self._slots = [self._dev]
            if not build_index:
                if group:
                    mesh = multihost.group_mesh(self._dev)
                elif mesh is None:
                    from genometester4_tpu_torch.pipelines.listmaker import \
                        _default_mesh
                    mesh = _default_mesh(self._dev, True)
                if mesh is not None:
                    # another process's slots are None
                    self._grouped = mesh.rank is not None
                    self._slots = mesh.slots
                    self._dev = next(d for d in self._slots if d is not None)
            self._db_keys = keys_from_u64(db.sorted_words).to(self._dev)
            if build_index:
                # u32 codes as their int32 bit patterns
                self._db_codes = torch.from_numpy(
                    np.ascontiguousarray(db.sorted_codes, np.uint32)
                    .view(np.int32)).to(self._dev)
            else:
                # per device of the slots: the DB's keys, an accumulator
                self._keys = {d: self._db_keys.to(d) for d in self._slots
                              if d is not None}
                self._accs = {d: torch.zeros(n, dtype=torch.int64, device=d)
                              for d in self._keys}
                self._next_slot = 0
                self._zero_word = bool(n) and int(db.sorted_words[0]) == 0
            self._pinned = None
            # per CUDA device one event, recorded after each copy out of
            # the pinned buffer; the last one recorded guards its reuse
            self._upload_done = {}
            self._last_upload = None
        # per-slot GC counts for --stats. Bug-compat: the reference
        # re-reads the UNSHIFTED word every loop iteration
        # (src/gmer_counter.c:798-803 redeclares `word` inside the loop),
        # so its "GC count" is wordsize x (last base is G or C).
        if collect_stats:
            w = db.kmer_words
            self._slot_gc = (np.uint64(db.wordsize)
                             * ((w ^ (w >> np.uint64(1))) & np.uint64(1)))

    def _upload(self, chunk: np.ndarray, dev: torch.device) -> torch.Tensor:
        """One chunk on ``dev``, padded with invalid bytes to ``pow2_cap``;
        on CUDA through a pinned host buffer, reused once the previous
        chunk's copy out of it has finished. The span "upload", and
        "upload_wait" for the wait on that copy."""
        with trace.span("upload"):
            cap = pow2_cap(len(chunk), self.chunk_bases)
            trace.count("count.slots", cap)
            trace.count("count.pad", cap - len(chunk))
            if dev.type != "cuda":
                out = torch.full((cap,), 255, dtype=torch.uint8)
                out[:len(chunk)] = torch.from_numpy(chunk)
                return out.to(dev)
            if self._last_upload is not None:
                with trace.span("upload_wait", wait=True):
                    self._last_upload.synchronize()
            if self._pinned is None or self._pinned.numel() < cap:
                self._pinned = torch.empty(cap, dtype=torch.uint8,
                                           pin_memory=True)
            host = self._pinned[:cap].numpy()
            host[:len(chunk)] = chunk
            host[len(chunk):] = 255
            out = self._pinned[:cap].to(dev, non_blocking=True)
            if dev not in self._upload_done:
                self._upload_done[dev] = torch.cuda.Event()
            self._last_upload = self._upload_done[dev]
            self._last_upload.record(torch.cuda.current_stream(dev))
            return out

    def _idx_lookup(self, chunk_codes: np.ndarray):
        """One chunk's (hcode, hpos, hdir, n_valid) as numpy, host or
        device per route: the span "index_lookup". Host positions are
        already chunk-local window starts, identical to the device
        route's."""
        with trace.span("index_lookup"):
            return self._idx_lookup_chunk(chunk_codes)

    def _idx_lookup_chunk(self, chunk_codes: np.ndarray):
        if self._host:
            codes = np.ascontiguousarray(chunk_codes, np.uint8)
            n = len(codes)
            cap = max(n - self.db.wordsize + 1, 1)
            bufs = self._hit_bufs
            if bufs is None or len(bufs[0]) < cap:
                bufs = (np.empty(cap, np.uint32), np.empty(cap, np.int64),
                        np.empty(cap, np.uint8))
                self._hit_bufs = bufs
            hcode, hpos, hdir = bufs
            nv = ctypes.c_longlong(0)
            # past ~4M DB words the table is DRAM-resident and the
            # software-pipelined batched search wins (identical hit
            # stream); below, the plain rolling loop
            # (native/listkernel.c fgx_index_hits_batched comment)
            lib = get_lib()
            fn = (lib.fgx_index_hits_batched
                  if len(self._hw) >= (1 << 22) else lib.fgx_index_hits)
            m = fn(codes, n, self.db.wordsize, self._hw, self._hc,
                   len(self._hw), hcode, hpos, hdir, ctypes.byref(nv))
            return (hcode[:m].copy(), hpos[:m].copy(), hdir[:m].copy(),
                    int(nv.value))
        chunk = self._upload(chunk_codes, self._dev)
        # the compaction reads its hit count back: the host waits there
        with trace.span("sync", wait=True):
            n_hit, hcode, hpos, hdir, n_valid = index_step(
                chunk, self.db.wordsize, self._db_keys, self._db_codes)
        with trace.span("copyback", wait=True):
            return (hcode.cpu().numpy().view(np.uint32), hpos.cpu().numpy(),
                    hdir.to(torch.uint8).cpu().numpy(), int(n_valid))

    def add_file(self, path: str, slab_bytes: int = 1 << 28):
        """Count (or, with ``build_index``, collect the hits of) one read
        file: the job span "count_file"."""
        with trace.span("count_file"):
            self._add_file(path, slab_bytes)

    def _add_file(self, path: str, slab_bytes: int):
        if self.build_index:
            self._add_file_indexed(path, slab_bytes)
            return
        # count mode streams: peak RAM O(slab), matching the reference's
        # block-at-a-time read pipeline (src/gmer_counter.c:713-748)
        from genometester4_tpu_torch.io.fasta import iter_code_slabs
        for codes, meta in iter_code_slabs(path, self.db.wordsize,
                                           slab_bytes):
            if self.collect_stats:
                st = self.result.stats
                fresh = codes[meta.prefix_len:]
                new_nucl = int((fresh < 4).sum())
                st.n_nucl += new_nucl
                st.n_gc += int(((fresh == 1) | (fresh == 2)).sum())
                st.n_seq += new_nucl + meta.count_n  # nucleotides + Ns
            self._add_codes(codes)

    def _chunk_hits(self, codes: np.ndarray):
        """Index-mode hits of one slab's codes over its chunks: (code,
        slab position, dir) concatenated, or None without a window."""
        k = self.db.wordsize
        n = len(codes)
        if n < k:
            return None
        c_l, p_l, d_l = [], [], []
        step = self.chunk_bases - (k - 1)
        for start in range(0, max(n - (k - 1), 1), step):
            hcode, hpos, hdir, n_valid = self._idx_lookup(
                codes[start:start + self.chunk_bases])
            c_l.append(hcode)
            p_l.append(hpos + start)
            d_l.append(hdir)
            if self.collect_stats:
                self.result.stats.n_kmers_total += n_valid
        return (np.concatenate(c_l), np.concatenate(p_l),
                np.concatenate(d_l))

    def _add_file_indexed(self, path: str, slab_bytes: int):
        """Index-mode ingestion of one FASTA or FASTQ file in bounded
        memory: each slab's hits are mapped to (record, position in the
        record, record name offset) through the record/position maps of
        ``iter_slabs_indexed`` in the span "index_hits". A hit in a record
        started in an earlier slab lies in the record open at the seam.
        ``--stats``' n_seq grows by a FASTQ file's nucleotides and Ns; for
        FASTA it is SET to n_nucl + this file's N count, the reference's
        whole-file behavior."""
        from genometester4_tpu_torch.io.fasta import iter_slabs_indexed

        file_idx = len(self.hits)
        rec_l, lpos_l, code_l, dir_l, npos_l = [], [], [], [], []
        open_name = np.zeros(1, np.int64)  # name offset of the open record
        file_nucl = file_count_n = 0
        for codes, meta in iter_slabs_indexed(path, self.db.wordsize,
                                              slab_bytes):
            if codes is None:
                break
            file_count_n += meta.count_n
            if self.collect_stats:
                st = self.result.stats
                fresh = codes[meta.prefix_len:]
                new_nucl = int((fresh < 4).sum())
                file_nucl += new_nucl
                st.n_nucl += new_nucl
                st.n_gc += int(((fresh == 1) | (fresh == 2)).sum())
            names = np.concatenate([open_name, meta.name_spans[:, 0]])
            open_name = names[-1:]
            hits = self._chunk_hits(codes)
            if hits is None:
                continue
            with trace.span("index_hits"):
                hcode, spos, hdir = hits
                seg = np.searchsorted(meta.seg_starts, spos,
                                      side="right") - 1
                rec = meta.seg_rec[seg]
                rec_l.append(rec)
                lpos_l.append(spos - meta.seg_starts[seg]
                              + meta.seg_lpos0[seg])
                code_l.append(hcode)
                dir_l.append(hdir)
                npos_l.append(names[rec - meta.rec_base + 1])
        if self.collect_stats:
            st = self.result.stats
            if meta.fmt == "fastq":
                st.n_seq += file_nucl + file_count_n
            else:
                st.n_seq = st.n_nucl + file_count_n
        self._add_hits(file_idx, code_l, rec_l, lpos_l, dir_l, npos_l)

    def _add_hits(self, file_idx, code_l, rec_l, lpos_l, dir_l, npos_l):
        """Decode one file's hits to flat slots, count them, and keep the
        file's hit table for build_read_index (the span "index_hits").
        kmer_pos counts printable sequence characters (N included) and the
        Read bitfield truncates it to 18 bits (src/database.h:56-60);
        name_pos is the absolute byte offset of the record name
        (src/fasta.c:141,188)."""
        with trace.span("index_hits"):
            self._add_file_hits(file_idx, code_l, rec_l, lpos_l, dir_l,
                                npos_l)

    def _add_file_hits(self, file_idx, code_l, rec_l, lpos_l, dir_l,
                       npos_l):
        code_a = (np.concatenate(code_l) if code_l
                  else np.empty(0, np.uint32))
        rec = (np.concatenate(rec_l) if rec_l else np.empty(0, np.int64))
        kmer_pos = ((np.concatenate(lpos_l) if lpos_l
                     else np.empty(0, np.int64)) & 0x3FFFF)
        dirs = (np.concatenate(dir_l) if dir_l else np.empty(0, np.uint8))
        name_pos = (np.concatenate(npos_l) if npos_l
                    else np.empty(0, np.int64))
        node, kmer, ok = self.db.decode(code_a)
        if not ok.all():
            sys.stderr.write("DB inconsistency: invalid code in index mode\n")
            rec, kmer_pos, dirs = rec[ok], kmer_pos[ok], dirs[ok]
            name_pos = name_pos[ok]
            node, kmer = node[ok], kmer[ok]
        slots = self.db.flat_slot(node, kmer)
        np.add.at(self.result.counts, slots, 1)
        if self.collect_stats:
            st = self.result.stats
            st.n_kmers += len(slots)
            st.n_kmer_gc += int(self._slot_gc[slots].sum())
        self.hits.append(dict(file_idx=file_idx, slot=slots,
                              subseq=rec.astype(np.int64),
                              kmer_pos=kmer_pos.astype(np.int64),
                              name_pos=name_pos,
                              dir=dirs.astype(np.uint64)))

    def _add_codes(self, codes: np.ndarray):
        k = self.db.wordsize
        n = len(codes)
        if n < k:
            return
        if self._host:
            from genometester4_tpu_torch.utils.backend import \
                disable_numpy_thp
            disable_numpy_thp()
            lib = get_lib()
            buf = np.empty(n, np.uint64)
            m = lib.fgx_extract_canonical(np.ascontiguousarray(codes), n,
                                          k, buf)
            if self.collect_stats:
                self.result.stats.n_kmers_total += int(m)
            if not m:
                return
            words = np.ascontiguousarray(buf[:m])
            if lib.fgx_sort_u64(words, m, 2 * k) != 0:
                raise MemoryError("sort scratch allocation failed")
            # both sides sorted: one streaming dual-pointer merge pass
            lib.fgx_sorted_occurrences(words, m, self._hw, len(self._hw),
                                       self._host_acc)
            return
        step = self.chunk_bases - (k - 1)
        for start in range(0, max(n - (k - 1), 1), step):
            dev = self._slots[self._next_slot]
            self._next_slot = (self._next_slot + 1) % len(self._slots)
            if dev is None:   # another process's chunk
                continue
            with trace.span("count"):
                chunk = self._upload(codes[start:start + self.chunk_bases],
                                     dev)
                with trace.span("launch"):
                    n_valid = count_step(chunk, k, self._keys[dev],
                                         self._accs[dev], self._zero_word)
                if self.collect_stats:
                    with trace.span("sync", wait=True):
                        self.result.stats.n_kmers_total += int(n_valid)

    def finalize(self):
        """Pull the accumulator and fold it into per-slot totals: the job
        span "finalize", its copy back and its host "fold" inside."""
        if self._finalized:
            return
        self._finalized = True
        if self.build_index:
            return
        with trace.span("finalize"):
            self._finalize()

    def _finalize(self):
        if self._host:
            totals = self._host_acc
        else:
            # the accumulators summed on one card (and over the group),
            # then copied back
            with trace.span("copyback", wait=True):
                total = sum(acc.to(self._dev) for acc in self._accs.values())
                if self._grouped:   # JAX's psum, and its global n_valid
                    multihost.all_sum_(total)
                    if self.collect_stats:
                        st = self.result.stats
                        n = torch.tensor([st.n_kmers_total])
                        multihost.all_sum_(n)
                        st.n_kmers_total = int(n)
                if total.device.type != "cpu":
                    trace.count("copy.d2h_bytes", total.numel() * 8)
                totals = total.cpu().numpy().view(np.uint64)
        with trace.span("fold"):
            ok = self._slot_ok
            if not ok.all() and totals[~ok].any():
                sys.stderr.write(
                    "DB inconsistency: Node index is bigger than the "
                    "number of nodes\n")
            np.add.at(self.result.counts, self._slot_of_unique[ok],
                      totals[ok])
            if self.collect_stats:
                st = self.result.stats
                st.n_kmers += int(totals[ok].sum())
                st.n_kmer_gc += int((self._slot_gc[self._slot_of_unique[ok]]
                                     * totals[ok]).sum())


def _index_nbits(maxval: int) -> int:
    """src/gmer_counter.c:587-603: nbits=1; while (max > 1) {nbits++;
    max/=2;}"""
    nbits = 1
    while maxval > 1:
        nbits += 1
        maxval //= 2
    return nbits


def build_read_index(db: GmerDB, counter: DBCounter, file_names: list[str]):
    """Assemble the KATK read index from collected hits
    (src/gmer_counter.c:523-623).

    Per-k-mer read lists come out in REVERSE encounter order because the
    reference prepends to singly-linked ReadLists
    (src/gmer_counter.c:805-810), and FILES are encountered in reverse
    argv order because equal-priority tasks push onto the queue head
    (src/queue.c:158-160) — so within a k-mer: file_idx ascending,
    stream position descending. Byte-identity versus the reference holds
    for --num_threads 1 (multi-threaded runs interleave blocks
    nondeterministically).
    """
    from genometester4_tpu_torch.formats.read_index import ReadIndex

    def cat(key, dtype):
        return (np.concatenate([h[key] for h in counter.hits])
                if counter.hits else np.empty(0, dtype))

    slot = cat("slot", np.int64)
    subseq = cat("subseq", np.int64)
    kmer_pos = cat("kmer_pos", np.int64)
    name_pos = cat("name_pos", np.int64)
    dirs = cat("dir", np.uint64)
    gidx = (np.concatenate([np.arange(len(h["slot"]), dtype=np.int64)
                            for h in counter.hits])
            if counter.hits else np.empty(0, np.int64))
    file_idx = (np.concatenate([np.full(len(h["slot"]), h["file_idx"],
                                        np.uint64) for h in counter.hits])
                if counter.hits else np.empty(0, np.uint64))

    nbits_file = _index_nbits(len(file_names) - 1 if file_names else 0)
    nbits_npos = _index_nbits(int(name_pos.max(initial=0)))
    nbits_kmer = _index_nbits(int(kmer_pos.max(initial=0)))

    # group by kmer slot; within a slot: file ascending, position
    # descending (see docstring)
    order = np.lexsort((-gidx, file_idx, slot))
    reads = ((dirs[order] << np.uint64(nbits_file + nbits_npos + nbits_kmer))
             | (file_idx[order] << np.uint64(nbits_npos + nbits_kmer))
             | (name_pos[order].astype(np.uint64) << np.uint64(nbits_kmer))
             | kmer_pos[order].astype(np.uint64))
    per_slot = np.bincount(slot, minlength=db.n_kmers).astype(np.uint64)
    read_blocks = np.zeros(db.n_kmers, np.uint64)
    if db.n_kmers:
        read_blocks[1:] = np.cumsum(per_slot)[:-1]
    ri = ReadIndex(nbits_file, nbits_npos, nbits_kmer,
                   [f.encode() for f in file_names], read_blocks, reads)
    # bookkeeping for the verbose per-kmer (src/subseq/pos) dump
    ri._print_info = (slot, file_idx, subseq, kmer_pos, gidx)  # type: ignore
    return ri


def write_index_db(db: GmerDB, counter: DBCounter, file_names: list[str],
                   path: str, debug: int = 0):
    """gmer_counter --compile_index: GMDB (no counts) + read index.

    ``debug`` reproduces the reference's -D phase chatter and timing
    lines (src/gmer_counter.c:523-623) with this pipeline's timings. The
    job span "index_write": "build" the read index, "write" the file.
    """
    with trace.span("index_write"):
        return _write_index_db(db, counter, file_names, path, debug)


def _write_index_db(db: GmerDB, counter: DBCounter, file_names: list[str],
                    path: str, debug: int):
    t0 = time.time()
    if debug:
        sys.stderr.write("Calculate bitsizes\n")
    with trace.span("build"):
        ri = build_read_index(db, counter, file_names)
    if debug:
        sys.stderr.write("Bitsize time: %.1fs\n" % (time.time() - t0))
        t0 = time.time()
        mnp = max((int(h["name_pos"].max(initial=0)) for h in counter.hits),
                  default=0)
        mkp = max((int(h["kmer_pos"].max(initial=0)) for h in counter.hits),
                  default=0)
        sys.stderr.write("Num files %d Max name pos %d Max sequence pos %d\n"
                         % (len(file_names), mnp, mkp))
        sys.stderr.write("NBits file %d npos %d kmer %d\n"
                         % (ri.nbits_file, ri.nbits_npos, ri.nbits_kmer))
        sys.stderr.write("Writing index database to %s\n" % path)
    with trace.span("write"):
        from genometester4_tpu_torch.formats.gmerdb_binary import \
            write_binary_db
        from genometester4_tpu_torch.formats.read_index import \
            pack_read_index
        blob, physical, buggy_bs = pack_read_index(
            ri.nbits_file, ri.nbits_npos, ri.nbits_kmer, ri.files,
            ri.read_blocks, ri.reads)
        with open(path, "wb") as f:
            # gmer_counter's write_reads returns a read COUNT where bytes
            # are expected, so the recorded blocksize is too small —
            # reproduced
            write_binary_db(db, f, index_blob=blob, index_physical=physical,
                            index_blocksize=buggy_bs)
    if debug:
        sys.stderr.write("Done\n")
        sys.stderr.write("Writing time (reads): %.1fs\n"
                         % (time.time() - t0))
    return ri


def pair_median(db: GmerDB, counts_clamped: np.ndarray) -> int:
    """--double_median: median of per-node k-mer PAIR sums, found by the
    reference's iterative bisection (src/gmer_counter.c:946-1013).

    Pairs step 2 through each node's flat slots; an odd node reads one
    slot past its end in the reference (flat table overrun) — we read the
    next node's first count, which is what the overrun hits in the flat
    layout, and 0 at the very end of the table. The reference's `total`
    counts only nkmers/2 FLOOR pairs while the scans count the overrun
    pair too, so `equal = total - above - below` can wrap as a C
    unsigned — every arithmetic step below keeps u32 wrap semantics.
    """
    M = 0xFFFFFFFF
    flat = np.concatenate([counts_clamped.astype(np.int64), [0]])
    sums = []
    total = 0
    for i in range(db.n_nodes):
        nk = int(db.node_nkmers[i])
        k0 = int(db.node_kmers_start[i])
        total = (total + nk // 2) & M
        for j in range(0, nk, 2):
            sums.append(int(flat[k0 + j] + flat[k0 + j + 1]))
    s = np.asarray(sums, np.int64)
    mx = int(s.max(initial=0))
    mn = int(s.min(initial=0xFFFFFFFF))
    med = (mn + mx) // 2
    while mx > mn:
        above = int((s > med).sum())
        below = int((s < med).sum())
        equal = (total - above - below) & M
        if mx == mn + 1:
            if above > ((below + equal) & M):
                med = mx
            break
        if above > below:
            if ((above - below) & M) < equal:
                break
            mn = med
        elif below > above:
            if ((below - above) & M) < equal:
                break
            mx = med
        else:
            break
        med = (mn + mx) // 2
    return med


def format_counts(db: GmerDB, counts: np.ndarray, show_total: bool,
                  show_unique: bool, show_kmers: bool, distro: int,
                  header: bool, out, read_index=None) -> None:
    """Per-node output lines (src/gmer_counter.c:625-711).

    Bug-compat: the reference's --unique tests ``kmers_16[idx]`` even in
    32-bit mode (src/gmer_counter.c:655-659), aliasing 16-bit reads onto
    the u32 count array — slot j reads the low/high half of count j//2.
    We reproduce that deterministic aliasing.
    """
    if header:
        cols = ["NODE", "N_KMERS"]
        if show_total:
            cols.append("TOTAL")
        if show_unique:
            cols.append("UNIQUE")
        if show_kmers:
            cols.append("KMERS")
        if distro:
            cols.append("DISTRIBUTION")
        out.write("\t".join(cols) + "\n")
    starts = db.node_kmers_start.astype(np.int64)
    nks = db.node_nkmers.astype(np.int64)
    counts = counts.astype(np.uint64)
    if show_unique and db.count_bits == 32:
        aliased16 = counts.astype(np.uint32).view(np.uint16)
    if (not show_total and not show_unique and show_kmers and not distro
            and read_index is None):
        # default output shape: one native pass formats every line
        n = db.n_nodes
        name_len = np.fromiter((len(nm) for nm in db.names), np.int32, n)
        name_off = np.zeros(n, np.int64)
        if n:
            name_off[1:] = np.cumsum(name_len[:-1], dtype=np.int64)
        blob = b"".join(bytes(nm) for nm in db.names)
        cap = len(blob) + int(nks.sum()) * 22 + n * 26
        buf = np.empty(cap, np.uint8)
        counts_c = np.ascontiguousarray(counts, np.uint64)
        llp = ctypes.POINTER(ctypes.c_longlong)
        m = get_lib().fgx_format_node_counts(
            np.frombuffer(blob, np.uint8) if blob else np.zeros(1, np.uint8),
            name_off.ctypes.data_as(llp),
            name_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            np.ascontiguousarray(starts).ctypes.data_as(llp),
            np.ascontiguousarray(nks).ctypes.data_as(llp),
            counts_c, n, buf)
        out.write(buf[:m].tobytes().decode("latin1"))
        return

    idx_info = None
    if read_index is not None and hasattr(read_index, "_print_info"):
        slot, file_idx, subseq, kmer_pos, gidx = read_index._print_info
        order = np.lexsort((-gidx, file_idx, slot))
        idx_info = (slot[order], file_idx[order], subseq[order],
                    kmer_pos[order],
                    np.searchsorted(slot[order], np.arange(db.n_kmers + 1)))
    lines = []
    for i in range(db.n_nodes):
        c = counts[starts[i]:starts[i] + nks[i]]
        parts = [db.names[i].decode("latin1"), str(int(nks[i]))]
        if show_total:
            parts.append(str(int(c.sum())))
        if show_unique:
            if db.count_bits == 32:
                u = aliased16[starts[i]:starts[i] + nks[i]]
                parts.append(str(int((u != 0).sum())))
            else:
                parts.append(str(int((c != 0).sum())))
        if show_kmers:
            parts.extend(str(int(v)) for v in c)
        if distro:
            sc = np.sort(c)
            hist = np.bincount(np.minimum(sc, distro + 1).astype(np.int64),
                               minlength=distro + 2)
            parts.extend(str(int(hist[v])) for v in range(distro + 1))
        line = "\t".join(parts)
        if idx_info is not None:
            _, fi, ss, kp, bounds = idx_info
            segs = []
            for j in range(int(nks[i])):
                s0, s1 = bounds[starts[i] + j], bounds[starts[i] + j + 1]
                for r in range(s0, s1):
                    segs.append(" (%u/%u/%u)" % (fi[r], ss[r], kp[r]))
            line += "".join(segs)
        lines.append(line)
        if len(lines) >= 4096:
            out.write("\n".join(lines) + "\n")
            lines = []
    if lines:
        out.write("\n".join(lines) + "\n")
