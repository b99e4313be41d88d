"""glistmaker's device counting route: FASTA/FASTQ -> sorted ``.list``.

Port of the device branch of ``genometester4_tpu/pipelines/listmaker.py``
(``count_chunks``, ``merge_sorted_shards``, ``make_list``)::

  host slab parse                  io.fasta (native slab parser)
  -> 2^25-base code chunks         pad_pow2_chunk
  -> extract + canonicalize        kernel A (ops.extract_cuda)
  -> sort int64 keys               torch.sort
  -> unique keys and counts        kernel B (ops.runmarks_cuda), one sync
  -> 12-byte records, one copy     to_host (packed on the device)
  -> host rank-bucketed merge      weighted count_unique per bucket
  -> ListWriter.append_records     formats.list_format

With a mesh (``make_list(mesh=...)``, or by default with more than one
CUDA card, as in JAX), each slab is counted by the mesh route of
``parallel.sharding`` instead of ``count_chunks``; the merge and the
writer are the same. In a process group (GT4_DIST_*,
``parallel.multihost``) the mesh is the group's: every process counts its
row, only process 0 merges, spills, prints ``-D`` and writes, and no
process returns before the file is published.

``make_index`` (glistmaker ``--index``) runs, per 2^25-code chunk, kernel
A's forward windows, their canonical words and directions, and a
``nonzero`` compaction of the valid windows (``index_chunk``) on the
device; the location table, the pair sort and the index records stay on
the host, as in JAX. ``GT4_TPU_COUNT_IMPL=host`` takes its native host
route (one rolling C extraction per slab).

Output bytes are identical to the JAX package's. Not ported here: the
host-native route of ``make_list`` and the cost model of both (``device``
is explicit instead).
"""

from __future__ import annotations

import math
import os
import sys
import tempfile

import numpy as np
import torch

from genometester4_tpu_torch.formats.list_format import (RECORD_DTYPE,
                                                         RECORD_SIZE,
                                                         ListHeader,
                                                         ListWriter,
                                                         read_list,
                                                         record_bytes,
                                                         write_list)
from genometester4_tpu_torch.io.fasta import iter_code_slabs
from genometester4_tpu_torch.ops.encode import (SIGN, canonical,
                                                keys_from_u64, word_mask)
from genometester4_tpu_torch.ops.kmers import extract_kmers_best
from genometester4_tpu_torch.ops.sortcount import count_unique, sort_compact
from genometester4_tpu_torch.parallel import multihost
from genometester4_tpu_torch.pipelines.listcompare import bucket_cuts
from genometester4_tpu_torch.utils import trace
from genometester4_tpu_torch.utils.device import resolve_device

# 2^25 bases per chunk: ~1 GB of device memory per chunk (codes, int64
# keys, sort scratch), the same chunking as the JAX package so both
# produce the same shard boundaries.
DEFAULT_CHUNK_BASES = 1 << 25
# Target number of entries merged on the device at once.
DEFAULT_MERGE_BUCKET = 1 << 25


def pow2_cap(n: int, cap_limit: int) -> int:
    """The padded length of an ``n``-byte chunk: the next power of two, at
    least 1024, at most ``cap_limit``."""
    return min(1 << max(10, math.ceil(math.log2(max(n, 2)))), cap_limit)


def pad_pow2_chunk(chunk: np.ndarray, cap_limit: int) -> np.ndarray:
    """Pad a chunk with invalid bytes up to ``pow2_cap``, so that the CUDA
    caching allocator sees a handful of sizes instead of one per input
    length."""
    cap = pow2_cap(len(chunk), cap_limit)
    if len(chunk) < cap:
        chunk = np.concatenate(
            [chunk, np.full(cap - len(chunk), 255, np.uint8)])
    return chunk


class HostShard(tuple):
    """A host shard ``(words u64, counts u32)``: the word and count fields
    of one array of finished ``.list`` records (``RECORD_DTYPE``), with
    ``total``, the sum of its counts taken where the records were packed
    (None where it was not)."""

    def __new__(cls, words, counts, total=None):
        shard = super().__new__(cls, (words, counts))
        shard.total = total
        return shard


def to_host(words: torch.Tensor, counts: torch.Tensor) -> HostShard:
    """Unique int64 keys and their counts (any device) -> a host shard of
    12-byte records, packed where they are (bit 63 flipped back, the
    counts mod 2^32) behind the 8-byte total of those counts, and copied
    back in one copy: the span "copyback", and from a card the counter
    "copy.d2h_bytes", 12 bytes a record."""
    n = words.numel()
    with trace.span("copyback", wait=True):
        c32 = counts.to(torch.int32)   # a count's low 32 bits
        # the u32 total: a negative int32 stands for itself + 2^32
        total = c32.sum(dtype=torch.int64) + (c32 < 0).sum() * (1 << 32)
        buf = torch.empty(8 + RECORD_SIZE * n, dtype=torch.uint8,
                          device=words.device)
        buf[:8] = total.reshape(1).view(torch.uint8)
        recs = buf[8:].view(n, RECORD_SIZE)   # little-endian, as the file
        recs[:, :8] = words.contiguous().view(torch.uint8).view(n, 8)
        recs[:, 7] ^= 0x80                    # bit 63: key -> word
        recs[:, 8:] = c32.view(torch.uint8).view(n, 4)
        if words.device.type != "cpu":
            trace.count("copy.d2h_bytes", RECORD_SIZE * n)
        host = buf.cpu().numpy()
    recs = host[8:].view(RECORD_DTYPE)
    return HostShard(recs["word"], recs["count"],
                     int(host[:8].view(np.int64)[0]))


def upload(*arrays: torch.Tensor, device) -> list:
    """Host tensors -> ``device`` (pageable copies): the span "upload"."""
    with trace.span("upload", wait=True):
        return [a.to(device) for a in arrays]


def count_chunk(codes: torch.Tensor, k: int, canonical: bool = True):
    """One chunk's sorted unique keys and their counts (both int64), on
    the device of ``codes`` (uint8, 255 = invalid): kernel A, the sort and
    kernel B."""
    keys, valid = extract_kmers_best(codes, k, canonical)
    if valid is not None:   # k = 32: no flag bit, drop invalid keys
        keys = keys[valid]
    words, counts, _ = count_unique(keys, word_bits=2 * k)
    return words, counts


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
        out = None
        with trace.span("count"):
            with trace.span("pad"):
                piece = codes[start:start + chunk_bases]
                chunk = pad_pow2_chunk(piece, chunk_bases)
            trace.count("count.slots", len(chunk))
            trace.count("count.pad", len(chunk) - len(piece))
            chunk, = upload(torch.from_numpy(chunk), device=dev)
            with trace.span("launch"):
                words, counts = count_chunk(chunk, k, canonical)
            if len(words):
                out = to_host(words, counts)
        if out is not None:
            yield out


def merge_sorted_shards(shards, target_bucket: int = DEFAULT_MERGE_BUCKET,
                        device=None):
    """Merge sorted (words, counts) shards into one global sorted stream.

    The shards are cut at the same words into n = 2^ceil(log2(total /
    target_bucket)) buckets at the quantiles of their combined rank
    (``pipelines.listcompare.bucket_cuts``, host searches), so a bucket
    holds at most ``target_bucket`` + one entry per shard whatever the
    words' range; each bucket is merged with the weighted ``count_unique``
    on the device, and the sorted buckets are yielded in ascending order:
    a merged bucket as the ``HostShard`` that ``to_host`` gives, a bucket
    of one source as that shard when it is whole, else as a slice of its
    fields. A lone shard is yielded as it is, uncut. Counts add with u32
    wrap-around like the reference's counters.
    """
    dev = resolve_device(device)
    shards = [s for s in shards if len(s[0])]
    if len(shards) < 2:   # one shard is sorted and unique: no buckets
        yield from shards
        return
    with trace.span("merge"), trace.span("cuts"):
        cuts = bucket_cuts([w for w, _ in shards], target_bucket)
    for b in range(len(cuts[0]) - 1):
        parts = [(s, cut[b], cut[b + 1]) for s, cut in zip(shards, cuts)
                 if cut[b + 1] > cut[b]]
        if not parts:
            continue
        if len(parts) == 1:
            # single source: already sorted and unique; a whole shard
            # keeps its total
            s, lo, hi = parts[0]
            w, c = s
            yield s if hi - lo == len(w) else (w[lo:hi], c[lo:hi])
            continue
        parts = [(w[lo:hi], c[lo:hi]) for (w, c), lo, hi in parts]
        with trace.span("merge"):
            with trace.span("gather"):
                keys = keys_from_u64(np.concatenate([w for w, _ in parts]))
                weights = torch.from_numpy(
                    np.concatenate([c for _, c in parts]).astype(np.int64))
            keys, weights = upload(keys, weights, device=dev)
            words, counts, _ = count_unique(keys, weights)
            out = to_host(words, counts)
        yield out


def _default_mesh(dev: torch.device, canonical: bool):
    """JAX's rule (``listmaker.py:684-688``): more than one card means the
    mesh, unless GT4_TPU_MESH=0."""
    if (dev.type == "cuda" and canonical and torch.cuda.device_count() > 1
            and os.environ.get("GT4_TPU_MESH", "1") != "0"):
        from genometester4_tpu_torch.parallel.sharding import make_mesh
        return make_mesh()
    return None


def _print_phase_debug(hdr, n_words_in, job: int):
    """-D phase accounting in the JAX package's format (after the
    reference's token accumulators, src/glistmaker.c:355-359), from the
    spans right under the job's root: Read = "parse", Sort = "count" and
    "spill", Write tmp = "merge" and "write"."""
    took: dict = {}
    for r in trace.rows():
        if r.parent == job:
            took[r.name] = took.get(r.name, 0.0) + (r.t1 - r.t0)
    t_parse = took.get("parse", 0.0)
    t_count = took.get("count", 0.0) + took.get("spill", 0.0)
    t_write = took.get("merge", 0.0) + took.get("write", 0.0)
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
              slab_bytes: int = 1 << 28, device=None,
              mesh=None) -> ListHeader:
    """Full glistmaker run: files -> .list at ``output_path``.

    ``device``: ``None`` or ``"cuda"`` runs the CUDA kernels, ``"cpu"``
    their plain PyTorch versions; there is no automatic fallback.
    ``mesh``: a ``parallel.sharding.Mesh`` counts every slab on it (then
    ``chunk_bases`` is the mesh's own; canonical k-mers only). Without
    one, a process group (GT4_DIST_*) counts on its global mesh
    (``device``'s card, or every visible card for a plain ``cuda``), and
    otherwise a CUDA ``device`` with more than one visible card builds
    ``make_mesh()`` unless GT4_TPU_MESH=0, as the JAX package does. On a
    group's mesh only process 0 writes (the others return None), after
    which every process passes a barrier.
    ``debug`` > 0 records the job's spans and prints per-phase times
    from them to stderr. ``spill_bytes``
    (default 6 GiB, env GT4_SPILL_BYTES) is the in-RAM budget of counted
    shards before they spill to tmp .list files (dir GT4_TPU_TMPDIR)
    that the merge then reads as mmaps. ``min_count``/``max_count`` are
    the -c/--max cutoffs, applied after the merge.
    """
    dev = resolve_device(device)
    if mesh is None and canonical and multihost.is_multiprocess():
        mesh = multihost.group_mesh(dev)
    if mesh is None:
        mesh = _default_mesh(dev, canonical)
    elif not canonical:
        raise ValueError("the mesh route counts canonical k-mers only")
    group = mesh is not None and mesh.rank is not None
    if group:   # the merge runs on this process's first slot
        dev = mesh.devices[mesh.rank][0]
    if mesh is not None:
        from genometester4_tpu_torch.parallel.sharding import \
            count_kmers_sharded
    mesh_adapt_state: dict = {}   # adapted bucket slack, carried over slabs
    if spill_bytes is None:
        spill_bytes = int(os.environ.get("GT4_SPILL_BYTES", 6 << 30))
    tmpdir = os.environ.get("GT4_TPU_TMPDIR") or None
    n_words_in = 0
    shards = []
    ram_bytes = 0
    tmp_files = []

    def spill(shards):
        nonlocal ram_bytes
        out = []
        for shard in shards:
            w, c = shard
            if isinstance(w, np.memmap) or len(w) == 0:
                out.append(shard)   # spilled already: keeps its total
                continue
            fd, tmp = tempfile.mkstemp(suffix=".list", dir=tmpdir)
            os.close(fd)
            write_list(tmp, word_length, w, c)
            tmp_files.append(tmp)
            hdr, mw, mc = read_list(tmp, mmap=True)
            out.append(HostShard(mw, mc, hdr.total_count))
        ram_bytes = 0
        return out

    with trace.recording(debug > 0), trace.span("list") as job:
        try:
            for path in input_files:
                for codes, meta in iter_code_slabs(path, word_length,
                                                   slab_bytes):
                    if mesh is not None:
                        counted = [count_kmers_sharded(
                            codes, word_length, mesh,
                            adapt_state=mesh_adapt_state)]
                    else:
                        counted = count_chunks(codes, word_length,
                                               chunk_bases, canonical, dev)
                    for shard in counted:
                        w, c = shard
                        if not len(w):
                            continue
                        shards.append(shard)
                        ram_bytes += w.nbytes + c.nbytes
                        if ram_bytes > spill_bytes:
                            with trace.span("spill"):
                                shards = spill(shards)
                    n_words_in += max(0, meta.total_bases - (word_length - 1)
                                      * meta.n_records)
            hdr = None
            if mesh is None or mesh.writer:   # in a group, process 0 writes
                hdr = _merge_and_write(shards, output_path, word_length,
                                       min_count, max_count, dev)
                if debug:
                    _print_phase_debug(hdr, n_words_in, job.id)
        finally:
            for tmp in tmp_files:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
    if group:
        multihost.barrier()   # no process returns before the file exists
    return hdr


def _merge_and_write(shards, output_path: str, word_length: int,
                     min_count: int, max_count: int, dev) -> ListHeader:
    """The merge of the counted shards, cut to [min_count, max_count],
    into a ``ListWriter``; its opening and appends are the span "write"
    (its close, a header's rewrite, is the job's own time). Each part goes
    to ``append_records`` as its 12-byte records (``record_bytes``: the
    records copied back where the part is their two fields, the counter
    "list.records_whole", else packed), with the total it carries or, for
    a slice or a cut, one sum over its count field."""
    cut = min_count > 1 or max_count != 0xFFFFFFFF
    with trace.span("write"):
        w = ListWriter(output_path, word_length)
    with w:
        for part in merge_sorted_shards(shards, device=dev):
            words, counts = part
            raw = record_bytes(words, counts)
            whole = np.may_share_memory(raw, words)   # not packed here
            total = getattr(part, "total", None)
            if cut:   # one copy of the kept records
                keep = counts >= np.uint32(min_count)
                if max_count != 0xFFFFFFFF:
                    keep &= counts <= np.uint32(max_count)
                recs = raw.view(RECORD_DTYPE)[keep]
                raw, counts, total = recs.view(np.uint8), recs["count"], None
            if total is None:
                total = int(counts.sum(dtype=np.uint64))
            with trace.span("write"):
                if whole:
                    trace.count("list.records_whole", len(counts))
                w.append_records(raw, len(counts), total)
    return ListHeader(word_length, w.n_words, w.total_count)


def forward_windows(codes: torch.Tensor, k: int):
    """Every window of one chunk (uint8 codes, 255 = invalid) on its
    device: (canonical word int64, is the reverse complement bool, valid
    bool), each [n]. Kernel A extracts the forward words; a palindrome's
    direction is forward (``canonical == forward``), as JAX's
    ``~((chi == fhi) & (clo == flo))`` gives."""
    keys, valid = extract_kmers_best(codes, k, canonical=False)
    words = keys ^ SIGN
    if valid is None:   # k <= 31: validity is the flag bit 2k
        valid = words <= word_mask(k)
        words = words & word_mask(k)
    can = canonical(words, k)
    return can, can != words, valid


def index_chunk(codes: torch.Tensor, k: int):
    """One chunk of ``make_index`` on the device of ``codes``: the valid
    windows' (canonical word int64, window position int64, is the reverse
    complement bool) in stream order, with their count (a host int)."""
    can, is_rc, valid = forward_windows(codes, k)
    pos = torch.arange(codes.numel(), device=codes.device)
    return sort_compact(valid, can, pos, is_rc)


def _header_only_index(output_path: str, k: int) -> None:
    """The index of zero words: the reference writes the header alone
    (write_index_header, src/glistmaker.c:343-346,577-630)."""
    import struct
    tmp = f"{output_path}.tmp"
    with open(tmp, "wb") as f:
        f.write(b"I4TG")
        f.write(struct.pack("<II", 4, 2))
        f.write(struct.pack("<I", k))
        f.write(struct.pack("<QQ", 0, 0))
        f.write(struct.pack("<IIII", 1, 1, 1, 0))
        f.write(struct.pack("<QQQ", 72, 72, 72))
    os.replace(tmp, output_path)


def make_index(input_files, word_length: int, output_path: str,
               min_count: int = 1, max_count: int = 0xFFFFFFFF,
               chunk_bases: int = DEFAULT_CHUNK_BASES,
               slab_bytes: int = 1 << 28, device=None):
    """glistmaker --index: FASTA/FASTQ -> .index location file, byte for
    byte the JAX package's (reference writer src/glistmaker.c:366-782).

    Location semantics (src/glistmaker.c:1052-1068): pos counts printable
    sequence characters, subseq is the record index within the file, dir
    means the canonical word is the reverse complement. Ingestion streams
    slabs (``io.fasta.iter_slabs_indexed``); the location table is
    O(total windows), as in the reference.

    ``device``: where the chunks run (None: CUDA; ``"cpu"``: the plain
    versions); ``GT4_TPU_COUNT_IMPL=host`` takes the native host route
    instead. ``min_count``/``max_count`` reach the index records only:
    every location is written, the offsets count kept words only (the
    reference's cutoff bug, ``formats.index_format``). The job is the
    span "index", its stages the spans "chunks" (slab parse, extraction
    and the copies back), "pair_sort", "record_emit" and "write".
    """
    with trace.span("index"):
        _make_index(input_files, word_length, output_path, min_count,
                    max_count, chunk_bases, slab_bytes, device)


def _make_index(input_files, k: int, output_path: str, min_count: int,
                max_count: int, chunk_bases: int, slab_bytes: int, device):
    import ctypes

    from genometester4_tpu_torch.formats.index_format import (
        IndexFile, get_bitsize, write_index_file)
    from genometester4_tpu_torch.io.fasta import iter_slabs_indexed
    from genometester4_tpu_torch.utils.native import get_lib

    host = os.environ.get("GT4_TPU_COUNT_IMPL") == "host"
    if host:
        from genometester4_tpu_torch.utils.backend import disable_numpy_thp
        disable_numpy_thp()
        lib = get_lib()
    else:
        dev = resolve_device(device)
    with trace.span("chunks"):   # each copy back synced
        files_meta = []
        per_file = []  # (words, rec, lpos, dirs)
        max_lpos = 0
        max_subseq = 0
        for path in input_files:
            span_parts = []
            len_parts = []       # FASTQ per-record char lengths
            is_fastq = False
            w_l, r_l, p_l, d_l = [], [], [], []
            stream_size = 0
            n_rec = 0

            def add(meta, words, spos, dirs):
                # slab positions -> (record, record-local position)
                seg = np.searchsorted(meta.seg_starts, spos, side="right") - 1
                w_l.append(words)
                r_l.append(meta.seg_rec[seg])
                p_l.append(spos - meta.seg_starts[seg] + meta.seg_lpos0[seg])
                d_l.append(dirs)

            for codes, meta in iter_slabs_indexed(path, k, slab_bytes):
                if codes is None:
                    stream_size = meta.stream_size
                    n_rec = meta.n_records
                    break
                span_parts.append(meta.name_spans)
                if meta.rec_lengths is not None:
                    is_fastq = True
                    len_parts.append(meta.rec_lengths)
                n = len(codes)
                if n < k:
                    continue
                if host:
                    cap = max(n - k + 1, 1)
                    wbuf = np.empty(cap, np.uint64)
                    pbuf = np.empty(cap, np.int64)
                    dbuf = np.empty(cap, np.uint8)
                    m = lib.fgx_extract_canonical_posdir(
                        np.ascontiguousarray(codes, np.uint8), n, k,
                        wbuf, pbuf, dbuf)
                    if m:
                        add(meta, wbuf[:m], pbuf[:m], dbuf[:m])
                    continue
                step = chunk_bases - (k - 1)
                for start in range(0, max(n - (k - 1), 1), step):
                    chunk = pad_pow2_chunk(codes[start:start + chunk_bases],
                                           chunk_bases)
                    m, can, pos, is_rc = index_chunk(
                        torch.from_numpy(chunk).to(dev), k)
                    if m:
                        add(meta, can.cpu().numpy().view(np.uint64),
                            pos.cpu().numpy() + start,
                            is_rc.to(torch.uint8).cpu().numpy())

            # byte-level subsequence registry (src/glistmaker.c:1030-1050):
            # name_pos/name_len from the record header, seq span in BYTES up
            # to the next record start (FASTA) or the sequence line (FASTQ)
            ns = (np.concatenate(span_parts) if span_parts
                  else np.zeros((0, 2), np.int64))
            subseqs = np.zeros((n_rec, 4), np.int64)
            subseqs[:, 0] = ns[:, 0]
            subseqs[:, 1] = ns[:, 1] - ns[:, 0]
            seq_pos = ns[:, 1] + 1
            subseqs[:, 2] = seq_pos
            if not is_fastq:
                nxt = np.concatenate([ns[1:, 0] - 1, [stream_size]])
                subseqs[:, 3] = nxt - seq_pos
            else:
                subseqs[:, 3] = (np.concatenate(len_parts) if len_parts
                                 else np.zeros(0, np.int64))
            # the registry's file size is the ON-DISK size (the reference
            # stats the file, so a .gz records its compressed size) while the
            # subseq offsets and spans are decompressed-stream coordinates
            disk_size = (os.path.getsize(path) if path != "-"
                         else stream_size)
            files_meta.append(IndexFile(path.encode(), disk_size, subseqs))
            if n_rec:
                max_subseq = max(max_subseq, n_rec - 1)
            if not w_l:
                per_file.append(None)
                continue
            lpos = np.concatenate(p_l)
            if len(lpos):
                max_lpos = max(max_lpos, int(lpos.max()))
            per_file.append((np.concatenate(w_l), np.concatenate(r_l), lpos,
                             np.concatenate(d_l)))

    if not any(pf is not None and len(pf[0]) for pf in per_file):
        _header_only_index(output_path, k)
        return

    n_file_bits = get_bitsize(len(input_files) - 1)
    n_subseq_bits = get_bitsize(max_subseq)
    n_pos_bits = get_bitsize(max_lpos)

    with trace.span("pair_sort"):
        words_parts, code_parts = [], []
        for file_idx, pf in enumerate(per_file):
            if pf is None:
                continue
            words, rec, lpos, dirs = pf
            code = ((np.uint64(file_idx)
                     << np.uint64(n_subseq_bits + n_pos_bits + 1))
                    | (rec.astype(np.uint64) << np.uint64(n_pos_bits + 1))
                    | (lpos.astype(np.uint64) << np.uint64(1))
                    | dirs.astype(np.uint64))
            words_parts.append(words)
            code_parts.append(code)
        aw = np.ascontiguousarray(np.concatenate(words_parts), np.uint64)
        ac = np.ascontiguousarray(np.concatenate(code_parts), np.uint64)
        # location codes pack (file, record, position, dir) in stream
        # order, so they ascend in the concatenation: one stable LSD pair
        # sort by word leaves the (word, code) pairs in lexicographic order
        lib = get_lib()
        if lib.fgx_sort_pair_u64(aw, ac, len(aw), 2 * k):
            raise MemoryError("pair sort scratch allocation failed")
    # one C pass over the runs emits the interleaved k-mer records (the
    # cutoff bug kept: offsets accumulate over kept words only, every
    # location is written)
    with trace.span("record_emit"):
        recs = np.empty(2 * len(aw), np.uint64)
        nloc = ctypes.c_ulonglong(0)
        m = lib.fgx_index_kmer_records(aw, len(aw), min_count, max_count,
                                       recs, ctypes.byref(nloc))
    with trace.span("write"):
        write_index_file(output_path, k, files_meta, None, None,
                         int(nloc.value), ac, n_file_bits, n_subseq_bits,
                         n_pos_bits, kmer_recs=recs[: 2 * m])
