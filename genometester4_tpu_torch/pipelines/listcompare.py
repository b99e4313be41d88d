"""glistcompare equivalent: set operations over .list and .index files
(port of ``genometester4_tpu/pipelines/listcompare.py``).

Mirrors src/glistcompare.c's behaviors (see ops/setops.py for the rule
semantics). Routes of ``compare_pair`` and ``compare_multi``:

* the device route (default), on ``device`` (None: CUDA; ``"cpu"`` runs
  the same PyTorch ops on the CPU). Large inputs are processed in
  buckets cut at the quantiles of their combined rank (``bucket_cuts``:
  host searches on the sorted mmap'd arrays, so each bucket holds at most
  the target plus one word per input, whatever the words' range); each
  bucket goes to the device as int64 keys and runs one align + ops pass
  (``ops.setops``), and the outputs stream to ListWriters in ascending
  order, so results are identical to a single full-size pass;
* the mesh route, with ``mesh=`` or, as in JAX, by default on more than
  one CUDA card (GT4_TPU_MESH=0 opts out): the same buckets, at least one
  a slot, dealt round-robin over the slots; the slots of distinct cards
  run side by side, and the outputs stream to the files in bucket order
  (``parallel.sharding.sharded_pair_ops``/``sharded_multi_op`` return
  them as arrays);
* ``GT4_TPU_SETOPS_IMPL=host``: the native host route (a streaming C
  zipper, bucketed over threads on large inputs, and a k-way merge),
  as in JAX.

* a process group (GT4_DIST_*, ``parallel.multihost``): the mesh route
  over the group's slots, each process running its own slots' parts and
  sending their outputs to process 0, which alone writes; it overrides
  the host route, as in JAX, and every process returns after the files
  are published.

``compare_pair`` and ``compare_multi`` record their spans and counters
(``utils.trace``): one job root "compare" a call, over "read" (an
input's mmap) and "write" (the sinks' opening, a part's appends, the
closes); on the device route also "cuts" (the placement,
``bucket_cuts``) and a part's "upload" (w), "ops" (its "sync" (w) where
the host reads a size) and "copyback" (w), which ``_run_parts`` runs
under the root on its pool's threads too; counters "compare.parts",
"compare.words_in" (the records of both inputs the parts take),
"compare.words_out" (records handed to the sinks, every op) and, from a
card, "copy.d2h_bytes".

The JAX package's placement cost model (``auto``) is not ported.
``compare_pair_mm`` (``-mm``) and
``make_subset`` (``-ss``) are host code in JAX too and stay so. torch is
imported only when a device route runs.
"""

from __future__ import annotations

import bisect
import math
import os
import sys

import numpy as np

from genometester4_tpu_torch.formats.list_format import (GT4_LIST_CODE,
                                                         ListWriter,
                                                         read_list,
                                                         record_bytes,
                                                         write_list)
from genometester4_tpu_torch.utils import trace
from genometester4_tpu_torch.utils.rand48 import Rand48


def read_word_source(path):
    """Load a .list OR .index as (header-like, words, counts) — the
    reference's set operations accept either through the GT4WordSList
    interface, with index counts being location counts
    (src/glistcompare.c:250-286)."""
    import struct
    from types import SimpleNamespace
    with open(path, "rb") as f:
        code = struct.unpack("<I", f.read(4))[0]
    if code == GT4_LIST_CODE:
        return read_list(path)
    from genometester4_tpu_torch.formats.index_format import (
        GT4_INDEX_CODE, read_index_map)
    if code == GT4_INDEX_CODE:
        im = read_index_map(path)
        counts = im.counts
        hdr = SimpleNamespace(word_length=im.word_length,
                              n_words=len(im.words),
                              total_count=int(im.num_locations))
        return hdr, im.words, counts
    raise ValueError(
        f"Error: {path} is not a valid GenomeTester4 list/index file")


# CLI rule names -> the rule strings of ops.setops (RULE_*)
RULES = {"default": "default", "add": "add", "sum": "add",
         "subtract": "subtract", "min": "min", "max": "max",
         "first": "first", "second": "second", "number": "number"}
# the reference's enum Rules numbers (src/glistcompare.c:45-54), which the
# native kernels take
RULE_NUMBERS = {"default": 0, "add": 1, "subtract": 2, "min": 3, "max": 4,
                "first": 5, "second": 6, "number": 7}

DEFAULT_BUCKET = 1 << 25


# multi-list ops print a progress line at every PROGRESS_TICK output
# words when -D is on (src/glistcompare.c:586-588, src/set-operations.c:
# 111-113); module-level so tests can lower it below 100M
PROGRESS_TICK = 100_000_000


def _emit_progress_ticks(prev: int, new: int) -> None:
    """Print the reference's "Words written: NM" line for every
    PROGRESS_TICK boundary crossed in (prev, new]."""
    b = (prev // PROGRESS_TICK + 1) * PROGRESS_TICK
    while b <= new:
        sys.stderr.write("Words written: %uM\n" % (b // 1_000_000))
        b += PROGRESS_TICK


class _OpSink:
    """Accumulates one op's output: either a ListWriter or count-only.
    An append counts its records in "compare.words_out"; the callers'
    span "write" holds the sinks' opening, appends and closes."""

    def __init__(self, op, path, word_length, count_only, debug=0):
        self.op = op
        self.count_only = count_only
        self.n_words = 0
        self.total_count = 0
        self.debug = debug
        self.writer = None if count_only else ListWriter(path, word_length)

    def append(self, words, counts):
        trace.count("compare.words_out", len(words))
        prev = self.n_words
        self.n_words += len(words)
        self.total_count += int(np.asarray(counts, np.uint64).sum())
        if self.debug:
            _emit_progress_ticks(prev, self.n_words)
        if self.writer:
            self.writer.append(words, counts)

    def close(self):
        if self.writer:
            self.writer.close()


def _op_filename(out, wlen, op, nmm=0):
    if op == "union":
        return f"{out}_{wlen}_union.list"
    if op == "intrsec":
        return f"{out}_{wlen}_intrsec.list"
    if op == "diff1":
        return f"{out}_{wlen}_{nmm}_diff1.list"
    if op == "diff2":
        return f"{out}_{wlen}_{nmm}_diff2.list"
    raise ValueError(op)


def _host_route() -> bool:
    """GT4_TPU_SETOPS_IMPL=host takes the native host route; anything else
    the device route (JAX's ``auto`` cost model is not ported)."""
    return os.environ.get("GT4_TPU_SETOPS_IMPL") == "host"


def word_rank(words, values) -> np.ndarray:
    """``np.searchsorted(words, values)`` (side left) for a sorted u64
    ``words``. numpy copies a strided or unaligned array whole before it
    searches, and the word field of 12-byte records (a ``.list`` mmap, a
    shard copied back as records) is both; such a field is searched here
    in place: up to 128 values (the bounds of ``rank_bounds``' halvings)
    one bisection a value, more by a vectorized binary search of
    ~log2(len(words)) gathers, whose fixed cost the bisections undercut
    below a few hundred values."""
    words = np.asarray(words)
    values = np.asarray(values, np.uint64)
    if words.flags.c_contiguous and words.flags.aligned:
        return np.searchsorted(words, values)
    if values.size <= 128:
        return np.array([bisect.bisect_left(words, v)
                         for v in values.ravel()],
                        np.int64).reshape(values.shape)
    lo = np.zeros(values.shape, np.int64)
    hi = np.full(values.shape, len(words), np.int64)
    while True:
        active = lo < hi
        if not active.any():
            return lo
        mid = (lo + hi) >> 1
        below = active & (words[np.minimum(mid, len(words) - 1)] < values)
        lo = np.where(below, mid + 1, lo)
        hi = np.where(active & ~below, mid, hi)


def rank_bounds(word_lists, n_parts: int) -> np.ndarray:
    """Quantile word boundaries over N sorted arrays WITHOUT re-sorting
    (the port's copy of JAX ``parallel/sharding.rank_bounds``).

    Value-space binary search on the combined rank: rank(v) =
    sum_i searchsorted(w_i, v) is monotone in v, so the t-th quantile
    boundary is the smallest v with rank(v) >= t*total/n_parts — found
    in <=64 halvings, each a vectorized ``word_rank`` per input.
    """
    total = sum(len(w) for w in word_lists)
    targets = (np.arange(1, n_parts) * total) // n_parts
    lo = np.zeros(len(targets), np.uint64)
    hi = np.full(len(targets), np.uint64(0xFFFFFFFFFFFFFFFF))
    for _ in range(64):
        mid = lo + ((hi - lo) >> np.uint64(1))
        rank = np.zeros(len(targets), np.int64)
        for w in word_lists:
            rank += word_rank(w, mid)
        ge = rank >= targets
        hi = np.where(ge, mid, hi)
        lo = np.where(ge, lo, mid + np.uint64(1))
        if np.all(lo >= hi):
            break
    return hi


def rank_cuts(word_lists, n_parts: int) -> list:
    """Cut N sorted unique word arrays at ``rank_bounds``: per array, the
    n_parts + 1 offsets of its parts (int64). Part t of every array holds
    the words in [bound t-1, bound t), so the parts of one t align across
    the arrays, and ascending t gives ascending words. A word is in each
    array at most once, so part t holds at most
    ceil(total / n_parts) + N - 1 entries, whatever the words' range."""
    bounds = rank_bounds(word_lists, n_parts)
    return [np.concatenate([[0], word_rank(w, bounds), [len(w)]])
            .astype(np.int64) for w in word_lists]


def bucket_cuts(word_lists, target: int, n_min: int = 1) -> list:
    """``rank_cuts`` into the fewest n = n_min * 2^j buckets with
    total / n <= target, so that a bucket holds at most target + N
    entries: the device passes of glistmaker's merge and of glistcompare's
    set operations (n_min: the slots of a mesh, one bucket each at least).
    """
    total = sum(len(w) for w in word_lists)
    n = n_min << max(0, math.ceil(math.log2(max(1, total / (target
                                                           * n_min)))))
    return rank_cuts(word_lists, n)


# ---------------------------------------------------------------------------
# Host (numpy) twins of the device set operations (ops/setops.py): the
# same masks and the same u32 wraparound, for the differential tests.
# ---------------------------------------------------------------------------


def _host_pair_align(w1, c1, w2, c2):
    # native C merge of the two sorted streams (numpy formulations peak
    # at ~3x the reference's zipper cost: argsort + fancy indexing +
    # reduceats each re-stream the data; the C merge does one pass)
    from genometester4_tpu_torch.utils.native import get_lib
    lib = get_lib()
    w1 = np.ascontiguousarray(w1, np.uint64)
    w2 = np.ascontiguousarray(w2, np.uint64)
    c1 = np.ascontiguousarray(c1, np.uint32)
    c2 = np.ascontiguousarray(c2, np.uint32)
    cap = len(w1) + len(w2)
    uw = np.empty(cap, np.uint64)
    f1 = np.empty(cap, np.uint32)
    f2 = np.empty(cap, np.uint32)
    m = lib.fgx_pair_align(w1, c1, len(w1), w2, c2, len(w2), uw, f1, f2)
    return uw[:m], f1[:m], f2[:m]


def _host_rule_freq(f1, f2, rule, count_override):
    if rule == "add":
        return f1 + f2
    if rule == "subtract":
        return np.where(f1 > f2, f1 - f2, 0).astype(np.uint32)
    if rule == "min":
        return np.minimum(f1, f2)
    if rule == "max":
        return np.maximum(f1, f2)
    if rule == "first":
        return f1
    if rule == "second":
        return f2
    if rule == "number":
        return np.full_like(f1, np.uint32(count_override))
    raise ValueError(f"invalid rule {rule}")


def _host_apply_pair_op(uw, f1, f2, op, rule, cutoff, count_override,
                        subtract):
    co = np.uint32(cutoff)
    ge1, ge2 = f1 >= co, f2 >= co
    present1, present2 = f1 > 0, f2 > 0
    if op == "union":
        r = "add" if rule == "default" else rule
        freq = _host_rule_freq(f1, f2, r, count_override)
        inc = (ge1 | ge2) & (freq != 0)
    elif op == "intrsec":
        r = "min" if rule == "default" else rule
        freq = _host_rule_freq(f1, f2, r, count_override)
        inc = present1 & present2 & ge1 & ge2 & (freq != 0)
    elif op == "diff1":
        if subtract:
            freq = f1
            inc = present1 & present2 & (f1 == f2) & ge1
        else:
            r = "subtract" if rule == "default" else rule
            freq = _host_rule_freq(f1, f2, r, count_override)
            inc = present1 & ge1 & ~ge2 & (freq != 0)
    elif op == "diff2":
        r = "subtract" if rule == "default" else rule
        freq = _host_rule_freq(f2, f1, r, count_override)
        inc = present2 & ge2 & ~ge1 & (freq != 0)
    else:
        raise ValueError(f"unknown op {op}")
    return uw[inc], freq[inc].astype(np.uint32)


def _host_apply_multi_op(w_cat, c_cat, s_cat, n_lists, op, rule, cutoff,
                         count_override):
    order = np.argsort(w_cat, kind="stable")
    sw = w_cat[order]
    sc = c_cat[order].astype(np.uint32)
    if len(sw) == 0:
        return np.empty(0, np.uint64), np.empty(0, np.uint32)
    head = np.concatenate([[True], sw[1:] != sw[:-1]])
    starts = np.flatnonzero(head)
    uw = sw[starts]
    # a u32 accumulator: numpy's default one is 64-bit, so a sum past 2^32
    # would pass the cutoff where the device route and the native merge
    # see its wrapped value (the JAX package's twin has that fault)
    f_add = np.add.reduceat(sc, starts, dtype=np.uint32)
    f_min = np.minimum.reduceat(sc, starts)
    f_max = np.maximum.reduceat(sc, starts)
    n_src = np.diff(np.concatenate([starts, [len(sw)]]))
    if op == "union":
        r = "add" if rule == "default" else rule
    else:
        r = "min" if rule == "default" else rule
    if r == "add":
        freq = f_add
    elif r == "max":
        freq = f_max
    elif r == "min":
        freq = f_min
    elif r == "number":
        freq = np.full_like(f_add, np.uint32(count_override))
    else:
        raise ValueError(f"rule {r} not valid for multi-list {op}")
    inc = freq >= np.uint32(cutoff)
    if op == "intrsec":
        inc &= n_src == n_lists
    return uw[inc], freq[inc].astype(np.uint32)


def _to_device(words, counts, dev):
    """Host u64 words and u32 counts -> (int64 keys, int64 counts) on
    ``dev``."""
    import torch

    from genometester4_tpu_torch.ops.encode import keys_from_u64
    return (keys_from_u64(words).to(dev),
            torch.from_numpy(np.asarray(counts, np.uint32).astype(np.int64))
            .to(dev))


def _upload(pairs, dev, join=False):
    """``_to_device`` of each (words, counts) of one part, or with
    ``join`` of their concatenation: the span "upload", which counts the
    part in "compare.parts" and its records in "compare.words_in"."""
    with trace.span("upload", wait=True):
        trace.count("compare.parts")
        trace.count("compare.words_in", sum(len(w) for w, _ in pairs))
        if join:
            pairs = [(np.concatenate([w for w, _ in pairs]),
                      np.concatenate([c for _, c in pairs]))]
        return [t for w, c in pairs for t in _to_device(w, c, dev)]


def _to_host(keys, counts):
    """(int64 keys, int64 u32 counts) on any device -> host (u64, u32):
    the span "copyback", and from a card the counter "copy.d2h_bytes",
    12 bytes a record."""
    import torch

    from genometester4_tpu_torch.ops.encode import u64_from_keys
    with trace.span("copyback", wait=True):
        if keys.device.type != "cpu":
            trace.count("copy.d2h_bytes", 12 * keys.numel())
        return (u64_from_keys(keys),
                counts.to(torch.int32).cpu().numpy().view(np.uint32))


def _host_compare_pair(sinks, h1, w1, c1, h2, w2, c2, rule, cutoff,
                       count_override, subtract):
    """compare_pair's native host route (GT4_TPU_SETOPS_IMPL=host)."""
    import queue
    import threading

    from genometester4_tpu_torch.utils.backend import disable_numpy_thp
    from genometester4_tpu_torch.utils.native import get_lib
    disable_numpy_thp()
    lib = get_lib()
    rint = RULE_NUMBERS[RULES[rule]]
    r1 = record_bytes(w1, c1)
    r2 = record_bytes(w2, c2)

    n_threads = int(os.environ.get("OMP_NUM_THREADS",
                                   os.cpu_count() or 1))
    if n_threads > 1 and (h1.n_words + h2.n_words) > (1 << 20):
        # multi-core hosts: cut both inputs at identical word
        # boundaries (merge-path rank select) and run the zipper
        # OpenMP-parallel across buckets; bucket-order concatenation
        # is byte-identical to the sequential pass. Buffers are
        # output-sized per op — a RAM-for-cores trade the streaming
        # path below avoids on small machines.
        nb = min(4 * n_threads, 64)
        cuts1, cuts2 = rank_cuts([w1, w2], nb)
        cap = 12 * (h1.n_words + h2.n_words)
        bufs, ns, ss = {}, {}, {}
        for op in ("union", "intrsec", "diff1", "diff2"):
            if op in sinks:
                bufs[op] = np.empty(max(cap, 12), np.uint8)
                ns[op] = np.zeros(nb, np.int64)
                ss[op] = np.zeros(nb, np.uint64)
            else:
                bufs[op] = ns[op] = ss[op] = None
        lib.fgx_pair_ops_buckets(
            r1, r2, cuts1, cuts2, nb, rint, cutoff, count_override,
            int(subtract),
            bufs["union"], ns["union"], ss["union"],
            bufs["intrsec"], ns["intrsec"], ss["intrsec"],
            bufs["diff1"], ns["diff1"], ss["diff1"],
            bufs["diff2"], ns["diff2"], ss["diff2"])
        offs = 12 * ((cuts1[:-1] - cuts1[0]) + (cuts2[:-1] - cuts2[0]))
        for op, sink in sinks.items():
            for b in range(nb):
                m = int(ns[op][b])
                if not m:
                    continue
                o = int(offs[b])
                if sink.writer:
                    sink.writer.append_records(
                        bufs[op][o: o + 12 * m], m, int(ss[op][b]))
                sink.n_words += m
                sink.total_count += int(ss[op][b])
        return

    # Chunked resumable zipper (native fgx_pair_stream_*): output
    # records stream to the writers in CHUNK-record pieces through a
    # writer thread, so the file writes overlap the next chunk's
    # merge and no output-sized buffer is ever materialized
    # (the reference's one-pass-4-outputs structure,
    # src/glistcompare.c:843-905, with the write moved off-thread).
    CHUNK = 1 << 20
    ALL_OPS = ("union", "intrsec", "diff1", "diff2")
    active = [op in sinks for op in ALL_OPS]
    st = lib.fgx_pair_stream_start(
        r1, h1.n_words, r2, h2.n_words, rint, cutoff, count_override,
        int(subtract), *[int(a) for a in active])
    if not st:
        raise MemoryError("pair stream allocation failed")
    dummy = np.empty(12, np.uint8)
    bufsets = []
    for _ in range(2):
        bufsets.append([np.empty(12 * CHUNK, np.uint8) if a else dummy
                        for a in active])
    n_out = np.zeros(4, np.int64)
    sums = np.zeros(4, np.uint64)
    q = queue.Queue()
    free = queue.Queue()
    for i in range(len(bufsets)):
        free.put(i)

    def pump():
        while True:
            item = q.get()
            if item is None:
                return
            si, counts, csums = item
            for t, op in enumerate(ALL_OPS):
                if active[t] and counts[t]:
                    sink = sinks[op]
                    m = int(counts[t])
                    if sink.writer:
                        sink.writer.append_records(
                            bufsets[si][t][: 12 * m], m, int(csums[t]))
                    sink.n_words += m
                    sink.total_count += int(csums[t])
            free.put(si)

    th = threading.Thread(target=pump, daemon=True)
    th.start()
    try:
        more = 1
        while more:
            si = free.get()
            bs = bufsets[si]
            more = lib.fgx_pair_stream_next(
                st, bs[0], bs[1], bs[2], bs[3], CHUNK, n_out, sums)
            q.put((si, n_out.copy(), sums.copy()))
    finally:
        q.put(None)
        th.join()
        lib.fgx_pair_stream_free(st)


def _placement(word_lists, device, mesh, target):
    """The device route's parts: (each list's ``bucket_cuts``, the slots).
    Buckets hold at most ``target`` + N words and number at least one a
    slot; part p goes to slot p mod len(slots). The slots are those of
    ``mesh`` (on a group's mesh, ``parallel.multihost``, the slots of
    other processes are None), else of JAX's rule (more than one CUDA
    card and GT4_TPU_MESH != 0, ``make_mesh()`` over all of them), else
    ``device`` alone."""
    with trace.span("cuts"):
        if mesh is None:
            from genometester4_tpu_torch.pipelines.listmaker import \
                _default_mesh
            from genometester4_tpu_torch.utils.device import resolve_device
            dev = resolve_device(device)
            mesh = _default_mesh(dev, True)
            slots = [dev] if mesh is None else mesh.slots
        else:
            slots = mesh.slots
        return bucket_cuts(word_lists, target, len(slots)), slots


def _run_parts(run, n_parts, slots, host=None):
    """``host(run(p, slots[p % len(slots)]))`` for every part p, yielded
    in part order; ``run`` returns a part's outputs (on a group's mesh,
    device tensors or None), ``host`` copies them back (None: as they
    are). One window of len(slots) parts at a time: its parts of distinct
    devices run side by side, the first device's on the calling thread
    and each other device's on a pool thread (torch lets go of the GIL
    while a card works), those of one device one after another, so a
    device holds one part at once; one device hands nothing to another
    thread. On a group's mesh (the slots of other processes are None) a
    process runs its own slots' parts; the others send theirs to process
    0, which yields every part in the same order, None for one that holds
    nothing, and is the only one to yield. The pool threads' spans are
    children of the span open where the first part is asked for
    (``trace.under``)."""
    from concurrent.futures import ThreadPoolExecutor

    from genometester4_tpu_torch.parallel import multihost
    if host is None:
        def host(out):
            return out
    width = len(slots)
    devices = list(dict.fromkeys(d for d in slots if d is not None))
    send, per = False, width
    if None in slots:
        import torch.distributed as dist
        send, per = dist.get_rank() != 0, width // dist.get_world_size()

    parent = trace.current()

    def on(dev, window):
        out = []
        with trace.under(parent):
            for p in window:
                if slots[p % width] == dev:
                    got = run(p, dev)
                    out.append((p, got if send or got is None
                                else host(got)))
        return out
    with ThreadPoolExecutor(max(len(devices) - 1, 1)) as pool:
        for lo in range(0, n_parts, width):
            window = range(lo, min(lo + width, n_parts))
            others = [pool.submit(on, d, window) for d in devices[1:]]
            done = dict(on(devices[0], window))
            for f in others:
                done.update(f.result())
            for p in window:
                if p not in done:       # another process's part
                    if not send:
                        got = multihost.recv_from(p % width // per)
                        yield host(got) if got else None
                elif send:
                    multihost.send_to_writer(done.pop(p) or [])
                else:
                    yield done.pop(p)


def pair_parts(w1, c1, w2, c2, ops, rule="default", cutoff=1,
               count_override=1, subtract=False, device=None, mesh=None,
               target=DEFAULT_BUCKET):
    """The set operations ``ops`` of two sorted lists part by part
    (``_placement``): part p of both goes to its slot's device as int64
    keys, where one aligned table (``ops.setops.pair_align``) feeds every
    op. Yields, in part order and skipping parts that hold nothing, {op:
    (words u64, counts u32)} on the host; the parts concatenate into the
    whole lists' results (on a group's mesh, on process 0 only).
    ``rule`` is an ``ops.setops`` rule."""
    from genometester4_tpu_torch.ops import setops
    (cuts1, cuts2), slots = _placement([w1, w2], device, mesh, target)

    def run(p, dev):
        a1, z1, a2, z2 = cuts1[p], cuts1[p + 1], cuts2[p], cuts2[p + 1]
        if z1 - a1 + z2 - a2 == 0:
            return None
        tensors = _upload([(w1[a1:z1], c1[a1:z1]), (w2[a2:z2], c2[a2:z2])],
                          dev)
        with trace.span("ops"):
            aligned = setops.pair_align(*tensors)
            return [t for op in ops for t in setops.apply_pair_op(
                *aligned, op=op, rule=rule, cutoff=cutoff,
                count_override=count_override, subtract=subtract)]

    def host(ts):
        return {op: _to_host(ts[2 * i], ts[2 * i + 1])
                for i, op in enumerate(ops)}
    for out in _run_parts(run, len(cuts1) - 1, slots, host):
        if out is not None:
            yield out


def multi_parts(word_lists, count_lists, op, rule="default", cutoff=1,
                count_override=1, device=None, mesh=None,
                target=DEFAULT_BUCKET):
    """An N-list union or intersection part by part, as ``pair_parts``:
    part p of every list, concatenated, on its slot's device
    (``ops.setops.apply_multi_op``). Yields each part's (words u64,
    counts u32) on the host, in part order, skipping parts that hold
    nothing."""
    from genometester4_tpu_torch.ops import setops
    cuts, slots = _placement(word_lists, device, mesh, target)

    def run(p, dev):
        parts = [(w[c[p]:c[p + 1]], n[c[p]:c[p + 1]])
                 for w, n, c in zip(word_lists, count_lists, cuts)]
        if not any(len(w) for w, _ in parts):
            return None
        tensors = _upload(parts, dev, join=True)
        with trace.span("ops"):
            return list(setops.apply_multi_op(
                *tensors, n_lists=len(word_lists), op=op, rule=rule,
                cutoff=cutoff, count_override=count_override))
    for out in _run_parts(run, len(cuts[0]) - 1, slots,
                          lambda ts: _to_host(*ts)):
        if out is not None:
            yield out


def compare_pair(list1: str, list2: str, ops: list[str], outputname: str = "out",
                 cutoff: int = 1, rule: str = "default", count_override: int = 1,
                 subtract: bool = False, count_only: bool = False,
                 bucket_target: int = DEFAULT_BUCKET, device=None, mesh=None):
    """Two-list compare producing any of union/intrsec/diff1/diff2.

    Returns {op: (n_words, total_count)}; writes files unless count_only.
    ``device``: where the device route runs (None: CUDA), in buckets of
    at most ``bucket_target`` + 2 words. ``mesh``: a
    ``parallel.sharding.Mesh`` whose slots take those buckets in turn
    instead (by default with more than one CUDA card, as in JAX), the
    outputs streaming to the files as on one device.
    """
    mesh = _group_mesh(device, mesh)
    on_host = _host_route() and not _grouped(mesh)
    with trace.span("compare"):
        h1, w1, c1 = _read(list1)
        h2, w2, c2 = _read(list2)
        wlen = h1.word_length
        writer = mesh is None or mesh.writer
        with trace.span("write"):
            sinks = {op: _OpSink(op, _op_filename(outputname, wlen, op),
                                 wlen, count_only or not writer)
                     for op in ops}
        if on_host:
            _host_compare_pair(sinks, h1, w1, c1, h2, w2, c2, rule, cutoff,
                               count_override, subtract)
        else:
            for out in pair_parts(w1, c1, w2, c2, list(sinks), RULES[rule],
                                  cutoff, count_override, subtract, device,
                                  mesh, bucket_target):
                with trace.span("write"):
                    for op, sink in sinks.items():
                        if len(out[op][0]):
                            sink.append(*out[op])
        results = {}
        with trace.span("write"):
            for op, sink in sinks.items():
                sink.close()
                results[op] = (sink.n_words, sink.total_count)
    _publish(mesh)
    return results


def _read(path):
    """``read_word_source``: the span "read"."""
    with trace.span("read"):
        return read_word_source(path)


def _group_mesh(device, mesh):
    """``mesh``, or a process group's mesh (GT4_DIST_*) when there is
    one: it overrides the host route and the single-process placement,
    as in JAX."""
    from genometester4_tpu_torch.parallel import multihost
    if mesh is None and multihost.is_multiprocess():
        from genometester4_tpu_torch.utils.device import resolve_device
        mesh = multihost.group_mesh(resolve_device(device))
    return mesh


def _grouped(mesh) -> bool:
    return mesh is not None and mesh.rank is not None


def _publish(mesh) -> None:
    """In a group, no process returns before process 0's files exist."""
    if _grouped(mesh):
        from genometester4_tpu_torch.parallel import multihost
        multihost.barrier()


def _host_compare_multi(sink, data, op, rule, cutoff, count_override, debug):
    """compare_multi's native host route (GT4_TPU_SETOPS_IMPL=host): a
    streaming k-way merge over the raw record streams
    (fgx_multi_stream_*), chunked output."""
    import ctypes
    import queue
    import threading

    from genometester4_tpu_torch.utils.backend import disable_numpy_thp
    from genometester4_tpu_torch.utils.native import get_lib
    disable_numpy_thp()
    lib = get_lib()
    n_lists = len(data)
    eff = RULES.get(rule, "number")
    if eff == "default":
        eff = "add" if op == "union" else "min"
    bufs_keepalive = []
    ptrs = (ctypes.c_void_p * n_lists)()
    lens = (ctypes.c_long * n_lists)()
    for i, (h, w, c) in enumerate(data):
        raw = record_bytes(w, c)
        bufs_keepalive.append(raw)
        ptrs[i] = raw.ctypes.data
        lens[i] = len(w)
    st = lib.fgx_multi_stream_start(ptrs, lens, n_lists,
                                    int(op == "intrsec"), RULE_NUMBERS[eff],
                                    cutoff, count_override)
    if not st:
        raise MemoryError("multi stream allocation failed")
    # double-buffered writer thread: the file write overlaps the
    # next chunk's merge (same pattern as the pair path)
    CHUNK = 1 << 20
    bufs2 = [np.empty(12 * CHUNK, np.uint8) for _ in range(2)]
    n_out = ctypes.c_long(0)
    s_out = ctypes.c_ulonglong(0)
    q = queue.Queue()
    free_q = queue.Queue()
    for i in range(len(bufs2)):
        free_q.put(i)

    def pump():
        while True:
            item = q.get()
            if item is None:
                return
            bi, m, t = item
            if sink.writer:
                sink.writer.append_records(bufs2[bi][: 12 * m], m, t)
            prev = sink.n_words
            sink.n_words += m
            sink.total_count += t
            if debug:
                _emit_progress_ticks(prev, sink.n_words)
            free_q.put(bi)

    th = threading.Thread(target=pump, daemon=True)
    th.start()
    try:
        more = 1
        while more:
            bi = free_q.get()
            more = lib.fgx_multi_stream_next(
                st, bufs2[bi], CHUNK, ctypes.byref(n_out),
                ctypes.byref(s_out))
            m = n_out.value
            if m:
                q.put((bi, m, int(s_out.value)))
            else:
                free_q.put(bi)
    finally:
        q.put(None)
        th.join()
        lib.fgx_multi_stream_free(st)


def compare_multi(paths: list[str], op: str, outputname: str = "out",
                  cutoff: int = 1, rule: str = "default",
                  count_override: int = 1, count_only: bool = False,
                  bucket_target: int = DEFAULT_BUCKET, debug: int = 0,
                  device=None, mesh=None):
    """N-list union/intersection (N > 2). ``device``: where the device
    route runs (None: CUDA), in buckets of at most ``bucket_target`` + N
    words; ``mesh``: the slots that take those buckets in turn, as in
    ``compare_pair``."""
    mesh = _group_mesh(device, mesh)
    on_host = _host_route() and not _grouped(mesh)
    with trace.span("compare"):
        data = [_read(p) for p in paths]
        wlen = data[0][0].word_length
        # the reference validates rules per op with its enum number in the
        # message and exit code 1 (src/glistcompare.c:518-523,617-623)
        eff = RULES[rule] if rule in RULES else "number"
        if op == "union" and eff not in ("default", "add", "max", "number"):
            sys.stderr.write(
                "union_multi: Invalid rule %d (only ADD, MAX and NUMBER "
                "allowed)\n" % RULE_NUMBERS[eff])
            raise SystemExit(1)
        if op == "intrsec" and eff not in ("default", "add", "min", "max",
                                           "number"):
            sys.stderr.write(
                "intersect_multi: Invalid rule %d (only ADD, MIN, MAX and "
                "NUMBER allowed)\n" % RULE_NUMBERS[eff])
            raise SystemExit(1)

        writer = mesh is None or mesh.writer
        with trace.span("write"):
            sink = _OpSink(op, _op_filename(outputname, wlen, op), wlen,
                           count_only or not writer,
                           debug=debug if writer else 0)
        if on_host:
            _host_compare_multi(sink, data, op, rule, cutoff,
                                count_override, debug)
            sink.close()
            return {op: (sink.n_words, sink.total_count)}

        words = [w for _, w, _ in data]
        counts = [c for _, _, c in data]
        for w, c in multi_parts(words, counts, op, RULES.get(rule, "number"),
                                cutoff, count_override, device, mesh,
                                bucket_target):
            if len(w):
                with trace.span("write"):
                    sink.append(w, c)
        with trace.span("write"):
            sink.close()
    _publish(mesh)
    return {op: (sink.n_words, sink.total_count)}


def compare_pair_mm(list1: str, list2: str, ops: list[str],
                    outputname: str = "out", cutoff: int = 1, nmm: int = 1,
                    subtract: bool = False, count_only: bool = False,
                    chunk: int = 4096, debug: int = 0):
    """Mismatch-tolerant difference (src/glistcompare.c:957-1169).

    diff1 keeps words of list1 (passing the exact-match difference test)
    whose exactly-m neighborhoods, for every m in 1..nmm, stay below the
    cutoff in list2. Quirks replicated:
    * the candidate zipper computes cutoff flags from ORIGINAL freqs but
      the stored freq uses the subtract-modified freq2
      (src/glistcompare.c:1030-1047) including u32 wraparound;
    * subtract mode drops a candidate outright when any neighbor's count
      in list2 exceeds its count in list1 (search_query returns ~0,
      src/glistcompare.c:1140-1146);
    * ddiff never uses subtraction in its neighborhood pass (reference
      would dereference NULL; see fetch_relevant_words call :1105).
    """
    from genometester4_tpu_torch.ops.encode import canonical_u64
    from genometester4_tpu_torch.ops.mismatch import (exact_mismatch_masks,
                                                      lookup_counts)

    h1, w1, c1 = read_word_source(list1)
    h2, w2, c2 = read_word_source(list2)
    k = h1.word_length
    w1 = np.asarray(w1)
    w2 = np.asarray(w2)

    if debug:
        # compare_wordmaps_mm's own header (src/glistcompare.c:1005-1008)
        sys.stderr.write("Table 1: %d entries\n" % len(w1))
        sys.stderr.write("Table 2: %d entries\n" % len(w2))

    all_w = np.union1d(w1, w2)
    f1 = lookup_counts(w1, np.asarray(c1), all_w).astype(np.uint32)
    f2 = lookup_counts(w2, np.asarray(c2), all_w).astype(np.uint32)
    p1, p2 = f1 > 0, f2 > 0
    ge1, ge2 = f1 >= np.uint32(cutoff), f2 >= np.uint32(cutoff)
    # subtract modifies freq2 in the equal-words branch before both checks
    f2e = np.where(p1 & p2 & subtract & (f1 <= f2), f2 - f1, f2)

    candidates = {}
    if "diff1" in ops:
        eq = p1 & p2 & ge1 & ~ge2
        only1 = p1 & ~p2 & ge1 & (not subtract)
        freqs = np.where(eq, f1 - f2e, f1).astype(np.uint32)  # u32 wrap ok
        mask = eq | only1
        candidates["diff1"] = (all_w[mask], freqs[mask], w2, c2, w1, c1,
                               subtract)
    if "diff2" in ops:
        eq = p1 & p2 & ge2 & ~ge1
        only2 = p2 & ~p1 & ge2
        freqs = np.where(eq, f2e - f1, f2).astype(np.uint32)
        mask = eq | only2
        candidates["diff2"] = (all_w[mask], freqs[mask], w1, c1, None, None,
                               False)

    def _present(words_sorted, queries):
        idx = np.searchsorted(words_sorted, queries)
        idx_c = np.minimum(idx, max(len(words_sorted) - 1, 0))
        if len(words_sorted) == 0:
            return np.zeros(len(queries), bool)
        return (idx < len(words_sorted)) & (words_sorted[idx_c] == queries)

    use_native = os.environ.get("GT4_MM_IMPL", "native") != "numpy"
    results = {}
    for op, (cw, cf, mw, mc, qw, qc, sub) in candidates.items():
        if debug and op == "diff1":
            # only find_diff announces itself (src/glistcompare.c:1058-1061)
            sys.stderr.write("Finding diff with mismatches (%d entries)\n"
                             % len(cw))
        if use_native:
            # per-candidate early exit (the running present-count is
            # monotone in non-subtract mode, and subtract mode bails on
            # the first over-present neighbor) — numpy must always
            # materialize the whole neighborhood (fgx_mm_filter;
            # GT4_MM_IMPL=numpy keeps the vectorized twin for the
            # differential tests)
            from genometester4_tpu_torch.utils.native import get_lib
            lib = get_lib()
            alive8 = np.ones(len(cw), np.uint8)
            cwc = np.ascontiguousarray(cw, np.uint64)
            mwc = np.ascontiguousarray(mw, np.uint64)
            qwc = (np.ascontiguousarray(qw, np.uint64) if sub
                   else np.zeros(1, np.uint64))
            for m in range(1, nmm + 1):
                masks = np.ascontiguousarray(exact_mismatch_masks(k, m))
                lib.fgx_mm_filter(cwc, len(cwc), k, masks, len(masks),
                                  mwc, len(mwc), qwc,
                                  len(qwc) if sub else 0,
                                  cutoff, int(sub), alive8)
            alive = alive8.astype(bool)
            out_w, out_c = cw[alive], cf[alive]
            path = _op_filename(outputname, k, op, nmm)
            if not count_only:
                write_list(path, k, out_w, out_c)
            results[op] = (len(out_w), int(out_c.astype(np.uint64).sum()))
            continue
        alive = np.ones(len(cw), bool)
        for m in range(1, nmm + 1):
            masks = exact_mismatch_masks(k, m)
            idx_alive = np.flatnonzero(alive)
            for s in range(0, len(idx_alive), chunk):
                sel = idx_alive[s:s + chunk]
                neigh = canonical_u64(
                    cw[sel, None] ^ masks[None, :], k).reshape(-1)
                # gt4_word_dict_lookup returns the FOUND FLAG, not the
                # count (the count goes into inst->value, which
                # search_query never reads — src/word-dict.c:61-71,
                # src/glistcompare.c:1114-1127): the neighborhood sum is
                # the number of PRESENT neighbor words (fuzz finding)
                cur = _present(mw, neigh).astype(np.int64)
                if sub:
                    qf = _present(qw, neigh).astype(np.int64)
                    bad = (cur > qf).reshape(len(sel), -1).any(axis=1)
                    s_sum = ((cur - qf).reshape(len(sel), -1).sum(axis=1)
                             & 0xFFFFFFFF)
                    drop = bad | (s_sum >= cutoff)
                else:
                    s_sum = cur.reshape(len(sel), -1).sum(axis=1) & 0xFFFFFFFF
                    drop = s_sum >= cutoff
                alive[sel[drop]] = False
        out_w, out_c = cw[alive], cf[alive]
        path = _op_filename(outputname, k, op, nmm)
        if not count_only:
            write_list(path, k, out_w, out_c)
        results[op] = (len(out_w), int(out_c.astype(np.uint64).sum()))
    return results


def make_subset(list_path: str, method: str, size: int, outputname: str,
                seed: int):
    """Random subsetting (-ss): exact drand48 stream parity with the
    reference (src/glistcompare.c:719-787)."""
    h, words, counts = read_word_source(list_path)
    out_path = f"{outputname}_subset_{h.word_length}.list"
    METHODS = {"rand": 0, "rand_unique": 1, "rand_weighted_unique": 2}
    if method in METHODS:
        # native selection loop: glibc srand48/drand48 IS the
        # reference's PRNG, so the stream is bit-exact by construction
        # (src/glistcompare.c:719-787); the Python Rand48 twin below
        # remains the differential oracle for the stream itself.
        import ctypes

        from genometester4_tpu_torch.utils.backend import disable_numpy_thp
        from genometester4_tpu_torch.utils.native import get_lib
        disable_numpy_thp()   # multi-MB buffers below
        if method != "rand" and size > h.n_words:
            raise ValueError("subset size bigger than number of unique kmers")
        lib = get_lib()
        raw = record_bytes(words, counts)
        out_buf = np.empty(max(12, 12 * h.n_words), np.uint8)
        tot = ctypes.c_ulonglong(0)
        # in = the header's total (inst->sum_counts IS header->total for
        # a list source, src/glistcompare.c:735) — no counts-column scan
        m = lib.fgx_subset(raw, h.n_words, int(h.total_count),
                           METHODS[method], size, seed, out_buf,
                           ctypes.byref(tot))
        with ListWriter(out_path, h.word_length) as w:
            w.append_records(out_buf[: 12 * m], m, tot.value)
        return out_path
    rng = Rand48(seed)
    sel_words, sel_counts = [], []
    out = size
    if method == "rand":
        # one draw per count unit until `out` exhausted. Drawing a whole
        # word's values at once over-advances the PRNG only after `out`
        # hits 0, when the reference stops drawing too — harmless.
        inn = int(counts.sum(dtype=np.uint64))
        for wi in range(len(words)):
            if out <= 0:
                break
            c = int(counts[wi])
            vals = rng.drand_array(c)
            acc = 0
            for v in vals:
                if out <= 0:
                    break
                if v <= out / inn:
                    acc += 1
                    out -= 1
                inn -= 1
            if acc > 0:
                sel_words.append(int(words[wi]))
                sel_counts.append(acc)
    elif method == "rand_unique":
        if size > h.n_words:
            raise ValueError("subset size bigger than number of unique kmers")
        inn = h.n_words
        for wi in range(len(words)):
            if out <= 0:
                break
            if rng.drand() <= out / inn:
                sel_words.append(int(words[wi]))
                sel_counts.append(int(counts[wi]))
                out -= 1
            inn -= 1
    elif method == "rand_weighted_unique":
        if size > h.n_words:
            raise ValueError("subset size bigger than number of unique kmers")
        inn = int(counts.sum(dtype=np.uint64))
        for wi in range(len(words)):
            if out <= 0:
                break
            c = int(counts[wi])
            if rng.drand() <= c * out / inn:
                sel_words.append(int(words[wi]))
                sel_counts.append(c)
                out -= 1
            inn -= c
    else:
        raise ValueError(f"unknown subset method {method}")

    write_list(out_path, h.word_length, np.array(sel_words, np.uint64),
               np.array(sel_counts, np.uint32))
    return out_path
