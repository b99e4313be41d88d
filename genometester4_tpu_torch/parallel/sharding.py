"""glistmaker's mesh counting route: prefix-sharded k-mer counting over a
("dp", "kp") mesh (port of the counting half of
``genometester4_tpu/parallel/sharding.py``).

The mesh has dp rows and kp columns of slots, each naming a torch device.
Row r reads its own input chunks; column j owns the j-th of kp equal
ranges of the word space (its top log2(kp) bits), so the columns' sorted
outputs concatenate into one sorted list. Per step (dp * kp chunks)::

  per slot     count_chunk: kernel A, torch.sort, kernel B (unique keys
               and counts)
               _route_by_prefix: kp contiguous slices into [kp, cap] buckets
  exchange     column j takes bucket j of every slot (JAX: all_to_all over
               kp, then all_gather over dp) as tensor moves to the device of
               the column's row-0 slot: peer copies between cards, no-ops
               within one
  per column   merge_gathered_sources over the S = dp * kp sources: the
               identity (S = 1), a weighted re-sort (``resort``, the
               default) or log2(S2) merge rounds through kernel E
               (``bitonic``), chosen by GT4_TPU_MESH_MERGE as in JAX

JAX's result is dp-replicated, so each column merges once, on its row-0
slot, with the same output. A device may fill several slots (a mesh of 8
slots on one card, as the JAX tests run 8 virtual CPU devices); the slots
then run one after another.

glistcompare on a mesh (``sharded_pair_ops``, ``sharded_multi_op``): the
inputs are cut at the quantiles of their combined rank into buckets of
at most the device route's target, at least one a slot
(``pipelines.listcompare.bucket_cuts``); slot d runs the set operations
of buckets d, d + S, ... on its own device, the slots of distinct cards
side by side, and the outputs concatenate in bucket order. JAX packs the
buckets into [n_dev, cap] padded arrays because shard_map needs one
shape; here each bucket goes to its slot as its own unpadded slice.

In a process group (``parallel.multihost.make_global_mesh``) row r is
process r's slots, and the rows of other processes hold None: each
process runs its own row's slots, and column j's sources come together on
process 0 (the one writer), which merges every column; the others return
empty columns. The overflow flag and the peak bucket fill are the
group's, so every process retries and adapts alike.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from genometester4_tpu_torch.formats.list_format import (RECORD_DTYPE,
                                                         record_bytes)
from genometester4_tpu_torch.ops.encode import SIGN, keys_from_pair
from genometester4_tpu_torch.ops.merge_runs import merge_sorted_runs
from genometester4_tpu_torch.ops.sortcount import count_unique
from genometester4_tpu_torch.parallel import multihost
from genometester4_tpu_torch.pipelines.listmaker import (HostShard,
                                                         count_chunk,
                                                         merge_sorted_shards,
                                                         to_host, upload)
from genometester4_tpu_torch.utils import trace
from genometester4_tpu_torch.utils.device import resolve_device

# bucket slack over the uniform share (the JAX package's CAP_FACTOR)
CAP_FACTOR = 3

# key of the all-ones word: above every canonical word (min(w, revcomp) is
# never all ones), so the bitonic merge's padding sorts last
SENTINEL = (1 << 63) - 1
_U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class Mesh:
    """dp rows of kp slots; ``devices[r][c]`` is slot (r, c)'s device.
    ``rank``: in a process group, this process's row (the other rows'
    slots are None); None when every row is this process's."""
    devices: tuple
    rank: int | None = None

    @property
    def shape(self) -> dict:
        return {"dp": len(self.devices), "kp": len(self.devices[0])}

    @property
    def slots(self) -> list:
        """Every slot's device, row by row (JAX's flat ("sp",) mesh)."""
        return [d for row in self.devices for d in row]

    @property
    def writer(self) -> bool:
        """Whether this process gathers the results and writes them."""
        return not self.rank

    def local(self, row: int) -> bool:
        """Whether row ``row``'s slots are this process's."""
        return self.rank is None or row == self.rank


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              devices=None) -> Mesh:
    """Build a ("dp", "kp") mesh: over ``devices`` (a list of device names,
    one per slot, repeats allowed) or every visible CUDA card.

    JAX's rule: without ``dp`` the largest power of two of slots goes to
    kp and dp takes what is left; kp must be a power of two."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if n == 0:
        raise RuntimeError("no device for the mesh: no CUDA card is "
                           "visible; pass devices=")
    if dp is None:
        kp = 1 << (n.bit_length() - 1)
        dp = n // kp
    else:
        kp = n // dp
    if kp < 1 or kp & (kp - 1):
        raise ValueError(f"kp={kp} ({n} slots, dp={dp}) is not a power of 2")
    return Mesh(tuple(tuple(devs[r * kp:(r + 1) * kp]) for r in range(dp)))


def _owner_shard(keys: torch.Tensor, k: int, n_shards: int) -> torch.Tensor:
    """Top log2(n_shards) bits of each key's 2k-bit word: its column.
    Sharding by the most significant bits keeps shard-major concatenation
    in .list order."""
    if n_shards <= 1:
        return torch.zeros_like(keys)
    b = n_shards.bit_length() - 1
    if b > 2 * k:
        raise ValueError(f"{n_shards} shards need words of at least {b} bits")
    # int64 >> is arithmetic: mask to the b bits (k = 32 words use bit 63)
    return ((keys ^ SIGN) >> (2 * k - b)) & (n_shards - 1)


def _route_by_prefix(keys: torch.Tensor, counts: torch.Tensor, k: int,
                     n_shards: int, cap: int):
    """Sorted unique keys and counts (int64) -> (bucket keys [n_shards,
    cap], bucket counts [n_shards, cap], per-bucket entries list[int],
    overflow). Bucket b holds the keys of column b, which are contiguous
    in the sorted input, in its first min(n_b, cap) slots and zeros after;
    overflow is any n_b > cap."""
    owner = _owner_shard(keys, k, n_shards)
    bounds = torch.searchsorted(
        owner, torch.arange(n_shards + 1, device=keys.device)).tolist()
    bn = [bounds[b + 1] - bounds[b] for b in range(n_shards)]
    bk = keys.new_zeros((n_shards, cap))
    bc = counts.new_zeros((n_shards, cap))
    for b in range(n_shards):
        m = min(bn[b], cap)
        bk[b, :m] = keys[bounds[b]:bounds[b] + m]
        bc[b, :m] = counts[bounds[b]:bounds[b] + m]
    return bk, bc, bn, max(bn) > cap


def buckets_from_pairs(bh, bl, bc, bn):
    """JAX's gathered sources -- (hi, lo, count) u32 [S, cap] and int32
    valid lengths [S], numpy -- as this module's (keys int64 [S, cap],
    counts int64 [S, cap], lengths list[int]) on the CPU."""
    bh = np.asarray(bh)
    keys = keys_from_pair(bh.ravel(), np.asarray(bl).ravel()).view(bh.shape)
    counts = torch.from_numpy(np.asarray(bc, np.uint32).astype(np.int64))
    return keys, counts, [int(x) for x in np.asarray(bn)]


def _pad_out(keys, counts, n_uniq: int, merge_cap: int):
    """JAX's output shapes: the first n_uniq entries, zeros after."""
    mk = keys.new_zeros(merge_cap)
    mc = counts.new_zeros(merge_cap)
    m = min(n_uniq, keys.numel(), merge_cap)
    mk[:m] = keys[:m]
    mc[:m] = counts[:m]
    return mk, mc


def merge_gathered_sources(keys, counts, n, *, S: int, S2: int, cap: int,
                           cap2: int, merge_cap: int,
                           mode: str | None = None):
    """Merge S sources, each sorted and deduplicated, into one.

    ``keys``/``counts``: int64 [S, cap], counts below 2^32; ``n``: each
    source's valid length. Returns (keys int64[merge_cap], counts
    int64[merge_cap], n_uniq, overflow): the unique keys in the first
    n_uniq slots, their summed counts wrapped to u32, zero counts after.
    ``mode`` (default GT4_TPU_MESH_MERGE, as in JAX): ``bitonic`` merges
    through kernel E, anything else re-sorts; S = 1 is the identity.
    """
    if mode is None:
        mode = os.environ.get("GT4_TPU_MESH_MERGE", "auto")
    n = [int(x) for x in n]
    if S == 1:
        return (*_pad_out(keys[0], counts[0], n[0], merge_cap), n[0], False)

    if mode != "bitonic":
        # compact the sources in forward order (each write's tail is
        # overwritten by the next source), then a weighted count (the
        # sort and kernel B)
        offs = np.concatenate([[0], np.cumsum(n)]).tolist()
        total = offs[S]
        lim = merge_cap - cap
        mk = keys.new_zeros(merge_cap)
        mc = counts.new_zeros(merge_cap)
        for s in range(S):
            o = min(offs[s], lim)
            mk[o:o + cap] = keys[s]
            mc[o:o + cap] = counts[s]
        m = min(total, merge_cap)
        uk, uc, n_uniq = count_unique(mk[:m], mc[:m])
        return (*_pad_out(uk, uc, n_uniq, merge_cap), n_uniq, total > lim)

    # sentinel tails with count 0, padded to S2 runs of cap2, then
    # log2(S2) rounds of pairwise merges
    nt = torch.tensor(n, device=keys.device)
    vmask = torch.arange(cap, device=keys.device)[None, :] < nt[:, None]
    sk = torch.full((S2, cap2), SENTINEL, dtype=torch.int64,
                    device=keys.device)
    sc = torch.zeros((S2, cap2), dtype=torch.int64, device=keys.device)
    sk[:S, :cap] = keys.masked_fill(~vmask, SENTINEL)
    sc[:S, :cap] = counts.masked_fill(~vmask, 0)
    sk, sc = sk.view(-1), sc.view(-1)
    L = cap2
    while L < S2 * cap2:
        sk, sc = merge_sorted_runs((sk, sc), L)
        L *= 2
    # the valid entries lead the stream: truncate before the dedupe
    total = sum(n)
    tlen = min(merge_cap, S2 * cap2)
    sk, sc = sk[:tlen], sc[:tlen]
    first = torch.ones(tlen, dtype=torch.bool, device=sk.device)
    first[1:] = sk[1:] != sk[:-1]
    head = first & (torch.arange(tlen, device=sk.device) < total)
    # run sums by doubling: a word is in at most S sources, and in a
    # sorted stream equal endpoints mean an equal span
    dd = 1
    while dd < S2:
        same = torch.zeros(tlen, dtype=torch.bool, device=sk.device)
        same[:-dd] = sk[dd:] == sk[:-dd]
        nxt = torch.zeros_like(sc)
        nxt[:-dd] = sc[dd:]
        sc = (sc + nxt.masked_fill(~same, 0)) & _U32
        dd *= 2
    idx = torch.nonzero(head).flatten()
    return (*_pad_out(sk[idx], sc[idx], idx.numel(), merge_cap), idx.numel(),
            total > tlen)


def _gather_column(mesh: Mesh, mine: list, j: int, cap: int, peak: int):
    """Column j's sources of every process of a group, on process 0:
    each process sends bucket j of its row's slots (``mine``: their
    (keys, counts, lengths) buckets), cut to the group's peak fill (what
    lies past it is zeros), and process 0 lays the dp * kp sources out as
    the single-process step does: (keys [S, cap], counts [S, cap],
    lengths) on column j's device. (None, None, None) elsewhere."""
    width = max(peak, 1)
    home = mesh.devices[mesh.rank][0]
    payload = torch.stack([torch.stack([bk[j, :width].to(home),
                                        bc[j, :width].to(home)])
                           for bk, bc, _ in mine])
    lengths = torch.tensor([bn[j] for _, _, bn in mine], dtype=torch.int64)
    got = multihost.gather_to_writer(payload)
    got_n = multihost.gather_to_writer(lengths)
    if got is None:
        return None, None, None
    dev = mesh.devices[0][j]
    rows = torch.cat(got).to(dev)            # [S, 2, width]
    keys = rows.new_zeros((rows.shape[0], cap))
    counts = rows.new_zeros((rows.shape[0], cap))
    keys[:, :width] = rows[:, 0]
    counts[:, :width] = rows[:, 1]
    return keys, counts, torch.cat(got_n).tolist()


def sharded_count_step(mesh: Mesh, k: int, chunk_bases: int,
                       cap_factor: float = CAP_FACTOR):
    """The counting step of a mesh (JAX's ``sharded_count_step`` and
    ``_build_count_step``, with the same cap, merge_cap, S2 and cap2; no
    memoization: nothing is compiled).

    Returns (fn, cap * kp * dp). ``fn(blocks)`` takes uint8[dp, kp,
    chunk_bases] (one chunk per slot) and returns (columns, peak bucket
    fill): per column, its sorted unique (words u64, counts u32) numpy
    arrays, copied to the host as each column finishes so that its device
    buffers are free for the next; columns is None when a bucket or a
    merge overflowed (anywhere in a group). On a group's mesh ``fn`` runs
    this process's row, and the columns of processes but 0 are empty.
    """
    dp, kp = mesh.shape["dp"], mesh.shape["kp"]
    if kp & (kp - 1):
        raise ValueError(f"kp={kp} is not a power of 2")
    n_windows = chunk_bases - k + 1
    cap_soft = max(1, int(cap_factor * max(1, n_windows // kp)))
    # a bucket never holds more than its slot's windows
    cap = int(min(cap_soft, n_windows))
    # merge output: 2x the all-unique column load, divided by the CONSTANT
    # factor so that the overflow retry grows it (sharding.py:343-359)
    merge_cap = min(2 * dp * kp * cap_soft // CAP_FACTOR, dp * kp * cap) + cap
    S = dp * kp
    if S == 1:
        merge_cap = cap
    S2 = 1 << max(0, math.ceil(math.log2(S)))
    cap2 = 1 << max(0, math.ceil(math.log2(max(1, cap))))

    def fn(blocks: np.ndarray):
        buckets = {}
        peak = ovf = 0
        for r in range(dp):
            for c in range(kp):
                if ovf or not mesh.local(r):
                    continue
                codes, = upload(torch.from_numpy(blocks[r, c]),
                                device=mesh.devices[r][c])
                keys, counts = count_chunk(codes, k)
                del codes
                bk, bc, bn, ovf = _route_by_prefix(keys, counts, k, kp, cap)
                del keys, counts
                buckets[r, c] = (bk, bc, bn)
                peak = max(peak, max(bn))
        if mesh.rank is not None:
            ovf, peak = multihost.all_max([int(ovf), peak])
        if ovf:
            return None, 0
        sources = [buckets[s] for s in sorted(buckets)]   # slot order
        columns = []
        ovf = False
        for j in range(kp):
            with trace.span("merge"):   # column j
                if mesh.rank is None:
                    dev = mesh.devices[0][j]
                    keys = torch.stack([bk[j].to(dev)
                                        for bk, _, _ in sources])
                    counts = torch.stack([bc[j].to(dev)
                                          for _, bc, _ in sources])
                    n = [bn[j] for _, _, bn in sources]
                else:
                    keys, counts, n = _gather_column(mesh, sources, j, cap,
                                                     peak)
                if keys is None or ovf:   # not the writer, or failed
                    continue
                mk, mc, n_uniq, ovf = merge_gathered_sources(
                    keys, counts, n, S=S, S2=S2, cap=cap, cap2=cap2,
                    merge_cap=merge_cap)
                del keys, counts
                if ovf:
                    continue
                columns.append(to_host(mk[:n_uniq], mc[:n_uniq]))
                del mk, mc
        if mesh.rank is not None:
            ovf = multihost.all_max([int(ovf)])[0]
        if ovf:
            return None, 0
        if not mesh.writer:
            columns = [(np.empty(0, np.uint64), np.empty(0, np.uint32))] * kp
        return columns, peak

    return fn, cap * kp * dp


def iter_count_kmers_sharded(codes: np.ndarray, k: int, mesh: Mesh,
                             chunk_bases: int | None = None,
                             cap_factor="auto",
                             adapt_state: dict | None = None):
    """Count the canonical k-mers of a code array on the mesh; yield sorted
    (words u64, counts u32) numpy buckets in ascending order.

    dp * kp chunks per step, overlapped by k-1 bases, padded with 255. An
    overflow doubles ``cap_factor`` and runs the step again.
    ``cap_factor="auto"`` starts from CAP_FACTOR (or ``adapt_state``'s
    carried factor) and, after each step, shrinks to 1.5x the peak bucket
    fill once that is below the factor / 1.3 (floor 0.02), storing it in
    ``adapt_state`` for the caller's next slab. Per column, the steps'
    results merge with ``merge_sorted_shards``. On a group's mesh only
    process 0 yields; the others count their rows and yield nothing.
    """
    dp, kp = mesh.shape["dp"], mesh.shape["kp"]
    n_dev = dp * kp
    auto = cap_factor == "auto"
    if auto:
        cap_factor = (adapt_state or {}).get("cap_factor", CAP_FACTOR)
    if chunk_bases is None:
        chunk_bases = max(1 << 14, len(codes) // n_dev + k)
        chunk_bases = 1 << math.ceil(math.log2(chunk_bases))
    fn, _ = sharded_count_step(mesh, k, chunk_bases, cap_factor)

    # the codes a step sends to this process's rows, ``real`` of them the
    # input's and the rest padding
    sent = kp * chunk_bases * sum(mesh.local(r) for r in range(dp))

    def run_step(blocks, real: int):
        with trace.span("step"):
            trace.count("mesh.steps")
            trace.count("count.slots", sent)
            trace.count("count.pad", sent - real)
            return fn(blocks)

    step = chunk_bases - (k - 1)
    starts = list(range(0, max(len(codes) - (k - 1), 1), step))
    shard_results = []   # per step, kp (words, counts)
    for gi in range(0, len(starts), n_dev):
        with trace.span("pad"):
            blocks = np.full((n_dev, chunk_bases), 255, np.uint8)
            real = 0
            for bi, s in enumerate(starts[gi:gi + n_dev]):
                if mesh.local(bi // kp):   # a group fills its own row only
                    chunk = codes[s:s + chunk_bases]
                    blocks[bi, :len(chunk)] = chunk
                    real += len(chunk)
            blocks = blocks.reshape(dp, kp, chunk_bases)
        columns, peak = run_step(blocks, real)
        while columns is None:
            cap_factor *= 2
            trace.count("mesh.reruns")
            fn, _ = sharded_count_step(mesh, k, chunk_bases, cap_factor)
            columns, peak = run_step(blocks, real)
        if auto:
            want = 1.5 * max(peak, 1) / max(1, (chunk_bases - k + 1) // kp)
            if want < cap_factor / 1.3:
                cap_factor = max(want, 0.02)
                fn, _ = sharded_count_step(mesh, k, chunk_bases, cap_factor)
            if adapt_state is not None:
                adapt_state["cap_factor"] = cap_factor
        shard_results.append(columns)

    if not mesh.writer:
        return
    # prefix columns are disjoint ascending word ranges: merging each
    # column's step results in turn streams the globally sorted list
    for s in range(kp):
        yield from merge_sorted_shards([res[s] for res in shard_results],
                                       device=mesh.devices[0][0])


def count_kmers_sharded(codes: np.ndarray, k: int, mesh: Mesh,
                        chunk_bases: int | None = None, cap_factor="auto",
                        adapt_state: dict | None = None):
    """Materializing wrapper over iter_count_kmers_sharded: the span
    "count", with each step ("step") and its column merges ("merge")
    inside, the merges of the steps' columns ("merge") and their
    concatenation ("gather"): one ``HostShard`` of the columns' records,
    with the sum of their totals where each has one."""
    with trace.span("count"):
        out = list(iter_count_kmers_sharded(codes, k, mesh, chunk_bases,
                                            cap_factor, adapt_state))
        if not out:
            return np.empty(0, np.uint64), np.empty(0, np.uint32)
        with trace.span("gather"):   # the columns' records, end to end
            recs = np.concatenate([record_bytes(w, c) for w, c in out])
            recs = recs.view(RECORD_DTYPE)
            totals = [getattr(part, "total", None) for part in out]
            return HostShard(recs["word"], recs["count"],
                             None if None in totals else sum(totals))


def sharded_pair_op(words1, counts1, words2, counts2, mesh: Mesh, op: str,
                    rule: str = "default", cutoff: int = 1,
                    count_override: int = 1, subtract: bool = False):
    """One glistcompare pair operation over every slot of the mesh."""
    return sharded_pair_ops(words1, counts1, words2, counts2, mesh, [op],
                            rule, cutoff, count_override, subtract)[op]


def _concat(parts):
    """Per-part (words u64, counts u32) pieces -> one pair of arrays."""
    parts = list(parts)
    if not parts:
        return np.empty(0, np.uint64), np.empty(0, np.uint32)
    return (np.concatenate([w for w, _ in parts]),
            np.concatenate([c for _, c in parts]))


def sharded_pair_ops(words1, counts1, words2, counts2, mesh: Mesh, ops,
                     rule: str = "default", cutoff: int = 1,
                     count_override: int = 1, subtract: bool = False):
    """glistcompare pair operations over every slot of the mesh.

    words/counts are sorted unique u64/u32 arrays (a ``.list`` mmap's
    columns will do). The parts are those ``compare_pair`` streams to its
    files on a mesh (``pipelines.listcompare.pair_parts``): buckets cut
    at the quantiles of the combined word population, at most
    ``listcompare.DEFAULT_BUCKET`` + 2 words each and at least one a
    slot, dealt round-robin over the slots; each part aligns once on its
    slot's device, and that table feeds every
    requested op (the reference zipper's one pass to four outputs,
    src/glistcompare.c:843-905). Returns {op: (words, counts)}, sorted
    (on a group's mesh, on process 0; the others' are empty). ``rule``
    is an ``ops.setops`` rule.
    """
    from genometester4_tpu_torch.pipelines import listcompare
    ops = list(ops)
    outs = list(listcompare.pair_parts(
        words1, counts1, words2, counts2, ops, rule, cutoff, count_override,
        subtract, mesh=mesh))
    return {op: _concat(out[op] for out in outs) for op in ops}


def sharded_multi_op(word_lists, count_lists, mesh: Mesh, op: str,
                     rule: str = "default", cutoff: int = 1,
                     count_override: int = 1):
    """N-list union/intersection over the mesh (glistcompare multi).

    The parts of ``compare_multi`` on a mesh
    (``pipelines.listcompare.multi_parts``), cut and dealt as in
    ``sharded_pair_ops``: each part takes every list's slice of its
    bucket and runs the N-way reduction on its slot's device
    (src/glistcompare.c:500-717 semantics: cutoff on the COMBINED
    frequency, intersection requires presence in all N lists). Returns
    (words, counts), sorted.
    """
    from genometester4_tpu_torch.pipelines import listcompare
    return _concat(listcompare.multi_parts(
        word_lists, count_lists, op, rule, cutoff, count_override,
        mesh=mesh))
