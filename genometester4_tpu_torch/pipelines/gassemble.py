"""gassembler equivalent: KATK local-reassembly variant caller (the port's
copy of ``genometester4_tpu/pipelines/gassemble.py``).

Reference pipeline (src/gassembler.c, SURVEY.md §3.5): per region
(chr, start, end, ref, k-mers) pull reads from the read index, align
them to the reference (affine SW), build a gapped multi-alignment,
greedily merge reads into haplotype groups by their divergent-position
tags, and call each aligned column with logistic quality models.

Layout here:
  * batched wavefront SW (ops.swalign) — the compute-heavy kernel;
  * everything else is numpy/python — grouping and calling are small,
    data-dependent, and inherently sequential (SURVEY.md §7);
  * glibc rand() (via the native library) reproduces the reference's
    coverage sampling and read subsampling streams (srand(1));
  * output is byte-identical versus a single-threaded reference run
    (multi-threaded reference output depends on thread scheduling).

On the port the SW fill of every region runs on the ``Assembler``'s
device: kernel C (``ops.swalign_cuda``, one launch per window of regions,
``Assembler.prefetch_device_sw``) on CUDA, its plain version
``ops.swalign.sw_fill`` on the CPU; traceback, filters and everything
after stay on the host, a region's traceback, filters and rows in one
native call over the fill's matrices (``csrc/swtrace.c``).
``GT4_TPU_DEVICE_SW=0`` and forked workers take the native host route
(``fgx_sw_align_region8``), as in the JAX package; ``-DDD`` fills and
traces each read on the host. torch is imported when the first
``Assembler`` is built.

Spans (``utils.trace``), under the CLI's job span "gassemble": "gather"
(the index lookups and the read fetch of a region), "sw" (the fill,
``ops.swalign_cuda``), "align" (traceback, filters, rows, the gapped
alignment and the divergence tags), "group" (the native group phase) and
"call" (the call phase, or the no-call fill of a failed region).
Counters: "katk.regions" (regions assembled), "katk.reads" (reads
gathered), "katk.aligned" (reads kept by the alignment filters) and
"align.native" (reads handed to the native traceback over filled
matrices).

All constants mirror src/gassembler.c:56-67 and the advanced-flag
defaults at src/gassembler.c:646-696.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field

import numpy as np

from genometester4_tpu_torch.ops import swalign
from genometester4_tpu_torch.utils import trace

# nucleotide codes (src/matrix.h:8-20)
A, C, G, T, N, GAP, NONE = 0, 1, 2, 3, 4, 5, 6
N2C = "ACGTN- "
BEFORE, AFTER, UNKNOWN = -1, -2, -3

CHR_NAMES = ["INVALID"] + [str(i) for i in range(1, 23)] + ["X", "Y", "MT"]
CHR_NONE, CHR_X, CHR_Y, CHR_MT = 0, 23, 24, 25

WORDLEN = 25
MAX_KMERS = 1024
MAX_READS_PER_KMER = 200
MAX_READS = 4096
MIN_READS = 10
MAX_ALIGNED_READS = 1024
MAX_READS_PER_REGION = 200
MAX_ENDGAP = 1
MAX_GAPS = 10

_C2N = np.full(256, N, np.int8)
for _c, _v in (("A", A), ("C", C), ("G", G), ("T", T), ("U", T)):
    _C2N[ord(_c)] = _v
    _C2N[ord(_c.lower())] = _v
_C2N[ord("-")] = GAP


def chr_from_string(s: str) -> int:
    """gt4_chr_from_string twin (src/sequence.c): strtol semantics —
    leading whitespace accepted, *end must be the terminator, the u32
    truncation makes negatives huge (> CHR_22 -> NONE). "" converts to
    0 == CHR_NONE."""
    if s == "X":
        return CHR_X
    if s == "Y":
        return CHR_Y
    if s == "MT":
        return CHR_MT
    from genometester4_tpu_torch.cli._cstrtol import strtol_u32
    val, ok = strtol_u32(s)
    if not ok or val > 22:
        return CHR_NONE
    return val


@dataclass
class Params:
    """Tuning flags (defaults: src/gassembler.c:28-67,646-670)."""
    min_coverage: int = 4
    min_p: float = 0.95
    min_pmut: float = 0.5
    sex: int = 0  # 0 auto, 1 male, 2 female
    output: int = 0  # 0 poly, 1 best, 2 all
    print_extra: int = 0
    error_prob: float = 0.001
    exome: bool = False
    coverage: float = 0.0  # 0 median, -1 local, -2 ignore, >0 value
    single_cutoff: int = 10
    min_confirming: int = 2
    min_group_coverage: int = 1
    max_divergent: int = 4
    min_align_len: int = 25
    min_group_size: int = 3
    min_group_rsize: float = 0.0
    max_group_divergence: int = 3
    max_group_rdivergence: int = 3
    skip_end_align: int = 10
    skip_end_call: int = 10
    require_both_dirs: bool = True
    alternative_calls: bool = False
    max_read_length: int = 200
    max_reference_length: int = 200
    print_reads: bool = False
    debug: int = 0
    debug_groups: int = 0
    db_name: str = ""     # -db path, echoed by the -DD Arguments trace


@dataclass(slots=True)
class Call:
    pos: int = 0
    sub: int = 0
    ref: int = 0
    cov: int = 0
    counts: np.ndarray = None
    nucl: tuple = (NONE, NONE)
    poly: int = 0
    prev_ref: str = "\0"
    p: float = 0.0
    q: float = 0.0
    p_det: float = 0.0
    extra: dict = field(default_factory=dict)


@dataclass
class CallBlock:
    chr: int
    start: int
    end: int
    haploid: bool
    calls: list = field(default_factory=list)
    _pos_list: object = None   # bisect cache (cli.gassembler._calls_at)


def _rand():
    from genometester4_tpu_torch.utils.native import get_lib
    return get_lib().fgx_rand()


RAND_MAX = 2147483647


def find_coverage(index, debug: int = 0) -> float:
    """Median read count of 10000 random index k-mers
    (src/gassembler.c:2725-2779); consumes glibc rand()."""
    MEDIAN_KMERS = 10000
    n_kmers = len(index.read_blocks)
    counts = np.zeros(MEDIAN_KMERS, np.int64)
    blocks = index.read_blocks.astype(np.int64)
    n_reads = index.n_reads
    ci = 0
    while ci < MEDIAN_KMERS:
        kmer_idx = _rand() % n_kmers
        start = blocks[kmer_idx]
        end = blocks[kmer_idx + 1] if kmer_idx < n_kmers - 1 else n_reads
        c = int(end - start)
        counts[ci] = c
        if not c:
            continue
        ci += 1
    mn = int(counts.min())
    mx = int(counts.max())
    if debug:
        sys.stderr.write("Sample min %u max %u\n" % (mn, mx))
    med = (mn + mx) // 2
    while mx > mn:
        med = (mn + mx) // 2
        below = int((counts < med).sum())
        above = int((counts > med).sum())
        equal = MEDIAN_KMERS - above - below
        if mx == mn + 1:
            if above > below + equal:
                med = mx
            break
        if above > below:
            if above - below < equal:
                break
            mn = med
        elif below > above:
            if below - above < equal:
                break
            mx = med
        else:
            break
    if debug:
        sys.stderr.write("Sample median %u\n" % med)
    return float(med)


def auto_sex(db) -> int:
    """Average index read count per A/X/Y k-mer class
    (src/gassembler.c:954-993). Returns 1 male / 2 female."""
    sys.stderr.write("Determine sex\n")
    blocks = db.index.read_blocks.astype(np.int64)
    n_reads = db.index.n_reads
    nxt = np.concatenate([blocks[1:], [n_reads]])
    kmer_counts = nxt - blocks
    sums = [0, 0, 0]
    counts = [0, 0, 0]
    for i in range(db.n_nodes):
        name = db.names[i]
        klass = 1 if name[:1] == b"X" else 2 if name[:1] == b"Y" else 0
        s = int(db.node_kmers_start[i])
        nk = int(db.node_nkmers[i])
        sums[klass] += int(kmer_counts[s:s + nk].sum())
        counts[klass] += nk
    if not counts[1]:
        sys.stderr.write("No X kmers found, cannot determine sex (use --sex)\n")
        raise SystemExit(1)
    # C double division: 0/0 is NaN, x/0 is inf — with no Y k-mers the
    # comparison below sees NaN and the reference calls the sample MALE
    with np.errstate(divide="ignore", invalid="ignore"):
        avg = [float(np.float64(sums[k]) / np.float64(counts[k]))
               for k in range(3)]
    for k in range(3):
        # x86 0.0/0 sets the NaN sign bit; glibc %.3f prints "-nan"
        # (Python renders plain "nan")
        avg_s = "-nan" if np.isnan(avg[k]) else "%.3f" % avg[k]
        sys.stderr.write("Klass %d kmers %d sum %d avg %s\n"
                         % (k, counts[k], sums[k], avg_s))
    with np.errstate(invalid="ignore"):
        is_female = bool(np.float64(100) * avg[2] / avg[1]
                         < np.float64(avg[1]) / avg[0])
    sex = 2 if is_female else 1
    sys.stderr.write("Sex: %s\n" % ("Male" if sex == 1 else "Female"))
    return sex


# ---------------------------------------------------------------------------
# read extraction
# ---------------------------------------------------------------------------

class SeqFilesError(Exception):
    """A sequence file named by the read index cannot be mapped; the
    CLI prints the reference's terminating line (src/gassembler.c:949-952)."""


class SeqFiles:
    """mmap'd FASTQ/FASTA sources named by the read index."""

    def __init__(self, names: list, seq_dir: str | None = None):
        import os

        from genometester4_tpu_torch.utils.gt4mmap import gt4_mmap_fail
        self.data = []
        self.names = []
        for nm in names:
            nm = nm.decode() if isinstance(nm, bytes) else nm
            if seq_dir:
                nm = os.path.join(seq_dir, os.path.basename(nm))
            self.names.append(nm)
            mf = gt4_mmap_fail(nm)
            if mf is not None:
                # map_sequences chrome (src/gassembler.c:2536-2545);
                # the caller prints the terminating line
                sys.stderr.write(mf)
                sys.stderr.write("Cannot memory map %s\n" % nm)
                raise SeqFilesError(nm)
            with open(nm, "rb") as f:
                self.data.append(f.read())
        self._ptrs = None

    def c_pointers(self):
        """(ptr_array, len_array) ctypes views of the file buffers for
        the native read-fetch kernel; built once."""
        if self._ptrs is None:
            import ctypes
            n = len(self.data)
            ptrs = (ctypes.c_void_p * n)()
            lens = (ctypes.c_longlong * n)()
            self._np_views = [np.frombuffer(d, np.uint8) for d in self.data]
            for i, v in enumerate(self._np_views):
                ptrs[i] = v.ctypes.data if len(v) else None
                lens[i] = len(v)
            self._ptrs = (ptrs, lens)
        return self._ptrs


_RC_TABLE = np.arange(256, dtype=np.uint8)
for _a, _b in ((65, 84), (84, 65), (67, 71), (71, 67)):  # A<->T C<->G
    _RC_TABLE[_a] = _b


@dataclass(slots=True)
class GASMRead:
    name: object          # bytes; decoded on demand (never consumed hot)
    seq_b: bytes          # oriented sequence bytes
    nucl: np.ndarray      # int8 codes
    dir: int              # bitmask 1<<dir like the reference
    tag: int = 0
    mask: int = 0
    unknown: int = 0
    group: int = 0

    @property
    def seq(self) -> str:
        return (self.seq_b.decode("latin1")
                if isinstance(self.seq_b, (bytes, bytearray))
                else self.seq_b)


def _print_db_reads(index, files, kmer_idx: int, kmer_dir: int):
    """print_db_reads twin (src/gassembler.c:2668-2723, -DDD only):
    per-kmer read dump — raw block value, per-read index decode line,
    then the read's name (sans its first byte) and sequence oriented to
    the k-mer's direction."""
    raw = int(index.read_blocks[kmer_idx])
    codes = index.kmer_reads(kmer_idx)
    first = raw if index.version >= (0, 4) else (raw >> 24)
    sys.stderr.write("Reads %u first %u num %u\n"
                     % (raw, first, len(codes)))
    kmer_pos, name_pos, file_idx, dirs = index.decode_reads(codes)
    for i in range(len(codes)):
        fi = int(file_idx[i])
        npos = int(name_pos[i])
        sys.stderr.write("%u %s %u %u %u (dir %u)\n" % (
            i, index.files[fi].decode("latin1"), fi, npos,
            int(kmer_pos[i]), int(dirs[i])))
        data = files.data[fi]
        # name: from name_pos+1 (the record's '@'/'>' byte is skipped)
        j = npos + 1
        e = j
        while e < len(data) and data[e] >= 0x20:
            e += 1
        sys.stderr.write(">" + bytes(data[j:e]).decode("latin1") + "\n")
        j = e
        while j < len(data) and data[j] < 0x20:
            j += 1
        e = j
        while e < len(data) and data[e] >= 0x20:
            e += 1
        seq = bytes(data[j:e])
        if int(dirs[i]) != kmer_dir:
            seq = seq[::-1].translate(bytes.maketrans(b"ACGT", b"TGCA"))
        sys.stderr.write(seq.decode("latin1") + "\n")


def _collect_read_infos(db, kmers: list, max_reads_per_kmer: int,
                        debug: int = 0, files=None):
    """The deterministic (rand-free) part of get_unique_reads: per-k-mer
    index lookups + (file, name_pos) dedup + MAX_READS cap. Split out so
    the parallel scheduler can precompute each region's rand()
    consumption (exactly MAX_READS_PER_REGION draws iff the unique-read
    count exceeds that cap) without touching the stream."""
    from genometester4_tpu_torch.ops.encode import (reverse_complement_u64,
                                              string_to_word)

    index = db.index
    blocks = index.read_blocks.astype(np.int64)
    n_reads_total = index.n_reads
    seen = {}
    infos = []  # (name_pos, file_idx, dir)
    for ki, km in enumerate(kmers):
        word = string_to_word(km, strict=False)
        rword = int(reverse_complement_u64(np.array([word], np.uint64),
                                           len(km))[0])
        cword = min(word, rword)
        code = db.lookup_code(cword)
        if not code:
            sys.stderr.write(f"No such kmer: {km}\n")
            raise SystemExit(0)
        kmer_dir = 1 if (code & 0x80000000) else 0
        if debug > 1:
            # src/gassembler.c:2575: code still carries the dir bit
            sys.stderr.write("Kmer %s word %u code %u\n" % (km, cword, code))
        code &= 0x7FFFFFFF
        node_idx = (code >> db.kmer_bits) - 1
        node_kmer = code & ((1 << db.kmer_bits) - 1)
        if not (0 <= node_idx < db.n_nodes
                and node_kmer < int(db.node_nkmers[node_idx])):
            # duplicate canonical k-mers in the DB sum their codes into
            # garbage (src/trie.c:266-282); the reference dereferences
            # the garbage node unchecked (src/gassembler.c:2578-2580,
            # undefined behavior). Fail cleanly instead.
            sys.stderr.write(
                "gassembler: corrupted database: k-mer %s decodes out of "
                "range (duplicate k-mers in the database?)\n" % km)
            raise SystemExit(1)
        kmer_idx = int(db.node_kmers_start[node_idx]) + node_kmer
        if debug > 1:
            sys.stderr.write("Node %u kmer %u idx %u dir %u\n"
                             % (node_idx, node_kmer, kmer_idx, kmer_dir))
        if debug > 2 and files is not None:
            _print_db_reads(index, files, kmer_idx, kmer_dir)
        first = int(blocks[kmer_idx])
        end = int(blocks[kmer_idx + 1]) if kmer_idx < len(blocks) - 1 \
            else n_reads_total
        n_reads = end - first
        if n_reads > max_reads_per_kmer:
            if debug > 1:
                sys.stderr.write("Kmer %u has too many reads: %u\n"
                                 % (ki, n_reads))
            continue
        if debug > 1:
            sys.stderr.write("Num reads %u\n" % n_reads)
        codes = index.reads[first:end]
        kmer_pos, name_pos, file_idx, dirs = index.decode_reads(codes)
        n_new = 0
        for j in range(n_reads):
            key = (int(file_idx[j]), int(name_pos[j]))
            if key in seen:
                if debug > 2:
                    # src/gassembler.c:2612 (two leading spaces)
                    sys.stderr.write("  Already registered as %u\n"
                                     % seen[key])
                continue
            seen[key] = len(infos)   # slot index, echoed by the
            n_new += 1               # -DDD dedup trace
            if debug > 1:
                # src/gassembler.c:2599 prints the read's RAW index dir,
                # not the stored xor with kmer_dir
                sys.stderr.write("Adding read %u dir %u\n"
                                 % (len(infos), int(dirs[j])))
            infos.append((int(name_pos[j]), int(file_idx[j]),
                          1 if int(dirs[j]) != kmer_dir else 0))
            if len(infos) >= MAX_READS:
                sys.stderr.write(
                    "get_unique_reads: Maximum number of reads (%u) reached,"
                    " ignoring the rest\n" % MAX_READS)
                break
        if debug > 1:
            # trailing per-kmer summary prints even on the MAX_READS
            # break (src/gassembler.c:2615 runs before the cap check)
            sys.stderr.write("Kmer %u %s reads %u new %u\n"
                             % (ki, km, n_reads, n_new))
        if len(infos) >= MAX_READS:
            break
    return infos


def region_rand_consumption(db, kmers: list, max_reads_per_kmer: int) -> int:
    """Number of rand() draws assembling this region will make."""
    import io
    import contextlib
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            infos = _collect_read_infos(db, kmers, max_reads_per_kmer)
    except SystemExit:
        return 0  # "No such kmer" exits before any subsampling
    return MAX_READS_PER_REGION if len(infos) > MAX_READS_PER_REGION else 0


def get_unique_reads(db, files: SeqFiles, kmers: list, params: Params,
                     max_reads_per_kmer: int):
    """src/gassembler.c:2556-2628: trie lookup per k-mer, dedupe by
    (file, name_pos), cap reads/kmer, rand()-subsample past 200."""
    infos = _collect_read_infos(db, kmers, max_reads_per_kmer,
                                debug=params.debug, files=files)
    if len(infos) > MAX_READS_PER_REGION:
        # reference "shuffle" (src/gassembler.c:2619-2626):
        # p = (unsigned)(rand() / (1.0 + RAND_MAX)) is ALWAYS 0, so it
        # swaps reads[0] <-> reads[i] for i = 0..199 (still consuming
        # one rand() per swap); reproduce the bug exactly
        infos2 = list(infos)
        for i in range(MAX_READS_PER_REGION):
            _ = _rand()
            infos2[0], infos2[i] = infos2[i], infos2[0]
        infos = infos2[:MAX_READS_PER_REGION]
    return infos


def get_read_sequences(infos, files: SeqFiles, params: Params):
    """src/gassembler.c:2630-2665: fetch name + sequence at name_pos.

    One native pass (fgx_fetch_reads) scans names, clips at the first
    byte < 'A', truncates, orients, and emits sequence bytes + int8
    codes into arenas; Python only wraps the views into GASMReads."""
    import ctypes

    from genometester4_tpu_torch.utils.native import get_lib

    n = len(infos)
    if n == 0:
        return []
    maxlen = params.max_read_length
    name_pos = np.fromiter((i[0] for i in infos), np.int64, n)
    file_idx = np.fromiter((i[1] for i in infos), np.int32, n)
    rdir = np.fromiter((i[2] for i in infos), np.uint8, n)
    seq_arena = np.empty((n, maxlen), np.uint8)
    code_arena = np.empty((n, maxlen), np.int8)
    name_end = np.empty(n, np.int64)
    seq_len = np.empty(n, np.int64)
    orig_len = np.empty(n, np.int64)
    ptrs, lens = files.c_pointers()
    get_lib().fgx_fetch_reads(
        ptrs, lens,
        name_pos.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        file_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        rdir.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.c_long(n), ctypes.c_long(maxlen),
        seq_arena.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        code_arena.ctypes.data_as(ctypes.POINTER(ctypes.c_byte)),
        name_end.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        seq_len.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        orig_len.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)))
    reads = []
    for i in range(n):
        sl = int(seq_len[i])
        if orig_len[i] > maxlen:
            sys.stderr.write(
                "WARNING: Read is longer than maximum allowed length "
                "(%u, max %u), truncating\n" % (int(orig_len[i]), maxlen))
        data = files.data[int(file_idx[i])]
        name = data[int(name_pos[i]):int(name_end[i])]
        rd = GASMRead(name, seq_arena[i, :sl].tobytes(),
                      code_arena[i, :sl], 1 << int(rdir[i]))
        if params.debug > 1:
            # src/gassembler.c:2662 — name/seq as fetched (oriented)
            sys.stderr.write("Read %2u(%u): >%s\n%s\n"
                             % (i, int(rdir[i]),
                                name.decode("latin1"), rd.seq))
        reads.append(rd)
    return reads


# ---------------------------------------------------------------------------
# alignment
# ---------------------------------------------------------------------------

def count_divergent(ref_codes, read_codes, a_p, b_p):
    """src/gassembler.c:1162-1196."""
    n_gaps = 0
    gaps_total = 0
    s_gap = e_gap = 0
    al = len(a_p)
    if a_p[0] > 0 and b_p[0] > 0:
        mn = min(int(a_p[0]), int(b_p[0]))
        n_gaps += 1
        s_gap = mn
        gaps_total += mn
    if (a_p[al - 1] < len(ref_codes) - 1
            and b_p[al - 1] < len(read_codes) - 1):
        gap_a = len(ref_codes) - 1 - int(a_p[al - 1])
        gap_b = len(read_codes) - 1 - int(b_p[al - 1])
        mn = min(gap_a, gap_b)
        n_gaps += 1
        e_gap = mn
        gaps_total += mn
    n_div = n_gaps + int((ref_codes[a_p] != read_codes[b_p]).sum())
    return n_div, n_gaps, s_gap, e_gap, gaps_total


def device_sw_enabled() -> bool:
    """``GT4_TPU_DEVICE_SW`` decides when set (``"1"`` on, anything else
    off); forked parallel workers set it to 0 (CUDA cannot run in a forked
    child, cli/gassembler._parallel_worker). Otherwise on: the port has no
    slow accelerator link to route around."""
    v = os.environ.get("GT4_TPU_DEVICE_SW")
    return v is None or v == "1"


def pad_reads(reads: list) -> np.ndarray:
    """Read codes int8[B, longest read], padded with NONE."""
    m_cap = max(len(r.nucl) for r in reads)
    batch = np.full((len(reads), m_cap), NONE, np.int8)
    for i, r in enumerate(reads):
        batch[i, :len(r.nucl)] = r.nucl
    return batch


def _trace_stats_line(i, st):
    """-DD per-read stats line (src/gassembler.c:1928)."""
    cnt, n_div, n_gaps, gaps_total, s_gap, e_gap = (int(x) for x in st)
    sys.stderr.write(
        "Read %u: %u divergen %u gaps %u gap length start %u end %u\n"
        % (i, n_div, n_gaps, gaps_total, s_gap, e_gap))


def _trace_reason(i, read, st, params: Params):
    """-DD filter-reason lines (src/gassembler.c:1937-1962): the first
    matching filter prints the read and its reason."""
    cnt, n_div, n_gaps, gaps_total, s_gap, e_gap = (int(x) for x in st)
    if n_div > params.max_divergent:
        sys.stderr.write("Read %u: %s\n" % (i, read.seq))
        sys.stderr.write(
            "  has too many divergences: %u total, %u gaps (len = %u)\n"
            % (n_div, n_gaps, gaps_total))
    elif cnt < params.min_align_len:
        sys.stderr.write("Read %u: %s\n" % (i, read.seq))
        sys.stderr.write("  has too short alignment: %u\n" % cnt)
    elif s_gap > MAX_ENDGAP or e_gap > MAX_ENDGAP:
        sys.stderr.write("Read %u: %s\n" % (i, read.seq))
        sys.stderr.write("  has too long endgaps: %u/%u\n" % (s_gap, e_gap))
    elif gaps_total > MAX_GAPS:
        sys.stderr.write("Read %u: %s\n" % (i, read.seq))
        sys.stderr.write("  has too long gaps: %u\n" % gaps_total)


def _print_read_trace(i, read, st, params: Params):
    """-DD per-read alignment trace: stats line then reason."""
    _trace_stats_line(i, st)
    _trace_reason(i, read, st, params)


def _print_alignment(a_pos, b_pos, a_codes, b_codes):
    """print_alignment twin (src/gassembler.c:2079-2170): three stderr
    lines — reference row with read-insertion dashes, match bars, read
    row with reference-gap dashes."""
    length = len(a_pos)
    left = max(int(a_pos[0]), int(b_pos[0]))
    out = []
    # A row
    for i in range(left):
        a_p = int(a_pos[0]) - (left - i)
        out.append(N2C[int(a_codes[a_p])] if a_p >= 0 else " ")
    last_a, last_b = int(a_pos[0]), int(b_pos[0])
    for i in range(length):
        while int(b_pos[i]) > last_b:
            out.append("-")
            last_b += 1
        while last_a <= int(a_pos[i]):
            out.append(N2C[int(a_codes[last_a])])
            last_a += 1
        last_b = int(b_pos[i]) + 1
    for i in range(int(a_pos[length - 1]) + 1, len(a_codes)):
        out.append(N2C[int(a_codes[i])])
    out.append("\n")
    # match row
    out.extend(" " * left)
    last_a, last_b = int(a_pos[0]), int(b_pos[0])
    for i in range(length):
        while int(b_pos[i]) > last_b:
            out.append(" ")
            last_b += 1
        while int(a_pos[i]) > last_a:
            out.append(" ")
            last_a += 1
        out.append("|" if a_codes[int(a_pos[i])] == b_codes[int(b_pos[i])]
                   else " ")
        last_a = int(a_pos[i]) + 1
        last_b = int(b_pos[i]) + 1
    out.append("\n")
    # B row
    for i in range(left):
        b_p = int(b_pos[0]) - (left - i)
        out.append(N2C[int(b_codes[b_p])] if b_p >= 0 else " ")
    last_a, last_b = int(a_pos[0]), int(b_pos[0])
    for i in range(length):
        while int(a_pos[i]) > last_a:
            out.append("-")
            last_a += 1
        while last_b <= int(b_pos[i]):
            out.append(N2C[int(b_codes[last_b])])
            last_b += 1
        last_a = int(a_pos[i]) + 1
    for i in range(int(b_pos[length - 1]) + 1, len(b_codes)):
        out.append(N2C[int(b_codes[i])])
    out.append("\n")
    sys.stderr.write("".join(out))


def align_reads(ref_codes: np.ndarray, reads: list, params: Params,
                sw_mats=None, device=None):
    """SW every read against the reference, filter, and build the
    per-reference-position read-position table
    (src/gassembler.c:1925-2006). Returns (aligned_reads, a int32[na, n]).

    ``sw_mats``: precomputed (score, sx, sy) from a cross-region
    batched device launch (Assembler.prefetch_device_sw). Without them the
    device route fills this region alone on ``device`` (kernel C on CUDA,
    ``sw_fill`` on the CPU). Either way one native call
    (``gt4_sw_align_mats``, counter "align.native") takes the traceback,
    filters and row build of every read from the matrices in place, in
    read order, so output ordering and bytes are those of the host route
    (``fgx_sw_align_region8``, its own fill fused in front)."""
    n = len(ref_codes)
    if not reads:
        return [], np.zeros((0, n), np.int32)
    if params.debug > 2:
        return _align_reads_traced(ref_codes, reads, params)
    import ctypes

    from genometester4_tpu_torch.utils.native import get_lib
    lib = get_lib()
    batch = pad_reads(reads)
    B, m_cap = batch.shape
    ref8 = np.ascontiguousarray(ref_codes, np.int8)
    read_lens = np.array([len(r.nucl) for r in reads], np.int32)
    cap_rows = min(B, MAX_ALIGNED_READS)
    rows = np.empty((max(1, cap_rows), n), np.int32)
    keep_idx = np.empty(max(1, cap_rows), np.int32)
    hit_cap = ctypes.c_int(0)
    stats = np.full(B * 6, -2, np.int32)  # -2 = never processed
    # the filters' limits and the outputs, alike in both native calls
    shared_args = (params.max_divergent, params.min_align_len, MAX_ENDGAP,
                   MAX_GAPS, MAX_ALIGNED_READS, rows, keep_idx,
                   ctypes.byref(hit_cap), stats)
    if sw_mats is None and not device_sw_enabled():
        # host: one fused C call per region (fill + traceback + filters
        # + row build) — the scratch matrix is reused read-to-read so the
        # DP stays L2-resident
        kept = lib.fgx_sw_align_region8(ref8, n, batch, B, m_cap, read_lens,
                                        *shared_args)
    else:
        if sw_mats is None:
            from genometester4_tpu_torch.ops import swalign_cuda
            sw_mats = swalign_cuda.sw_matrices_batch_device(
                ref8, batch, device=device)
        score, sx, sy = _strided_mats(sw_mats, B, n, m_cap)
        trace.count("align.native", B)
        kept = lib.gt4_sw_align_mats(
            ref8, n, batch, B, m_cap, read_lens, score.ctypes.data,
            sx.ctypes.data, sy.ctypes.data, sx.strides[0], sx.strides[1],
            *shared_args)
    if kept < 0:
        raise MemoryError("sw align scratch allocation failed")
    if params.debug > 1:
        # post-hoc in read order == the reference's in-loop order
        # (nothing else writes stderr during the align loop); reads
        # with an empty traceback are skipped — the reference reads
        # uninitialized ref_p/read_p there (src/gassembler.c:1927,
        # non-oracle UB)
        for i in range(B):
            if stats[i * 6] > 0:
                _print_read_trace(i, reads[i], stats[i * 6:i * 6 + 6],
                                  params)
    if hit_cap.value:
        sys.stderr.write(
            "align_reads_to_reference: maximum number of aligned reads "
            "(%u) achieved\n" % MAX_ALIGNED_READS)
    a_reads = [reads[i] for i in keep_idx[:kept].tolist()]
    return a_reads, (rows[:kept].copy() if kept
                     else np.zeros((0, n), np.int32))


def _strided_mats(sw_mats, B: int, n: int, m: int):
    """(score int16, sx int8, sy int8) of at least [B, n+1, m+1], checked
    for what the native call reads: dense columns and one pair of lane
    and row strides, counted in elements, as views into one padded launch
    (``swalign_cuda._batch_multi``) and a contiguous fill have them."""
    score, sx, sy = sw_mats
    if (score.dtype != np.int16 or sx.dtype != np.int8
            or sy.dtype != np.int8):
        raise ValueError("SW matrices must be int16, int8, int8")
    for x in sw_mats:
        if x.shape[0] != B or x.shape[1] <= n or x.shape[2] <= m:
            raise ValueError(f"SW matrices of shape {x.shape} do not cover "
                             f"{B} reads of {m} against {n}")
    if not (sx.strides[2] == 1 and sy.strides == sx.strides
            and score.strides == tuple(2 * s for s in sx.strides)):
        raise ValueError(f"SW matrices of strides {score.strides}, "
                         f"{sx.strides}, {sy.strides} do not share one "
                         f"layout with dense columns")
    return score, sx, sy


def _align_reads_traced(ref_codes, reads: list, params: Params):
    """-DDD: per-read host fills and tracebacks, so that every read's
    (a_p, b_p) feeds the alignment dump. (The reference's own in-fill
    matrix/traceback dumps are DEAD CODE: the smith_waterman_seq debug
    PARAMETER is hardwired 0 at the align call, src/gassembler.c:1925,
    2275,2314.)"""
    n = len(ref_codes)
    a_rows = []
    a_reads = []
    for i, r in enumerate(reads):
        sc1, sx1, sy1 = swalign.sw_matrices_batch(
            ref_codes.astype(np.int8), r.nucl[None, :])
        a_p, b_p = swalign.sw_traceback(sc1[0], sx1[0], sy1[0],
                                        len(r.nucl))
        if len(a_p) == 0:
            # zero-length alignment: min_align_len rejects it (the
            # reference reads uninitialized ref_p/read_p here —
            # src/gassembler.c:1927, non-oracle UB)
            continue
        n_div, n_gaps, s_gap, e_gap, gaps_total = count_divergent(
            ref_codes, r.nucl, a_p, b_p)
        st = (len(a_p), n_div, n_gaps, gaps_total, s_gap, e_gap)
        _trace_stats_line(i, st)
        # src/gassembler.c:1930-1935: between the stats line and the
        # filter reasons
        sys.stderr.write(">%u/%u\n" % (i, len(a_reads)))
        _print_alignment(a_p, b_p, ref_codes, r.nucl)
        _trace_reason(i, r, st, params)
        if n_div > params.max_divergent:
            continue
        if len(a_p) < params.min_align_len:
            continue
        if s_gap > MAX_ENDGAP or e_gap > MAX_ENDGAP:
            continue
        if gaps_total > MAX_GAPS:
            continue
        # vectorized row build (was per-position python loops):
        #   head:   BEFORE where the read would start before position 0,
        #           UNKNOWN otherwise
        #   middle: first-occurrence anchors at a_p (write-once per ref
        #           position), gaps forward-filled with the previous
        #           anchor's value
        #   tail:   AFTER where the read has run out, UNKNOWN otherwise
        row = np.full(n, -1000, np.int32)
        al = len(a_p)
        a0, b0 = int(a_p[0]), int(b_p[0])
        a_last, b_last = int(a_p[al - 1]), int(b_p[al - 1])
        row[:a0] = UNKNOWN
        row[:max(0, min(a0, a0 - b0))] = BEFORE
        seg_len = a_last - a0 + 1
        seg = np.zeros(seg_len, np.int32)
        seg[a_p[::-1] - a0] = b_p[::-1]  # reversed: first anchor wins
        mask = np.zeros(seg_len, bool)
        mask[a_p - a0] = True
        idx = np.arange(seg_len)
        fill = np.maximum.accumulate(np.where(mask, idx, 0))
        row[a0:a_last + 1] = seg[fill]
        row[a_last + 1:] = UNKNOWN
        cut = a_last + len(r.nucl) - b_last
        row[max(a_last + 1, cut):] = AFTER
        a_reads.append(r)
        a_rows.append(row)
        if len(a_reads) >= MAX_ALIGNED_READS:
            sys.stderr.write(
                "align_reads_to_reference: maximum number of aligned reads "
                "(%u) achieved\n" % MAX_ALIGNED_READS)
            break
    return a_reads, (np.stack(a_rows) if a_rows
                     else np.zeros((0, n), np.int32))


def create_gapped_alignment(ref_codes, ref_start, a_reads, a, params: Params):
    """src/gassembler.c:2008-2077 — insert reference gaps where reads
    have insertions. Returns (p_len, aligned_ref, ref_pos, ga[na, p]).

    The per-read inner loops of the reference run vectorized over the
    read axis; only the reference-position walk stays sequential (it
    carries the gap state). C-backed (fgx_gapped_alignment, exact twin of
    the JAX package's numpy walk, create_gapped_alignment_numpy)."""
    skip = params.skip_end_align
    n = len(ref_codes)
    na = len(a_reads)
    max_p = 2 * params.max_reference_length
    aligned_ref = np.zeros(max_p, np.int32)
    ref_pos = np.zeros(max_p, np.int32)
    ga = np.full((na, max_p), NONE, np.int16)
    if na:
        max_rl = max(len(r.nucl) for r in a_reads)
        seq_mat = np.full((na, max_rl), NONE, np.int16)
        for i, r in enumerate(a_reads):
            seq_mat[i, :len(r.nucl)] = r.nucl
        read_p = a[:, skip].astype(np.int64).copy()
    else:
        seq_mat = np.zeros((0, 1), np.int16)
        read_p = np.zeros(0, np.int64)
    from genometester4_tpu_torch.utils.native import get_lib
    lib = get_lib()
    p_len = lib.fgx_gapped_alignment(
        np.ascontiguousarray(ref_codes, np.int8), n, ref_start, skip,
        seq_mat, na, seq_mat.shape[1],
        np.ascontiguousarray(a, np.int32), max_p, aligned_ref, ref_pos,
        ga, read_p, np.full(max(na, 1), UNKNOWN, np.int64))
    return p_len, aligned_ref[:p_len], ref_pos[:p_len], ga[:, :p_len]


# ---------------------------------------------------------------------------
# region assembly
# ---------------------------------------------------------------------------

@dataclass
class Region:
    chr: int
    start: int
    end: int
    ref: str
    kmers: list


class Assembler:
    def __init__(self, db, files: SeqFiles, params: Params, sex: int,
                 coverage: float, snvs=None, fps=None, device=None):
        """``device``: where the SW fills run (``utils.device``: CUDA by
        default, ``"cpu"`` for the plain version)."""
        from genometester4_tpu_torch.utils.device import resolve_device
        self.device = resolve_device(device)
        self.db = db
        self.files = files
        self.p = params
        self.sex = sex
        self.coverage = coverage
        self.snvs = snvs
        self.fps = fps
        # region id -> [reads, (score, sx, sy) or None], filled by
        # prefetch_device_sw (cross-region SW batching, VERDICT r5 #5)
        self._sw_cache: dict = {}

    def prefetch_device_sw(self, regions, idx):
        """Cross-region SW batching: gather the reads of a window of
        regions from ``idx`` on and fill ALL their SW matrices in one
        kernel C launch (``ops.swalign_cuda.sw_matrices_batch_device_multi``;
        ``sw_fill`` on the CPU). A single region rarely fills the card; the
        window does, and one launch replaces one per region
        (src/gassembler.c:1912-2006 pays the per-region loop).

        Correctness constraints honored:
        * reads are gathered in REGION ORDER, so the glibc rand() stream
          consumption is byte-identical to sequential assembly
          (get_unique_reads is the only rand consumer -- the same
          invariant the forked parallel mode rests on);
        * regions whose reference exceeds max_reference_length are
          skipped exactly like _align_phase's early-out (they consume no
          rand);
        * regions already in ``_sw_cache`` are skipped. The JAX package's
          loop gathers them again when it is called for an oversized
          region inside an earlier window: a second rand() draw for any
          region of more than 200 reads, and a different subsample from
          then on;
        * disabled under -D / --print_reads (their per-region stderr/
          stdout interleaving must match the reference byte-for-byte)
          and when ``GT4_TPU_DEVICE_SW`` keeps SW on the host.

        The window is bounded by ``GT4_TPU_SW_BATCH_LANES`` reads and
        ``GT4_TPU_SW_BATCH_REGIONS`` regions.
        """
        p = self.p
        if p.debug > 0 or p.print_reads or not device_sw_enabled():
            return
        if id(regions[idx]) in self._sw_cache:
            return
        target = int(os.environ.get("GT4_TPU_SW_BATCH_LANES", "512"))
        max_regions = int(os.environ.get("GT4_TPU_SW_BATCH_REGIONS", "16"))
        window = []
        total = 0
        for j in range(idx, len(regions)):
            if len(window) >= max_regions:
                break
            region = regions[j]
            rlen = region.end - region.start
            if (rlen > p.max_reference_length
                    or id(region) in self._sw_cache):
                continue
            ref_codes = _C2N[np.frombuffer(
                region.ref[:rlen].encode("latin1"),
                np.uint8)].astype(np.int8)
            max_rpk = (2000 if region.chr == CHR_MT
                       else MAX_READS_PER_KMER)
            with trace.span("gather"):
                infos = get_unique_reads(self.db, self.files, region.kmers,
                                         p, max_rpk)
                reads = get_read_sequences(infos, self.files, p)
                trace.count("katk.reads", len(reads))
            self._sw_cache[id(region)] = [reads, None]
            if len(reads) >= MIN_READS:
                window.append((id(region), ref_codes, reads))
                total += len(reads)
            if total >= target:
                break
        if not window:
            return
        from genometester4_tpu_torch.ops import swalign_cuda
        mats = swalign_cuda.sw_matrices_batch_device_multi(
            [(ref_codes, pad_reads(reads)) for _, ref_codes, reads in window],
            device=self.device)
        for (rid, _, _), m in zip(window, mats):
            self._sw_cache[rid][1] = m

    def assemble(self, region: Region, cb: CallBlock):
        """src/gassembler.c:1856-1897: align + group, NC-fill on failure."""
        if self.p.debug > 1:
            # virtual command line (src/gassembler.c:1862-1868)
            sys.stderr.write(
                "Arguments: -db %s --reference %s %u %u "
                % (self.p.db_name, CHR_NAMES[region.chr], region.start,
                   region.end))
            sys.stderr.write(region.ref[:region.end - region.start])
            sys.stderr.write("".join(" %s" % km for km in region.kmers))
            sys.stderr.write("\n")
        trace.count("katk.regions")
        res, state = self._align_phase(region)
        if res > 0:
            res = self._group_phase(region, cb, state)
        if res <= 0:
            with trace.span("call"):
                self._no_calls(region, cb)
        return res

    def _no_calls(self, region: Region, cb: CallBlock):
        """The no-call fill of a region that failed to align or group."""
        p = self.p
        n_calls = (region.end - region.start - 2 * p.skip_end_align
                   - 2 * p.skip_end_call)
        ref_codes = _C2N[np.frombuffer(
            region.ref[:region.end - region.start].encode("latin1"),
            np.uint8)]
        for i in range(max(0, n_calls)):
            off = p.skip_end_align + p.skip_end_call + i
            cb.calls.append(Call(
                pos=region.start + off,
                ref=int(ref_codes[off]) if off < len(ref_codes) else N,
                counts=np.zeros(GAP + 1, np.int64),
                nucl=(NONE, NONE), prev_ref="."))

    # -- align phase (src/gassembler.c:1209-1325) -------------------------
    def _align_phase(self, region: Region):
        p = self.p
        rlen = region.end - region.start
        if rlen > p.max_reference_length:
            sys.stderr.write(
                "align: reference length (%u) too big (max %u)\n"
                % (rlen, p.max_reference_length))
            return 0, None
        ref_codes = _C2N[np.frombuffer(
            region.ref[:rlen].encode("latin1"), np.uint8)].astype(np.int8)
        cached = self._sw_cache.pop(id(region), None)
        if cached is not None:
            # prefetch_device_sw already gathered this region's reads
            # (identical rand() draws) and batch-filled its SW matrices
            reads, sw_mats = cached
        else:
            sw_mats = None
            max_rpk = 2000 if region.chr == CHR_MT else MAX_READS_PER_KMER
            with trace.span("gather"):
                infos = get_unique_reads(self.db, self.files, region.kmers,
                                         p, max_rpk)
                if p.debug > 1:
                    sys.stderr.write("Got %u unique reads\n" % len(infos))
                reads = get_read_sequences(infos, self.files, p)
                trace.count("katk.reads", len(reads))
        if p.print_reads:
            for i, r in enumerate(reads):
                sys.stdout.write(f">Read_{i}\n{r.seq}\n")
        if p.debug > 1:
            sys.stderr.write("Number of usable reads: %u\n" % len(reads))
        if p.print_reads:
            # the reference dumps the read list TWICE (src/gassembler.c:
            # 1227-1241 has two identical print_reads blocks around the
            # sanitize step) — as two full passes, not doubled lines
            for i, r in enumerate(reads):
                sys.stdout.write(f">Read_{i}\n{r.seq}\n")
        if p.debug == 1:
            sys.stderr.write("Block: %s %u %u Reads: %u\n" % (
                CHR_NAMES[region.chr], region.start, region.end, len(reads)))
        if len(reads) < MIN_READS:
            if p.debug:
                sys.stderr.write("Final number of reads (%u) too low "
                                 "(min %u)\n" % (len(reads), MIN_READS))
            return -1, None
        if p.debug > 1:
            sys.stderr.write("Aligning reads to reference...")
        with trace.span("align"):
            return self._align_reads(region, ref_codes, reads, sw_mats)

    def _align_reads(self, region: Region, ref_codes, reads, sw_mats):
        """The reads aligned, gapped and tagged at the divergent
        positions (src/gassembler.c:1243-1325)."""
        p = self.p
        a_reads, a = align_reads(ref_codes, reads, p, sw_mats=sw_mats,
                                 device=self.device)
        trace.count("katk.aligned", len(a_reads))
        if p.debug > 1:
            sys.stderr.write("\n")
        p_len, aligned_ref, ref_pos, ga = create_gapped_alignment(
            ref_codes, region.start, a_reads, a, p)
        na = len(a_reads)
        # totals
        nucl_counts = np.zeros((p_len, GAP + 1), np.int64)
        for j in range(GAP + 1):
            nucl_counts[:, j] = (ga[:na] == j).sum(axis=0)
        coverage = nucl_counts.sum(axis=1)
        # tag reads by divergent positions (src/gassembler.c:1267-1321).
        # The per-position divergence test is vectorized (the scalar
        # double loop was ~10% of sparse-region wall); the per-read
        # tagging below only runs at the <=21 divergent positions.
        cutoffs = np.where(coverage >= p.single_cutoff, 2, 1)
        ge = nucl_counts >= cutoffs[:, None]
        ar = np.asarray(aligned_ref[:p_len], np.int64)
        ok_rows = np.flatnonzero((ar >= 0) & (ar <= GAP))
        ge[ok_rows, ar[ok_rows]] = False
        ge[:, N] = False
        div_positions = np.flatnonzero(ge.any(axis=1))
        n_divergent = 0
        for i in div_positions:
            i = int(i)
            cutoff = int(cutoffs[i])
            if n_divergent >= 21:
                sys.stderr.write("assemble: Too many divergent positions "
                                 "(max 21), ignoring the rest\n")
                break
            if p.debug > 1:
                sys.stderr.write("Divergent position: %u\n"
                                 % int(ref_pos[i]))
            known = False
            ref_allele = alt_allele = 0
            if self.snvs is not None:
                snv = lookup_snv(self.snvs, region.chr, region.start + i)
                if (snv < len(self.snvs)
                        and self.snvs[snv][0] == region.chr
                        and self.snvs[snv][1] == region.start + i):
                    known = True
                    ref_allele = self.snvs[snv][2]
                    alt_allele = self.snvs[snv][3]
                    if p.debug > 1:
                        # snv id is the literal "*" upstream
                        # (src/gassembler.c:2367-2369)
                        sys.stderr.write(
                            "Known SNV * (%s/%s)\n"
                            % (N2C[ref_allele], N2C[alt_allele]))
                elif p.debug > 1:
                    sys.stderr.write("Potential DeNovo\n")
            ref_n = int(aligned_ref[i])
            for j in range(na):
                nucl = int(ga[j, i])
                mask = 7
                if nucl <= GAP and nucl_counts[i, nucl] < cutoff:
                    mask = 0
                if nucl == N:
                    nucl = ref_n
                if nucl > GAP:
                    nucl = ref_n
                    mask = 0
                rd = a_reads[j]
                rd.unknown = (rd.unknown << 3) & 0xFFFFFFFFFFFFFFFF
                if not known or (nucl != ref_allele and nucl != alt_allele):
                    rd.unknown |= 7
                nucl = nucl ^ ref_n
                rd.tag = ((rd.tag << 3) | nucl) & 0xFFFFFFFFFFFFFFFF
                rd.mask = ((rd.mask << 3) | mask) & 0xFFFFFFFFFFFFFFFF
            n_divergent += 1
        state = dict(ref_codes=ref_codes, a_reads=a_reads, ga=ga,
                     p_len=p_len, aligned_ref=aligned_ref, ref_pos=ref_pos)
        return len(reads), state

    # -- group phase (src/gassembler.c:1327-1591) --------------------------
    def _group_phase(self, region: Region, cb: CallBlock, state):
        with trace.span("group"):
            grouped = self._group(region, state)
        if grouped is None:
            return 0
        with trace.span("call"):
            self._recalculate_and_call(region, cb, state, *grouped)
        return state["p_len"]

    def _group(self, region: Region, state):
        """The native group phase: the arguments of
        ``_recalculate_and_call`` after (region, cb, state), or None
        without a good group."""
        p = self.p
        a_reads = state["a_reads"]
        ga = state["ga"]
        p_len = state["p_len"]
        aligned_ref = state["aligned_ref"]
        na = len(a_reads)

        tags = np.array([r.tag & r.mask for r in a_reads], np.uint64)
        masks = np.array([r.mask for r in a_reads], np.uint64)
        sizes = np.ones(na, np.int64)
        dirs = np.array([r.dir for r in a_reads], np.int64)
        group_of = np.arange(na)
        read_tags = np.array([r.tag for r in a_reads], np.uint64)
        read_masks = masks.copy()

        max_groups = 2
        if self.sex == 1 and region.chr in (CHR_X, CHR_Y):
            max_groups = 1
        if region.chr == CHR_MT:
            max_groups = 1

        known = np.zeros(max(p_len, 1), np.uint8)
        snv_ref_c = np.zeros(max(p_len, 1), np.uint8)
        snv_alt_c = np.zeros(max(p_len, 1), np.uint8)
        if self.snvs is not None:
            for i in range(p_len):
                snv = lookup_snv(self.snvs, region.chr, region.start + i)
                if (snv < len(self.snvs)
                        and self.snvs[snv][0] == region.chr
                        and self.snvs[snv][1] == region.start + i):
                    known[i] = 1
                    snv_ref_c[i] = ord(N2C[self.snvs[snv][2]])
                    snv_alt_c[i] = ord(N2C[self.snvs[snv][3]])

        # One native call runs the whole phase — greedy merge, coverage,
        # compat counts, consensus (global-count gate), divergence with
        # the reference's row-major carry, the pairwise sort with read
        # relabeling, and selection (fgx_group_phase,
        # src/gassembler.c:1327-1591; the former numpy formulation
        # remains in git history as the derivation)
        import ctypes

        from genometester4_tpu_torch.utils.native import get_lib
        divergent = np.zeros(na, np.int64)
        min_cov = np.zeros(na, np.int64)
        max_cov = np.zeros(na, np.int64)
        compat_n = np.zeros(na, np.int64)
        consensus_buf = np.zeros((max(na, 1), max(p_len, 1)), np.int8)
        included_buf = np.zeros(na, np.uint8)
        good_buf = np.zeros(max(max_groups, 1), np.int64)
        n_good = ctypes.c_long(0)
        ga_c = np.ascontiguousarray(ga[:na, :p_len], np.int8)
        ar_c = np.ascontiguousarray(aligned_ref[:p_len], np.int8)
        lp = ctypes.POINTER(ctypes.c_long)
        if p.debug > 1:
            # initial per-read group tag/mask hex dump, before the merge
            # loop (src/gassembler.c:1356-1361)
            sys.stderr.write("".join("%x\t" % int(t) for t in tags) + "\n")
            sys.stderr.write("".join("%x\t" % int(m) for m in masks) + "\n")
        names_arr = None
        if p.debug_groups > 1:
            name_bytes = [r.name if isinstance(r.name, (bytes, bytearray))
                          else r.name.encode("latin1") for r in a_reads]
            names_arr = (ctypes.c_char_p * max(na, 1))(
                *[bytes(b) for b in name_bytes])
        n_groups = int(get_lib().fgx_group_phase(
            tags, masks,
            sizes.ctypes.data_as(lp), dirs.ctypes.data_as(lp),
            group_of.ctypes.data_as(lp),
            read_tags, read_masks,
            ga_c.ctypes.data_as(ctypes.POINTER(ctypes.c_byte)),
            ctypes.c_long(na), ctypes.c_long(p_len),
            ar_c.ctypes.data_as(ctypes.POINTER(ctypes.c_byte)),
            known.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            divergent.ctypes.data_as(lp), min_cov.ctypes.data_as(lp),
            max_cov.ctypes.data_as(lp), compat_n.ctypes.data_as(lp),
            consensus_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_byte)),
            ctypes.c_int(max_groups),
            ctypes.c_int(int(p.require_both_dirs)),
            ctypes.c_long(p.min_group_coverage),
            ctypes.c_long(p.min_group_size),
            ctypes.c_long(p.max_group_divergence),
            ctypes.c_long(p.max_group_rdivergence),
            ctypes.c_float(p.min_group_rsize),
            included_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            good_buf.ctypes.data_as(lp), ctypes.byref(n_good),
            ctypes.c_int(p.debug_groups), ctypes.c_uint(region.chr),
            np.ascontiguousarray(state["ref_pos"][:max(p_len, 1)],
                                 np.int64).ctypes.data_as(
                ctypes.POINTER(ctypes.c_longlong)),
            snv_ref_c.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            snv_alt_c.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            names_arr))
        consensus = consensus_buf[:max(n_groups, 1), :p_len].astype(np.int64)
        included = included_buf[:n_groups].astype(bool)
        good_groups = [int(good_buf[i]) for i in range(n_good.value)]

        if not good_groups:
            return None
        return (group_of, included, good_groups, n_groups, sizes, divergent,
                min_cov, max_cov, compat_n, consensus, tags, masks,
                read_tags, read_masks, max_groups == 1)

    # -- call phase (src/gassembler.c:1593-1855) ---------------------------
    def _recalculate_and_call(self, region, cb, state, group_of, included,
                              good_groups, n_groups, sizes, divergent,
                              min_cov, max_cov, compat_n, consensus,
                              tags, masks, read_tags, read_masks, haploid):
        p = self.p
        ga = state["ga"]
        p_len = state["p_len"]
        aligned_ref = state["aligned_ref"]
        ref_pos = state["ref_pos"]
        na = ga.shape[0]

        g0 = good_groups[0]
        extra_base = dict(
            n_groups_total=n_groups, n_groups=len(good_groups),
            div_0=int(divergent[g0]), div_1=0,
            max_cov_0=int(max_cov[g0]), max_cov_1=0,
            compat_0=int(compat_n[g0]), compat_1=0, compat_both=0)
        if len(good_groups) > 1:
            g1 = good_groups[1]
            extra_base["max_cov_1"] = int(max_cov[g1])
            extra_base["div_1"] = int(divergent[g1])
            extra_base["compat_1"] = int(compat_n[g1])
            common0 = masks[g0] & read_masks
            ok0 = (tags[g0] & common0) == (read_tags & common0)
            common1 = masks[g1] & read_masks
            ok1 = (tags[g1] & common1) == (read_tags & common1)
            extra_base["compat_both"] = int((ok0 & ok1).sum())

        if p.debug_groups:
            # second group dump, at the top of recalculate_and_call
            # (src/gassembler.c:1619-1633)
            a_reads = state["a_reads"]
            for gi in range(n_groups):
                sys.stderr.write(
                    "Group %u size %u divergent %u, min %u max %u, "
                    "included %u\n" % (gi, sizes[gi], divergent[gi],
                                       min_cov[gi], max_cov[gi],
                                       int(included[gi])))
                if p.debug_groups > 1:
                    # -DG level 2: consensus string + member read names
                    sys.stderr.write("".join(
                        N2C[int(consensus[gi, j])] for j in range(p_len))
                        + "\n")
                    for r in range(len(a_reads)):
                        if group_of[r] == gi:
                            nm = a_reads[r].name
                            sys.stderr.write(
                                (nm.decode("latin1")
                                 if isinstance(nm, (bytes, bytearray))
                                 else nm) + "\n")

        # recalculated counts: only included groups, only consensus-
        # matching nucleotides (vectorized over the whole grid)
        inc_read = included[group_of]
        cons_mat = consensus[group_of]  # (na, p_len)
        ok = inc_read[:, None] & (ga <= GAP) & (ga == cons_mat)
        nucl_counts = np.zeros((p_len, GAP + 1), np.int64)
        for v in range(GAP + 1):
            nucl_counts[:, v] = (ok & (ga == v)).sum(axis=0)
        coverage = nucl_counts.sum(axis=1)
        max_coverage = int(coverage.max()) if p_len else 0
        chr_coverage = max_coverage
        if self.coverage > 0 and region.chr != CHR_MT:
            chr_coverage = int(self.coverage)
            if self.sex == 1 and region.chr in (CHR_X, CHR_Y):
                chr_coverage //= 2

        last_call_pos = 0
        sub = 0
        # Batched numeric core (native fgx_call_batch): nucleotide
        # ranking, logistic quality models, exome multinomials — one C
        # call per region instead of per-position Python evaluation
        # (the JAX package keeps the scalar twin, Assembler._call_one, as
        # its differential oracle; the port does not copy it).
        from genometester4_tpu_torch.utils.native import get_lib
        lib = get_lib()
        fp_mask = np.zeros(max(p_len, 1), np.int8)
        if self.fps is not None:
            for i in range(p.skip_end_call, p_len - p.skip_end_call):
                fp = lookup_snv(self.fps, region.chr, region.start + i)
                if (fp < len(self.fps) and self.fps[fp][0] == region.chr
                        and self.fps[fp][1] == int(ref_pos[i])):
                    fp_mask[i] = 1
        status = np.zeros(p_len, np.int32)
        nucl0 = np.zeros(p_len, np.int32)
        nucl1 = np.zeros(p_len, np.int32)
        p_arr = np.zeros(p_len, np.float64)
        q_arr = np.zeros(p_len, np.float64)
        pdet_arr = np.zeros(p_len, np.float64)
        rprob_arr = np.zeros(p_len, np.float64)
        alt_valid = np.zeros(p_len, np.int32)
        alt_nucl = np.zeros(p_len, np.int32)
        alt_p = np.zeros(p_len, np.float64)
        alt_q = np.zeros(p_len, np.float64)
        alt_pdet = np.zeros(p_len, np.float64)
        alt_rprob = np.zeros(p_len, np.float64)
        if p_len > 2 * p.skip_end_call:
            lib.fgx_call_batch(
                np.ascontiguousarray(nucl_counts, np.int64),
                np.ascontiguousarray(coverage, np.int64),
                np.ascontiguousarray(aligned_ref[:p_len], np.int32),
                p_len, p.skip_end_call, fp_mask,
                float(extra_base["compat_both"]),
                float(extra_base["compat_0"]),
                extra_base["n_groups_total"], extra_base["n_groups"],
                p.error_prob, p.min_confirming, int(p.exome),
                float(self.coverage), chr_coverage, int(cb.haploid),
                int(p.alternative_calls),
                status, nucl0, nucl1, p_arr, q_arr, pdet_arr, rprob_arr,
                alt_valid, alt_nucl, alt_p, alt_q, alt_pdet, alt_rprob)
        # call.extra is only read by the --extra printer
        # (print_call, params.print_extra > 1); default runs share one
        # dict and skip ~130 copies per region
        collect_extra = p.print_extra > 1
        # plain-int views: per-element numpy indexing dominates this
        # loop otherwise (26k positions per run)
        rp_l = ref_pos[:p_len].tolist()
        ar_l = aligned_ref[:p_len].tolist()
        cov_l = coverage.tolist()
        st_l = status.tolist()
        n0_l = nucl0.tolist()
        n1_l = nucl1.tolist()
        p_l = p_arr.tolist()
        q_l = q_arr.tolist()
        pd_l = pdet_arr.tolist()
        rpr_l = rprob_arr.tolist()
        av_l = alt_valid.tolist()
        want_counts = p.print_extra > 0
        reg_ref = region.ref
        reg_start = region.start
        calls_append = cb.calls.append
        for i in range(p.skip_end_call, p_len - p.skip_end_call):
            pos = rp_l[i]
            if pos == last_call_pos:
                sub += 1
            else:
                sub = 0
            last_call_pos = pos
            extra = dict(extra_base) if collect_extra else extra_base
            if collect_extra:
                extra["end_dist"] = min(i, p_len - 1 - i)
            ar = ar_l[i]
            # counts are only printed with --counts/--extra
            # (print_call, params.print_extra > 0)
            call = Call(counts=(nucl_counts[i].copy() if want_counts
                                else None),
                        pos=pos, sub=sub, ref=ar, cov=cov_l[i],
                        extra=extra)
            if ar == GAP:
                call.prev_ref = reg_ref[pos - reg_start]
            elif pos > reg_start:
                call.prev_ref = reg_ref[pos - reg_start - 1]
            else:
                call.prev_ref = "!"
            if st_l[i] == 0:
                n0 = n0_l[i]
                n1 = n1_l[i]
                call.nucl = (n0, n1)
                call.p = p_l[i]
                call.q = q_l[i]
                call.p_det = pd_l[i]
                call.poly = int(n0 != ar or n1 != ar)
                extra["prob"] = 1.0
                extra["rprob"] = rpr_l[i]
                extra["hzprob"] = 1.0
            calls_append(call)
            if av_l[i]:
                extra2 = dict(extra_base) if collect_extra else extra_base
                if collect_extra:
                    extra2["end_dist"] = extra["end_dist"]
                an = int(alt_nucl[i])
                call2 = Call(counts=(nucl_counts[i].copy() if want_counts
                                     else None),
                             pos=pos, sub=sub, ref=ar,
                             cov=call.cov, extra=extra2,
                             prev_ref=call.prev_ref,
                             nucl=(an, an),
                             p=float(alt_p[i]), q=float(alt_q[i]),
                             p_det=float(alt_pdet[i]))
                call2.poly = int(an != ar)
                extra2["prob"] = 1.0
                extra2["rprob"] = float(alt_rprob[i])
                extra2["hzprob"] = 1.0
                calls_append(call2)


def read_snvs(path: str):
    """Known-SNV table (src/gassembler.c:2327-2390): lines of
    "CHR:POS[:ID]:R/A<TAB>GT..."; POS is 1-based in the file, stored
    0-based. Returns sorted (chr, pos, ref_allele, alt_allele) tuples."""
    out = []
    from genometester4_tpu_torch.utils.gt4mmap import gt4_mmap_fail
    mf = gt4_mmap_fail(path)
    if mf is not None:
        # reference: read_snvs mmap failure just yields 0 SNVs and the
        # run continues (src/gassembler.c:2335-2340)
        sys.stderr.write(mf)
        return out
    with open(path, "rb") as f:
        for line in f:
            if line[:1] == b"#":
                continue
            toks = line.split()
            if len(toks) < 2:
                sys.stderr.write("read_snvs: too few tokens at line %u\n"
                                 % len(out))
                continue
            sub = toks[0].split(b":")
            chr_ = chr_from_string(sub[0].decode("latin1")[:31])
            if not chr_:
                continue
            try:
                pos = int(sub[1]) - 1
            except (ValueError, IndexError):
                continue
            ra = sub[3] if len(sub) > 3 else b"N/N"
            ref_a = _C2N[ra[0]] if len(ra) > 0 else N
            alt_a = _C2N[ra[2]] if len(ra) > 2 else N
            out.append((chr_, pos, int(ref_a), int(alt_a)))
    return out


def read_fps(path: str, debug: int = 0):
    """Known-false-positive positions (src/gassembler.c:2392-2438):
    POS stored as-is (NOT shifted, unlike read_snvs); -DDD echoes each
    accepted entry (src/gassembler.c:2428)."""
    out = []
    from genometester4_tpu_torch.utils.gt4mmap import gt4_mmap_fail
    mf = gt4_mmap_fail(path)
    if mf is not None:
        sys.stderr.write(mf)
        return out
    with open(path, "rb") as f:
        for line in f:
            if line[:1] == b"#":
                continue
            toks = line.split()
            if len(toks) < 2:
                sys.stderr.write("read_fps: too few tokens at line %u\n"
                                 % len(out))
                continue
            sub = toks[0].split(b":")
            chr_ = chr_from_string(sub[0].decode("latin1")[:31])
            if not chr_:
                continue
            try:
                pos = int(sub[1])
            except (ValueError, IndexError):
                continue
            if debug > 2:
                sys.stderr.write("FP: %u %u\n" % (chr_, pos))
            out.append((chr_, pos, 0, 0))
    return out


def lookup_snv(snvs, chr_, pos):
    """src/gassembler.c:2440-2467 bisection (snvs: sorted tuples)."""
    mn, mx = 0, len(snvs)
    mid = (mn + mx) // 2
    while mid != mn and mid != mx:
        if mid >= len(snvs):
            break
        schr, spos = snvs[mid][0], snvs[mid][1]
        if schr < chr_:
            mn = mid
        elif schr > chr_:
            mx = mid
        elif spos < pos:
            mn = mid
        elif spos > pos:
            mx = mid
        else:
            break
        mid = (mn + mx) // 2
    return mid
