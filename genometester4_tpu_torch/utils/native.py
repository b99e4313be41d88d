"""The host C library (``native/fastgt_exact.c`` + ``native/listkernel.c``
+ the port's own ``csrc/slabparse.c`` and ``csrc/swtrace.c``): build, load
and the ctypes signatures the port calls.

The port's copy of ``genometester4_tpu/native_build.py`` and of the parts
of ``genometester4_tpu/models/fastgt_native.py`` its host code reaches:
the FASTA/FASTQ slab parsers and the one-call FASTQ frame and decode
(``io.fasta``), the SW fill and traceback
(``ops.swalign``), gassembler's fused host alignment, its alignment from
filled matrices (``gt4_sw_align_mats``), gapped alignment,
grouping and calling (``pipelines.gassemble``), gmer_counter's text
database parser, count formatter and host counting route
(``formats.gmerdb``, ``pipelines.gmercount``), and the glibc ``rand()``
stream (``srand``, ``rand_skip``), glistmaker's index writer and host
extraction (``pipelines.listmaker.make_index``) glistcompare's host
set operations, mismatch filter and subset (``pipelines.listcompare``),
glistquery's host lookups, dumps and statistics (``pipelines.listquery``)
and gmer_caller's exact model (``models.fastgt_native``,
``models.genotype``).
It is host code, not a GPU kernel. ``load_raw`` is the same library as a
bare ``CDLL`` without numpy, for the numpy-free CLI fast paths
(``pipelines.subset_fast``, ``pipelines.setops_stream``).

The library is built with ``cc`` at first use, with the JAX package's
flags, into the port's ``_build/`` (never into ``native/``), named by a
hash of the sources and flags: an edited source rebuilds, an unchanged one
loads at once. Concurrent processes build under a file lock and publish
with an atomic rename, so no process loads a half-linked file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(REPO_DIR, "native")
SRC_FASTGT = os.path.join(NATIVE_DIR, "fastgt_exact.c")
SRC_LIST = os.path.join(NATIVE_DIR, "listkernel.c")
SRC_SLAB = os.path.join(REPO_DIR, "genometester4_tpu_torch", "csrc",
                        "slabparse.c")
SRC_TRACE = os.path.join(REPO_DIR, "genometester4_tpu_torch", "csrc",
                         "swtrace.c")
BUILD_DIR = os.path.join(REPO_DIR, "genometester4_tpu_torch", "_build")

# plain x86-64 codegen for fastgt_exact.c (-O2, no FMA contraction to
# diverge from the reference's default-flag build); listkernel.c is
# integer-only, so x86-64-v3 cannot change a result bit, with plain
# codegen as the fallback where cc rejects the flag; slabparse.c and
# swtrace.c, integer only too, take listkernel.c's flags
CC_FASTGT = ["cc", "-O2", "-Wall", "-c", "-fPIC", "-fopenmp"]
CC_LIST = ["cc", "-O3", "-funroll-loops", "-march=x86-64-v3", "-Wall", "-c",
           "-fPIC", "-fopenmp"]
CC_LIST_PLAIN = ["cc", "-O3", "-funroll-loops", "-Wall", "-c", "-fPIC",
                 "-fopenmp"]
CC_LINK = ["cc", "-shared", "-fopenmp"]

_lock = threading.Lock()
_lib = None
_raw_lib = None


def library_path() -> str:
    h = hashlib.sha256(repr((CC_FASTGT, CC_LIST, CC_LINK)).encode())
    for src in (SRC_FASTGT, SRC_LIST, SRC_SLAB, SRC_TRACE):
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libgt4native_{h.hexdigest()[:16]}.so")


def _compile(path: str) -> None:
    stem = f"{path[:-3]}.{os.getpid()}"
    o1, o2, o3, o4 = (f"{stem}.fastgt.o", f"{stem}.listk.o",
                      f"{stem}.slab.o", f"{stem}.trace.o")
    tmp = f"{stem}.so"
    try:
        subprocess.run([*CC_FASTGT, SRC_FASTGT, "-o", o1], check=True)
        for src, obj in ((SRC_LIST, o2), (SRC_SLAB, o3), (SRC_TRACE, o4)):
            if subprocess.run([*CC_LIST, src, "-o", obj]).returncode != 0:
                subprocess.run([*CC_LIST_PLAIN, src, "-o", obj], check=True)
        subprocess.run([*CC_LINK, o1, o2, o3, o4, "-o", tmp, "-lm"],
                       check=True)
        os.replace(tmp, path)   # atomic publish
    finally:
        for p in (o1, o2, o3, o4, tmp):
            if os.path.exists(p):
                os.remove(p)


def build() -> str:
    """Compile the library unless the one for these sources exists;
    returns its path."""
    path = library_path()
    if os.path.exists(path):
        return path
    import fcntl
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "libgt4native.lock"), "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        if not os.path.exists(path):   # another process may have built it
            _compile(path)
    return path


def load_raw() -> ctypes.CDLL:
    """The library as a bare ``CDLL`` with no argtypes declared (callers
    pass plain ctypes objects), built if needed; imports no numpy.
    ``get_lib`` is the numpy-typed view of the same file."""
    global _raw_lib
    with _lock:
        if _raw_lib is None:
            _raw_lib = ctypes.CDLL(build())
        return _raw_lib


def get_lib() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the signatures."""
    global _lib
    import numpy as np
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        lp = ctypes.POINTER(ctypes.c_long)
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.fgx_srand.argtypes = [ctypes.c_uint]
        lib.fgx_rand_skip.argtypes = [ctypes.c_ulong]
        lib.fgx_rand_skip.restype = None
        lib.fgx_sw_batch.restype = None
        lib.fgx_sw_batch.argtypes = [
            i8p, ctypes.c_int, i8p, ctypes.c_int, ctypes.c_int,
            i16p, i8p, i8p, i16p, i8p]
        lib.fgx_sw_traceback.restype = ctypes.c_int
        lib.fgx_sw_traceback.argtypes = [
            i16p, i8p, i8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            i32p, i32p]
        lib.fgx_sw_align_region8.restype = ctypes.c_long
        lib.fgx_sw_align_region8.argtypes = [
            i8p, ctypes.c_int, i8p, ctypes.c_long, ctypes.c_int, i32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_long, i32p, i32p, ctypes.POINTER(ctypes.c_int),
            i32p]                         # stats (int[B*6], may be None)
        lib.gt4_sw_align_mats.restype = ctypes.c_long
        lib.gt4_sw_align_mats.argtypes = [
            i8p, ctypes.c_int, i8p, ctypes.c_long, ctypes.c_int, i32p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # score, sx, sy
            ctypes.c_long, ctypes.c_long,       # lane and row strides
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_long, i32p, i32p, ctypes.POINTER(ctypes.c_int), i32p]
        lib.fgx_gapped_alignment.restype = ctypes.c_long
        lib.fgx_gapped_alignment.argtypes = [
            i8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, i16p,
            ctypes.c_long, ctypes.c_int, i32p, ctypes.c_int,
            i32p, i32p, i16p, i64p, i64p]
        lib.fgx_call_batch.restype = None
        lib.fgx_call_batch.argtypes = [
            i64p, i64p, i32p, ctypes.c_long, ctypes.c_int, i8p,
            ctypes.c_double, ctypes.c_double, ctypes.c_long,
            ctypes.c_long, ctypes.c_double, ctypes.c_long, ctypes.c_int,
            ctypes.c_double, ctypes.c_long, ctypes.c_int, ctypes.c_int,
            i32p, i32p, i32p, f64p, f64p, f64p, f64p,
            i32p, i32p, f64p, f64p, f64p, f64p]
        lib.fgx_group_phase.restype = ctypes.c_long
        lib.fgx_group_phase.argtypes = [
            u64p, u64p,                       # tags, masks (group slots)
            lp, lp, lp,                       # sizes, dirs, group_of
            u64p, u64p,                       # read_tags, read_masks
            ctypes.POINTER(ctypes.c_byte),    # ga
            ctypes.c_long, ctypes.c_long,     # na, p_len
            ctypes.POINTER(ctypes.c_byte),    # aligned_ref
            ctypes.POINTER(ctypes.c_ubyte),   # known
            lp, lp, lp, lp,                   # divergent, min/max cov, compat
            ctypes.POINTER(ctypes.c_byte),    # consensus
            ctypes.c_int, ctypes.c_int,       # max_groups, require_both
            ctypes.c_long, ctypes.c_long,     # min_group_coverage/size
            ctypes.c_long, ctypes.c_long,     # max_group_(r)divergence
            ctypes.c_float,                   # min_group_rsize
            ctypes.POINTER(ctypes.c_ubyte),   # included
            lp, lp,                           # good_groups, n_good_out
            ctypes.c_int, ctypes.c_uint,      # debug_groups, chr
            ctypes.POINTER(ctypes.c_longlong),  # ref_pos
            ctypes.POINTER(ctypes.c_ubyte),   # snv_ref_c
            ctypes.POINTER(ctypes.c_ubyte),   # snv_alt_c
            ctypes.POINTER(ctypes.c_char_p)]  # read_names (-DG2, or None)
        llp = ctypes.POINTER(ctypes.c_longlong)
        lib.fgx_rand.restype = ctypes.c_int
        lib.fgx_rand.argtypes = []
        lib.fgx_fetch_reads.restype = None
        lib.fgx_fetch_reads.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), llp,   # file data, lengths
            llp, ctypes.POINTER(ctypes.c_int),      # name_pos, file_idx
            ctypes.POINTER(ctypes.c_ubyte),         # dir
            ctypes.c_long, ctypes.c_long,           # n, maxlen
            ctypes.POINTER(ctypes.c_ubyte),         # sequence arena
            ctypes.POINTER(ctypes.c_byte),          # code arena
            llp, llp, llp]                          # name_end, lengths
        lib.fgx_parse_fasta_slab.restype = ctypes.c_long
        lib.fgx_parse_fasta_slab.argtypes = [
            u8p, ctypes.c_long, ctypes.c_int, u8p, lp, lp, lp]
        lib.fgx_parse_fastq_slab.restype = ctypes.c_long
        lib.fgx_parse_fastq_slab.argtypes = [
            u8p, ctypes.c_long, u8p, lp, i64p, i64p, lp, lp]
        lib.gt4_fastq_frame_decode.restype = ctypes.c_long
        lib.gt4_fastq_frame_decode.argtypes = [
            u8p, ctypes.c_long, ctypes.c_int, ctypes.c_long, u8p, i64p,
            i64p, i64p, i64p, ctypes.c_long, i64p]
        # gmer_counter: the text database parser and the count formatter
        lib.fgx_parse_text_db.restype = ctypes.c_long
        lib.fgx_parse_text_db.argtypes = [
            u8p, ctypes.c_long, ctypes.c_long, i64p, i64p, i64p, u64p,
            lp, ctypes.POINTER(ctypes.c_int)]
        lib.fgx_format_node_counts.restype = ctypes.c_long
        lib.fgx_format_node_counts.argtypes = [
            u8p, llp, ctypes.POINTER(ctypes.c_int), llp, llp, u64p,
            ctypes.c_long, u8p]
        # gmer_counter's host route (GT4_TPU_COUNT_IMPL=host)
        lib.fgx_extract_canonical.restype = ctypes.c_long
        lib.fgx_extract_canonical.argtypes = [
            u8p, ctypes.c_long, ctypes.c_int, u64p]
        lib.fgx_sort_u64.restype = ctypes.c_int
        lib.fgx_sort_u64.argtypes = [u64p, ctypes.c_long, ctypes.c_int]
        lib.fgx_sorted_occurrences.restype = None
        lib.fgx_sorted_occurrences.argtypes = [
            u64p, ctypes.c_long, u64p, ctypes.c_long, u64p]
        lib.fgx_index_hits.restype = ctypes.c_long
        lib.fgx_index_hits.argtypes = [
            u8p, ctypes.c_long, ctypes.c_int, u64p, u32p, ctypes.c_long,
            u32p, i64p, u8p, llp]
        lib.fgx_index_hits_batched.restype = ctypes.c_long
        lib.fgx_index_hits_batched.argtypes = lib.fgx_index_hits.argtypes
        # glistmaker --index: host extraction, the (word, code) pair sort
        # and the interleaved k-mer records
        lib.fgx_extract_canonical_posdir.restype = ctypes.c_long
        lib.fgx_extract_canonical_posdir.argtypes = [
            u8p, ctypes.c_long, ctypes.c_int, u64p, i64p, u8p]
        lib.fgx_sort_pair_u64.restype = ctypes.c_int
        lib.fgx_sort_pair_u64.argtypes = [
            u64p, u64p, ctypes.c_long, ctypes.c_int]
        lib.fgx_index_kmer_records.restype = ctypes.c_long
        lib.fgx_index_kmer_records.argtypes = [
            u64p, ctypes.c_long, ctypes.c_uint, ctypes.c_uint, u64p,
            ctypes.POINTER(ctypes.c_ulonglong)]
        # glistcompare's host route: the pair zipper (streamed, or in
        # buckets over threads), the N-list merge, -mm and -ss
        u64sp = ctypes.POINTER(ctypes.c_ulonglong)
        lib.fgx_pair_align.restype = ctypes.c_long
        lib.fgx_pair_align.argtypes = [
            u64p, u32p, ctypes.c_long, u64p, u32p, ctypes.c_long,
            u64p, u32p, u32p]

        def optional(p):
            class _Optional:
                @classmethod
                def from_param(cls, v):
                    return None if v is None else p.from_param(v)
            return _Optional

        lib.fgx_pair_ops_buckets.restype = None
        lib.fgx_pair_ops_buckets.argtypes = [
            u8p, u8p, i64p, i64p, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint, ctypes.c_uint, ctypes.c_int,
            *[optional(p) for _ in range(4) for p in (u8p, i64p, u64p)]]
        lib.fgx_pair_stream_start.restype = ctypes.c_void_p
        lib.fgx_pair_stream_start.argtypes = [
            u8p, ctypes.c_long, u8p, ctypes.c_long,
            ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.fgx_pair_stream_next.restype = ctypes.c_int
        lib.fgx_pair_stream_next.argtypes = [
            ctypes.c_void_p, u8p, u8p, u8p, u8p, ctypes.c_long, i64p, u64p]
        lib.fgx_pair_stream_free.restype = None
        lib.fgx_pair_stream_free.argtypes = [ctypes.c_void_p]
        lib.fgx_multi_stream_start.restype = ctypes.c_void_p
        lib.fgx_multi_stream_start.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), lp, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_uint, ctypes.c_uint]
        lib.fgx_multi_stream_next.restype = ctypes.c_int
        lib.fgx_multi_stream_next.argtypes = [
            ctypes.c_void_p, u8p, ctypes.c_long, lp, u64sp]
        lib.fgx_multi_stream_free.restype = None
        lib.fgx_multi_stream_free.argtypes = [ctypes.c_void_p]
        lib.fgx_mm_filter.restype = ctypes.c_long
        lib.fgx_mm_filter.argtypes = [
            u64p, ctypes.c_long, ctypes.c_int,      # candidates, n, k
            u64p, ctypes.c_long,                    # masks
            u64p, ctypes.c_long,                    # the other list (sorted)
            u64p, ctypes.c_long,                    # the own list, subtract
            ctypes.c_uint, ctypes.c_int,            # cutoff, subtract
            u8p]                                    # alive (in-out)
        lib.fgx_subset.restype = ctypes.c_long
        lib.fgx_subset.argtypes = [
            u8p, ctypes.c_long, ctypes.c_ulonglong, ctypes.c_int,
            ctypes.c_ulonglong, ctypes.c_long, u8p, u64sp]
        # glistquery: forward extraction, the record lookups, the record
        # and location dumps, the statistics passes (native/listkernel.c)
        lib.fgx_extract_forward.restype = ctypes.c_long
        lib.fgx_extract_forward.argtypes = [
            u8p, ctypes.c_long, ctypes.c_int, u64p]
        lib.fgx_lookup_records_batched.restype = None
        lib.fgx_lookup_records_batched.argtypes = [
            u8p, ctypes.c_long, u64p, ctypes.c_long, u32p]
        lib.fgx_lookup_records_zipper.restype = None
        lib.fgx_lookup_records_zipper.argtypes = \
            lib.fgx_lookup_records_batched.argtypes
        lib.fgx_dump_records.restype = ctypes.c_long
        lib.fgx_dump_records.argtypes = [u8p, ctypes.c_long, ctypes.c_int,
                                         u8p]
        lib.fgx_dump_index_locations_raw.restype = ctypes.c_long
        lib.fgx_dump_index_locations_raw.argtypes = [
            u64p, ctypes.c_long, ctypes.c_ulonglong, ctypes.c_int, u64p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p]
        u32sp = ctypes.POINTER(ctypes.c_uint)
        lib.fgx_gc_rec.restype = None
        lib.fgx_gc_rec.argtypes = [u8p, ctypes.c_long, u64sp, u64sp]
        lib.fgx_median_rec.restype = None
        lib.fgx_median_rec.argtypes = [u8p, ctypes.c_long, u32sp, u32sp,
                                       u32sp]
        lib.fgx_distro_rec.restype = None
        lib.fgx_distro_rec.argtypes = [u8p, ctypes.c_long,
                                       ctypes.c_ulonglong, u64sp]
        # gmer_caller: the exact model (native/fastgt_exact.c)
        u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.fgx_poisson.restype = ctypes.c_double
        lib.fgx_poisson.argtypes = [ctypes.c_uint, ctypes.c_double]
        lib.fgx_allele_freq.restype = ctypes.c_float
        lib.fgx_allele_freq.argtypes = [u16p, ctypes.c_uint]
        lib.fgx_train_model.restype = ctypes.c_int
        lib.fgx_train_model.argtypes = [
            u16p, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, f32p,
            ctypes.POINTER(ctypes.c_float), ctypes.c_uint, ctypes.c_uint,
            ctypes.c_uint]
        lib.fgx_genotype_batch.restype = None
        lib.fgx_genotype_batch.argtypes = [
            u16p, ctypes.c_uint, ctypes.c_float, f32p, f64p, f64p, u32p]
        lib.fgx_dnbinom_mu.restype = ctypes.c_double
        lib.fgx_dnbinom_mu.argtypes = [ctypes.c_uint, ctypes.c_double,
                                       ctypes.c_double]
        lib.fgx_dbinom.restype = ctypes.c_double
        lib.fgx_dbinom.argtypes = [ctypes.c_uint, ctypes.c_uint,
                                   ctypes.c_double]
        _lib = lib
        return lib


def srand(seed: int):
    get_lib().fgx_srand(seed)


def rand_skip(n: int):
    """Advance the glibc rand() stream by n draws."""
    if n:
        get_lib().fgx_rand_skip(n)
