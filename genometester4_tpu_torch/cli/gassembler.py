"""gassembler CLI — flag-compatible with the reference
(src/gassembler.c:646-930); the port's copy of
``genometester4_tpu/cli/gassembler.py``.

Usage: gassembler --dbi FILENAME --region_file FILENAME [ARGUMENTS]

    python -m genometester4_tpu_torch.cli.gassembler --dbi db.idx \
        --region_file regions.txt --num_threads 1 [flags]

The regions' SW fills run on the device (``pipelines.gassemble``: CUDA by
default, and no CUDA raises when the ``Assembler`` is built; ``main(argv,
device="cpu")`` runs the plain version). As in the JAX package, the device
route runs under ``--num_threads 1``: more threads fork workers, which
align on the host. Importing this module, and runs that never build an
``Assembler`` (``-h``, bad flags), import no torch.

Single-threaded region processing reproduces the reference's
--num_threads 1 output byte for byte (its multi-threaded output depends
on thread scheduling: per-kmer read subsampling consumes a shared
rand() stream and blocks finish out of order).
"""

from __future__ import annotations

import bisect
import sys

import numpy as np

REF_VERSION_3 = "4.2.16"

# exact reference usage screens (src/gassembler.c:646-696). The
# reference prints the LIVE parameter globals into the "default"
# fields, so a flag parsed before the usage screen changes the text
# (e.g. "--num_threads 7 --badflag" shows "default 7").
_USAGE_COMMON = (
    "gassembler version 4.2.16 (stable)\n"
    "Usage: gassembler --dbi FILENAME --region_file FILENAME [ARGUMENTS]\n"
    "Common options:\n"
    "    -v, --version                    - print version information and exit\n"
    "    -h, --help                       - print this usage screen and exit\n"
    "    --dbi FILENAME                   - index of sequenced reads (mandatory)\n"
    "    --region_file FILENAME           - reference and kmer database (mandatory)\n"
    "    --sex male|female|auto           - sex of the individual (default auto)\n"
    "    --coverage FLOAT | median | local | ignore - average sequencing depth (default - median, local - use local number of reads)\n"
    "    --num_threads                    - number of threads to use (default {nt})\n"
    "    --min_p FLOAT                    - minimum call quality (default {min_p:.2f})\n"
    "    --min_pmut FLOAT                 - minimum reference call quality (default {min_pmut:.2f})\n"
    "    --exome                          - Disable quality models (needed if coverage variability is high)\n"
    "    --advanced                       - print advanced usage options\n"
)
_USAGE_ADVANCED = (
    "Advanced options:\n"
    "    --seq_dir DIRECTORY              - directory of fastq files (overrides location in index)\n"
    "    --region CHR START END SEQ       - call single reference region\n"
    "    --min_coverage INTEGER           - minimum coverage for a call (default {min_coverage})\n"
    "    --output poly | best | all       - output type (only polymorphisms, best calls for positon, all calls) (default poly)\n"
    "    --counts                         - output nucleotide counts\n"
    "    --extra                          - output extra information about call\n"
    "    --min_confirming INTEGER         - minimum confirming nucleotide count for a call (default {min_confirming})\n"
    "    --min_group_coverage INTEGER     - minimum coverage of group (default {min_group_coverage})\n"
    "    --max_divergent INTEGER          - maximum number of mismatches per read (default {max_divergent})\n"
    "    --min_align_len INTEGER          - minimum alignment length (default {min_align_len})\n"
    "    --min_group_size INTEGER         - minimum group size (default {min_group_size})\n"
    "    --min_group_rsize FLOAT          - minimum relative group size (default {min_group_rsize:.2f})\n"
    "    --max_group_divergence INTEGER   - maximum divergence in group (default {max_group_divergence})\n"
    "    --max_group_rdivergence INTEGER  - maximum relative divergence in group (default {max_group_rdivergence})\n"
    "    --skip_end_align INTEGER         - skip nucleotides at region ends during alignment (default {skip_end_align})\n"
    "    --skip_end_call INTEGER          - skip nucleotides at alignment ends (default {skip_end_call})\n"
    "    --allow_one_dir                  - Allow calling if all confirming reads have the same dir\n"
    "    --alternatives                   - output also homozygous variant for each heterozygous position\n"
    "    --max_read_length INTEGER        - maximum length of reads (default {max_read_length})\n"
    "    --max_reference_length INTEGER   - maximum length of reference region (default {max_reference_length})\n"
    "    --error_prob FLOAT               - Probability of error (default {error_prob:.6f})\n"
    "    --prefetch_seq                   - Prefetch FastQ sequences (slightly faster but uses more virtual memory/IO)\n"
    "    --dont_prefetch_db               - Do not prefetch index (much slower but uses less memory/IO)\n"
    "    -D                               - increase debug level\n"
    "    -DG                              - increase group debug level\n"
)


def _u32(v: int) -> int:
    return v & 0xFFFFFFFF


def _usage_text(p, n_threads_c: int, advanced: bool = False) -> str:
    s = _USAGE_COMMON.format(nt=_u32(n_threads_c), min_p=p.min_p,
                             min_pmut=p.min_pmut)
    if advanced:
        s += _USAGE_ADVANCED.format(
            min_coverage=_u32(p.min_coverage),
            min_confirming=_u32(p.min_confirming),
            min_group_coverage=_u32(p.min_group_coverage),
            max_divergent=_u32(p.max_divergent),
            min_align_len=_u32(p.min_align_len),
            min_group_size=_u32(p.min_group_size),
            min_group_rsize=p.min_group_rsize,
            max_group_divergence=_u32(p.max_group_divergence),
            max_group_rdivergence=_u32(p.max_group_rdivergence),
            skip_end_align=_u32(p.skip_end_align),
            skip_end_call=_u32(p.skip_end_call),
            max_read_length=_u32(p.max_read_length),
            max_reference_length=_u32(p.max_reference_length),
            error_prob=p.error_prob)
    return s

from genometester4_tpu_torch.pipelines.gassemble import (
    A, C, G, T, N, GAP, NONE, CHR_NAMES, CHR_MT, N2C, Assembler, Call,
    CallBlock, Params, Region, SeqFiles, auto_sex, chr_from_string,
    find_coverage)
from genometester4_tpu_torch.utils import trace

MAX_KMERS = 1024


def _split_line(data: bytes, pos: int, max_tokens: int):
    """split_line twin (src/utils.c:234-248). The outer loop has NO
    csize bound — past EOF the reference's mmap reads the zero page
    (0 != '\\n'), so an unterminated final line yields EMPTY trailing
    tokens until max_tokens. Those become empty k-mers and gassembler
    dies with "No such kmer: " exit 0 (stable zero-page fallout,
    reproduced; a file ending exactly at a page boundary segfaults the
    reference instead — non-oracle)."""
    toks = []
    p = pos
    n = len(data)

    def _byte(i):
        return data[i] if i < n else 0

    while len(toks) < max_tokens and _byte(p) != 0x0A:
        s = p
        while p < n and data[p] >= 0x20:
            p += 1
        toks.append((s, p))
        if _byte(p) != 0x0A:
            p += 1
    return toks


def print_header(out, params: Params):
    out.write("CHR\tPOS\tSUB\tREF\tCOV\tCALL\tCLASS\tP\tPMUT")
    if params.print_extra > 1:
        out.write("\tPREV")
    if params.print_extra > 0:
        out.write("\tA\tC\tG\tT\tGAP")
    if params.print_extra > 1:
        out.write("\tPROB\tRPROB\tHZPROB\tEDIST\tGRP_ALL\tGRP\tDIV0\tDIV1"
                  "\tG0\tG1\tG0_COMP\tG1_COMP\tCOMP_2")


def print_call(out, cb: CallBlock, call: Call, params: Params):
    """src/gassembler.c:355-392 — one write per line (same bytes as the
    reference's per-field fprintfs)."""
    q32 = float(np.float32(call.q))
    pd32 = float(np.float32(call.p_det))
    if (call.ref != N and call.cov >= params.min_coverage
            and q32 >= params.min_p
            and (call.poly or pd32 >= params.min_pmut)
            and call.nucl[0] != NONE):
        cstr = "\t%c%c" % (N2C[call.nucl[0]], N2C[call.nucl[1]])
    else:
        cstr = "\tNC"
    if call.ref == GAP:
        klass = "\tI"
    elif call.nucl[1] == GAP:
        klass = "\tD"
    elif call.poly:
        klass = "\tS"
    else:
        klass = "\t0"
    parts = ["%s\t%u\t%u\t%c\t%u" % (CHR_NAMES[cb.chr], call.pos, call.sub,
                                     N2C[call.ref], call.cov),
             cstr, klass, "\t%.3f" % q32, "\t%.3f" % pd32]
    if params.print_extra > 1:
        parts.append("\t%c" % call.prev_ref)
    if params.print_extra > 0:
        parts.append("\t%u\t%u\t%u\t%u\t%u" % (
            call.counts[A], call.counts[C], call.counts[G], call.counts[T],
            call.counts[GAP]))
    if params.print_extra > 1:
        e = call.extra
        parts.append("\t%.5f\t%.5f\t%.5f" % (
            float(np.float32(e.get("prob", 0.0))),
            float(np.float32(e.get("rprob", 0.0))),
            float(np.float32(e.get("hzprob", 0.0)))))
        parts.append("\t%2u" % e.get("end_dist", 0))
        parts.append("\t%2u\t%2u\t%2u\t%2u" % (
            e.get("n_groups_total", 0), e.get("n_groups", 0),
            e.get("div_0", 0), e.get("div_1", 0)))
        parts.append("\t%2u\t%2u\t%2u\t%2u\t%2u" % (
            e.get("max_cov_0", 0), e.get("max_cov_1", 0),
            e.get("compat_0", 0), e.get("compat_1", 0),
            e.get("compat_both", 0)))
    out.write("".join(parts))


class OutputQueue:
    """CallBlock retirement in genomic order (src/gassembler.c:245-538)."""

    def __init__(self, out, params: Params):
        self.out = out
        self.p = params
        self.processing: list[CallBlock] = []
        self.finished: list[CallBlock] = []
        self.last_chr = 0
        self.last_pos = 0

    def start_block(self, cb: CallBlock):
        self.processing.insert(0, cb)

    def finish_block(self, cb: CallBlock):
        self.processing.remove(cb)
        self.finished.insert(0, cb)

    def flush(self):
        """Print every finished block that no block still in processing
        precedes: the span "print"."""
        with trace.span("print"):
            self._flush()

    def _flush(self):
        min_chr_p = min_start_p = 0xFFFFFFFF
        for cb in self.processing:
            if (cb.chr < min_chr_p
                    or (cb.chr == min_chr_p and cb.start < min_start_p)):
                min_chr_p, min_start_p = cb.chr, cb.start
        while self.finished:
            cb_f = None
            min_chr_f = min_start_f = 0xFFFFFFFF
            for cb in self.finished:
                if (cb.chr < min_chr_f
                        or (cb.chr == min_chr_f and cb.start < min_start_f)):
                    min_chr_f, min_start_f, cb_f = cb.chr, cb.start, cb
            if cb_f is None:
                return
            if cb_f.chr > min_chr_p:
                return
            if cb_f.chr == min_chr_p and cb_f.end > min_start_p:
                return
            if self.p.output == 0:
                self._print_poly_best(cb_f, only_poly=True)
            elif self.p.output == 1:
                self._print_poly_best(cb_f, only_poly=False)
            else:
                self._print_all(cb_f)
            self.finished.remove(cb_f)

    @staticmethod
    def _calls_at(ccb: CallBlock, pos: int):
        """Calls with .pos == pos, in stored order. Equivalent to the
        reference's break/continue linear scan (calls are pos-sorted);
        bisect turns the O(len(calls)) rescan per position into
        O(log)."""
        pl = ccb._pos_list
        if pl is None or len(pl) != len(ccb.calls):
            pl = [c.pos for c in ccb.calls]
            ccb._pos_list = pl
        lo = bisect.bisect_left(pl, pos)
        return ccb.calls[lo:bisect.bisect_right(pl, pos, lo)]

    def _print_poly_best(self, cb_f: CallBlock, only_poly: bool):
        """src/gassembler.c:394-463."""
        if len(self.finished) == 1 and self.finished[0] is cb_f:
            # single-block fast path (the non-overlapping sequential
            # case): the cross-block best-call competition degenerates
            # to this block's own calls, and positions WITHOUT calls
            # print nothing — so walk the pos-sorted call list once
            # instead of looping every position through bisects (was
            # ~30% of wall on sparse 200-region fixtures). Byte-
            # identical: positions are processed in the same order,
            # the entry-captured last_chr/last_pos prefix skip matches
            # the reference's (the original only consults them until
            # the first processed position), and the trailing
            # last_* update equals the final loop iteration's. Calls
            # outside [start, end) are skipped, as the general loop
            # below never reaches their positions (the JAX package's
            # fast path prints them).
            if cb_f.start >= cb_f.end:
                return
            old_chr, old_pos = self.last_chr, self.last_pos
            if cb_f.chr == old_chr and cb_f.end - 1 <= old_pos:
                return           # every position would `continue`
            calls = cb_f.calls
            i, n = 0, len(calls)
            while i < n:
                pos = calls[i].pos
                j = i
                while j < n and calls[j].pos == pos:
                    j += 1
                if (cb_f.start <= pos < cb_f.end
                        and not (cb_f.chr == old_chr and pos <= old_pos)):
                    group = calls[i:j]
                    if only_poly:
                        if any(c.poly for c in group):
                            for call in group:
                                if call.q >= self.p.min_p:
                                    if call.poly:
                                        print_call(self.out, cb_f, call,
                                                   self.p)
                                        self.out.write("\n")
                                else:
                                    print_call(self.out, cb_f, call,
                                               self.p)
                                    self.out.write("\n")
                                    break
                        else:
                            for call in group:
                                if call.p_det < self.p.min_pmut:
                                    print_call(self.out, cb_f, call,
                                               self.p)
                                    self.out.write("\n")
                    else:
                        for call in group:
                            print_call(self.out, cb_f, call, self.p)
                            self.out.write("\n")
                i = j
            self.last_chr = cb_f.chr
            self.last_pos = cb_f.end - 1
            return
        for pos in range(cb_f.start, cb_f.end):
            if cb_f.chr == self.last_chr and pos <= self.last_pos:
                continue
            best_cb = cb_f
            best_p = 0.0
            has_poly = 0
            for ccb in self.finished:
                local_poly = 0
                if ccb.chr > cb_f.chr:
                    continue
                if ccb.start > pos:
                    continue
                for call in self._calls_at(ccb, pos):
                    if call.poly:
                        local_poly = 1
                    if call.p < best_p:
                        continue
                    best_cb = ccb
                    best_p = call.p
                if best_cb is ccb:
                    has_poly = local_poly
            if only_poly:
                if has_poly:
                    for call in self._calls_at(best_cb, pos):
                        if call.q >= self.p.min_p:
                            if call.poly:
                                print_call(self.out, best_cb, call, self.p)
                                self.out.write("\n")
                        else:
                            print_call(self.out, best_cb, call, self.p)
                            self.out.write("\n")
                            break
                else:
                    for call in self._calls_at(best_cb, pos):
                        if call.p_det < self.p.min_pmut:
                            print_call(self.out, best_cb, call, self.p)
                            self.out.write("\n")
            else:
                for call in self._calls_at(best_cb, pos):
                    print_call(self.out, best_cb, call, self.p)
                    self.out.write("\n")
            self.last_chr = cb_f.chr
            self.last_pos = pos

    def _print_all(self, cb_f: CallBlock):
        for pos in range(cb_f.start, cb_f.end):
            if cb_f.chr == self.last_chr and pos <= self.last_pos:
                continue
            for ccb in self.finished:
                if ccb.chr != cb_f.chr:
                    continue
                for call in self._calls_at(ccb, pos):
                    print_call(self.out, ccb, call, self.p)
                    self.out.write("\n")
            self.last_chr = cb_f.chr
            self.last_pos = pos


def main(argv=None, device=None) -> int:
    """One gassembler run: the job span "gassemble", with "load" (the
    index, the coverage, the sequence files and the region file) and
    the spans of ``pipelines.gassemble`` and ``OutputQueue`` below it."""
    with trace.span("gassemble"):
        return _main(argv, device)


def _main(argv, device) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    p = Params()
    db_name = None
    input_name = None
    seq_dir = None
    snv_db_name = fp_db_name = None
    max_regions = 1000000000
    # parallel region assembly (reference default 24 threads,
    # src/gassembler.c:29); our parallel output is byte-identical to
    # --num_threads 1 (see _parallel_assemble), unlike the reference's
    import os as _os
    num_threads = min(24, _os.cpu_count() or 1)
    # the C n_threads global starts at 24 regardless of core count and
    # is what the usage screen renders (src/gassembler.c:29)
    n_threads_c = 24
    region_args = None
    only_chr = 1  # CHR_1 (src/gassembler.c:698)
    only_pos = 0
    kmers_cli = []
    # C numeric twins: strtol/atof prefix parses, never errors
    # (src/gassembler.c parse loop validates nothing)
    from genometester4_tpu_torch.cli._cstrtol import atof as _caf
    from genometester4_tpu_torch.cli._cstrtol import strtol as _strtol

    def _cl(s):
        return _strtol(s)[0]

    i = 0
    try:
        while i < len(argv):
            a = argv[i]
            if a in ("-v", "--version"):
                sys.stdout.write(f"gassembler version {REF_VERSION_3} "
                                 "(stable)\n")
                return 0
            elif a in ("-h", "--help"):
                sys.stdout.write(_usage_text(p, n_threads_c))
                return 0
            elif a == "--advanced":
                sys.stdout.write(_usage_text(p, n_threads_c, advanced=True))
                return 0
            elif a in ("-dbi", "-dbb", "-db", "--dbi"):
                i += 1
                db_name = argv[i]
            elif a in ("--reference", "--region"):
                # (i + 4) >= argc bound + chr validity checks both hit
                # the usage screen (src/gassembler.c:737-740)
                if i + 4 >= len(argv):
                    sys.stderr.write(_usage_text(p, n_threads_c))
                    return 1
                if not chr_from_string(argv[i + 1]):
                    sys.stderr.write(_usage_text(p, n_threads_c))
                    return 1
                region_args = (argv[i + 1], _cl(argv[i + 2]),
                               _cl(argv[i + 3]), argv[i + 4])
                i += 4
            elif a == "--snvs":
                i += 1
                snv_db_name = argv[i]
            elif a == "--fp":
                i += 1
                fp_db_name = argv[i]
            elif a in ("--region_file", "--file"):
                i += 1
                input_name = argv[i]
            elif a == "--max_regions":
                i += 1
                max_regions = _cl(argv[i])
            elif a == "--pos":
                i += 1
                if ":" in argv[i]:
                    cs, ps = argv[i].split(":", 1)
                    only_chr = chr_from_string(cs)
                    only_pos = _cl(ps)
                else:
                    only_pos = _cl(argv[i])
            elif a == "--min_coverage":
                i += 1
                p.min_coverage = _cl(argv[i])
            elif a == "--sex":
                i += 1
                p.sex = {"male": 1, "female": 2, "auto": 0}.get(argv[i])
                if p.sex is None:
                    sys.stderr.write(_usage_text(p, n_threads_c))
                    return 1
            elif a == "--error_prob":
                i += 1
                p.error_prob = _caf(argv[i])
            elif a == "--min_confirming":
                i += 1
                p.min_confirming = _cl(argv[i])
            elif a == "--min_group_coverage":
                i += 1
                p.min_group_coverage = _cl(argv[i])
            elif a == "--max_divergent":
                i += 1
                p.max_divergent = _cl(argv[i])
            elif a == "--min_align_len":
                i += 1
                p.min_align_len = _cl(argv[i])
            elif a == "--min_group_size":
                i += 1
                p.min_group_size = _cl(argv[i])
            elif a == "--min_group_rsize":
                i += 1
                p.min_group_rsize = _caf(argv[i])
            elif a == "--max_group_divergence":
                i += 1
                p.max_group_divergence = _cl(argv[i])
            elif a == "--max_group_rdivergence":
                i += 1
                p.max_group_rdivergence = _cl(argv[i])
            elif a == "--skip_end_align":
                i += 1
                p.skip_end_align = _cl(argv[i])
            elif a == "--skip_end_call":
                i += 1
                p.skip_end_call = _cl(argv[i])
            elif a == "--allow_one_dir":
                p.require_both_dirs = False
            elif a == "--coverage":
                i += 1
                v = argv[i]
                if v == "ignore":
                    p.coverage = -2
                elif v == "local":
                    p.coverage = -1
                elif v == "median":
                    p.coverage = 0
                else:
                    p.coverage = _caf(v)
                    if not p.coverage:
                        sys.stderr.write(
                            "Coverage has to be positive real value\n")
                        return 1
            elif a == "--min_p":
                i += 1
                p.min_p = _caf(argv[i])
            elif a == "--min_pmut":
                i += 1
                p.min_pmut = _caf(argv[i])
            elif a == "--exome":
                p.exome = True
            elif a == "--num_threads":
                i += 1
                n_threads_c = _cl(argv[i])
                num_threads = min(max(n_threads_c, 0), 1024)
            elif a == "--print_reads":
                p.print_reads = True
            elif a == "--seq_dir":
                i += 1
                seq_dir = argv[i]
            elif a == "--output":
                i += 1
                p.output = {"poly": 0, "best": 1, "all": 2}.get(argv[i])
                if p.output is None:
                    sys.stderr.write(_usage_text(p, n_threads_c))
                    return 1
            elif a == "--counts":
                p.print_extra = 1
            elif a == "--extra":
                p.print_extra = 2
            elif a == "--alternatives":
                p.alternative_calls = True
            elif a == "--max_read_length":
                i += 1
                p.max_read_length = _cl(argv[i])
            elif a == "--max_reference_length":
                i += 1
                p.max_reference_length = _cl(argv[i])
            elif a in ("--prefetch_seq", "--dont_prefetch_db"):
                pass
            elif a == "-D":
                p.debug += 1
            elif a == "-DG":
                p.debug_groups += 1
            elif a == "-ta":
                _test_alignment(argv[i + 1], argv[i + 2])
                return 0
            else:
                if not a[:1].isalpha():
                    # reference: message + usage screen, both on stderr
                    sys.stderr.write(f"Invalid argument {a}\n")
                    sys.stderr.write(_usage_text(p, n_threads_c))
                    return 1
                if len(kmers_cli) < MAX_KMERS:
                    kmers_cli.append(a)
            i += 1
    except (IndexError, ValueError):
        # missing flag value: print_usage (stderr, 0, 1)
        sys.stderr.write(_usage_text(p, n_threads_c))
        return 1

    # both mandatory-argument failures show only the usage screen
    # (src/gassembler.c:921-927)
    if not db_name or (not input_name and not region_args):
        sys.stderr.write(_usage_text(p, n_threads_c))
        return 1

    with trace.span("load"):
        from genometester4_tpu_torch.formats.gmerdb_binary import \
            load_binary_db
        from genometester4_tpu_torch.utils.native import srand

        p.db_name = db_name   # echoed by the -DD Arguments trace
        srand(1)
        # stderr chrome order mirrors the reference main
        # (src/gassembler.c:929-961): db load -> coverage -> SNV/FP ->
        # "Loading read sequences" -> sex
        if p.debug:
            sys.stderr.write("Loading reads database %s... " % db_name)
        from genometester4_tpu_torch.utils.gt4mmap import gt4_mmap_fail
        mf = gt4_mmap_fail(db_name)
        if mf is not None:
            sys.stderr.write(mf)
            sys.stderr.write("cannot mmap (no such file?)\n")
            return 1
        db = load_binary_db(db_name, lazy=True)
        if db is None:
            sys.stderr.write("cannot read (wrong file format?)\n")
            return 1
        if db.index is None:
            sys.stderr.write("no index\n")
            return 1
        if p.debug:
            sys.stderr.write("done\n")

        coverage = p.coverage
        if coverage == 0:
            coverage = find_coverage(db.index, debug=p.debug)

        snvs = fps = None
        if snv_db_name:
            from genometester4_tpu_torch.pipelines.gassemble import read_snvs
            sys.stderr.write("Loading SNV database\n")
            snvs = read_snvs(snv_db_name)
            sys.stderr.write("Num SNVs %d\n" % len(snvs))
        if fp_db_name:
            from genometester4_tpu_torch.pipelines.gassemble import read_fps
            sys.stderr.write("Loading known false positives\n")
            fps = read_fps(fp_db_name, debug=p.debug)
            sys.stderr.write("Num false positives %d\n" % len(fps))

        if p.debug:
            sys.stderr.write("Loading read sequences\n")
        from genometester4_tpu_torch.pipelines.gassemble import SeqFilesError
        try:
            files = SeqFiles(db.index.files, seq_dir)
        except SeqFilesError:
            sys.stderr.write("Cannot read sequences: terminating\n")
            return 1
        sex = p.sex
        if sex == 0:
            sex = auto_sex(db)
        asm = Assembler(db, files, p, sex, coverage, snvs=snvs, fps=fps,
                        device=device)
        out = sys.stdout

        if input_name:
            from genometester4_tpu_torch.utils.gt4mmap import gt4_mmap_fail
            mf = gt4_mmap_fail(input_name)
            if mf is not None:
                # src/gassembler.c:1000-1003 / 1035-1038
                sys.stderr.write(mf)
                sys.stderr.write(f"Cannot mmap input file {input_name}\n")
                return 1

    if input_name and only_pos:
        # --pos: scan the region file for the covering region and run the
        # single-region recursive path (src/gassembler.c:1032-1077)
        with open(input_name, "rb") as f:
            data = f.read()
        pos = 0
        n = len(data)
        while pos < n:
            toks = _split_line(data, pos, MAX_KMERS + 4)
            while pos < n and data[pos] != 0x0A:
                pos += 1
            while pos < n and data[pos] <= 0x20:
                pos += 1
            if len(toks) < 5:
                sys.stderr.write("process: Too few tokens at line\n")
                continue
            chrs = data[toks[0][0]:toks[0][1]][:31].decode("latin1")
            chr_ = chr_from_string(chrs)
            if chr_ != only_chr:
                continue
            start = int(data[toks[1][0]:toks[1][1]])
            if start > only_pos:
                break
            end = int(data[toks[2][0]:toks[2][1]])
            if end <= only_pos:
                continue
            if end - start > p.max_reference_length:
                sys.stderr.write(
                    "WARNING: Region %u-%u is longer than maximum allowed "
                    "length (%u), skipping\n".replace("%u", "%d")
                    % (start, end, p.max_reference_length))
                continue
            ref = data[toks[3][0]:toks[3][1]].decode("latin1")
            kmers = [data[s_:e_].decode("latin1") for s_, e_ in toks[4:]]
            _assemble_recursive(asm, out, p, sex, chr_, start, end, ref,
                                kmers)
        return 0

    if input_name:
        out.write("#KATK version: %s\n" % REF_VERSION_3)
        out.write("#KMer Database: %s\n" % db_name)
        if coverage >= 0:
            out.write("#Coverage: %.2f\n" % coverage)
        else:
            out.write("#Coverage: local\n")
        print_header(out, p)
        out.write("\n")

        oq = OutputQueue(out, p)
        with trace.span("load"):
            with open(input_name, "rb") as f:
                data = f.read()
            pos = 0
            line_no = 0
            n = len(data)
            regions = []
            while pos < n and line_no < max_regions:
                toks = _split_line(data, pos, MAX_KMERS + 4)
                while pos < n and data[pos] != 0x0A:
                    pos += 1
                while pos < n and data[pos] <= 0x20:
                    pos += 1
                line_no += 1
                if len(toks) < 5:
                    sys.stderr.write("process: Too few tokens at line %u\n"
                                     % line_no)
                    continue
                chrs = data[toks[0][0]:toks[0][1]][:31].decode("latin1")
                chr_ = chr_from_string(chrs)
                start = int(data[toks[1][0]:toks[1][1]])
                end = int(data[toks[2][0]:toks[2][1]])
                ref = data[toks[3][0]:toks[3][1]].decode("latin1")
                kmers = [data[s:e].decode("latin1") for s, e in toks[4:]]
                regions.append(Region(chr_, start, end, ref, kmers))

        def _shell(region):
            return CallBlock(region.chr, region.start, region.end, haploid=(
                (sex == 1 and region.chr in (23, 24))
                or region.chr == CHR_MT))

        if num_threads > 1 and len(regions) > 1 and not p.print_reads:
            _parallel_assemble(asm, oq, regions, _shell, num_threads)
        else:
            for i, region in enumerate(regions):
                cb = _shell(region)
                oq.start_block(cb)
                oq.flush()
                # cross-region device SW batching: fill the pending
                # window's SW matrices in one lane-batched launch (no-op
                # on host-SW configs / under -D; byte-order preserved —
                # pipelines.gassemble.Assembler.prefetch_device_sw)
                asm.prefetch_device_sw(regions, i)
                asm.assemble(region, cb)
                oq.finish_block(cb)
        oq.flush()
    else:
        chr_ = chr_from_string(region_args[0])
        start, end = region_args[1], region_args[2]
        ref = region_args[3]
        _assemble_recursive(asm, out, p, sex, chr_, start, end, ref,
                            kmers_cli)
    return 0


# --- parallel region assembly -------------------------------------------
#
# The reference farms region lines out to pthreads sharing one unlocked
# rand() stream, so its multi-threaded output is schedule-dependent
# (src/gassembler.c:541-600,2619-2626). Here workers are forked
# processes and each region's rand() consumption is precomputed — a
# region draws exactly MAX_READS_PER_REGION values iff its unique-read
# count exceeds that cap, and that count is a pure function of the index
# — so every worker fast-forwards its inherited glibc stream to the
# exact offset the sequential run would have reached. Assembly runs in
# parallel; CallBlock retirement (genomic-order printing with
# cross-block best-call selection) stays in the parent. Output is
# byte-identical to --num_threads 1 for every thread count.

_PAR_STATE: dict = {}


def _parallel_worker(task):
    import os
    # forked workers must not touch the card (CUDA cannot run in a
    # forked child): host SW path only
    os.environ["GT4_TPU_DEVICE_SW"] = "0"
    idx, region, haploid, skip_to, cons = task
    from genometester4_tpu_torch.utils.native import rand_skip
    st = _PAR_STATE
    rand_skip(skip_to - st["rand_pos"])
    st["rand_pos"] = skip_to + cons
    cb = CallBlock(region.chr, region.start, region.end, haploid=haploid)
    try:
        st["asm"].assemble(region, cb)
    except SystemExit as e:  # "No such kmer": re-raised in the parent
        return idx, None, int(e.code or 0)
    return idx, cb, None


def _parallel_assemble(asm, oq, regions, shell, num_threads: int):
    import multiprocessing as mp
    from genometester4_tpu_torch.pipelines.gassemble import (
        region_rand_consumption, MAX_READS_PER_KMER)

    tasks = []
    off = 0
    for i, region in enumerate(regions):
        max_rpk = 2000 if region.chr == CHR_MT else MAX_READS_PER_KMER
        cons = region_rand_consumption(asm.db, region.kmers, max_rpk)
        tasks.append((i, region, shell(region).haploid, off, cons))
        off += cons

    _PAR_STATE["asm"] = asm
    _PAR_STATE["rand_pos"] = 0
    ctx = mp.get_context("fork")
    with ctx.Pool(min(num_threads, len(tasks))) as pool:
        for (idx, cb, exit_code), region in zip(
                pool.imap(_parallel_worker, tasks), regions):
            shell_cb = shell(region)
            oq.start_block(shell_cb)
            oq.flush()
            if exit_code is not None:
                raise SystemExit(exit_code)
            shell_cb.calls = cb.calls
            oq.finish_block(shell_cb)
    # the parent's own stream must land where sequential processing
    # would have (later draws, if any, must match)
    from genometester4_tpu_torch.utils.native import rand_skip
    rand_skip(off)


def _assemble_recursive(asm, out, p, sex, chr_, start, end, ref, kmers):
    """src/gassembler.c:1092-1128 + printing via recalculate_and_call."""
    region = Region(chr_, start, end, ref[:end - start], kmers)
    cb = CallBlock(chr_, start, end, haploid=(
        (sex == 1 and chr_ in (23, 24)) or chr_ == CHR_MT))
    res, state = asm._align_phase(region)
    if res > 0:
        res = asm._group_phase(region, cb, state)
        if res > 0:
            print_header(out, p)
            out.write("\n")
            for call in cb.calls:
                print_call(out, cb, call, p)
                out.write("\n")
    elif res == 0:
        mid = (start + end) // 2
        r = _assemble_recursive(asm, out, p, sex, chr_, start, mid, ref,
                                kmers)
        r += _assemble_recursive(asm, out, p, sex, chr_, mid, end,
                                 ref[mid - start:], kmers)
        return r
    return res


def _test_alignment(a: str, b: str):
    """-ta debug flag (src/gassembler.c:1898-1911)."""
    from genometester4_tpu_torch.ops import swalign
    from genometester4_tpu_torch.pipelines.gassemble import _C2N
    ac = _C2N[np.frombuffer(a.encode(), np.uint8)].astype(np.int8)
    bc = _C2N[np.frombuffer(b.encode(), np.uint8)].astype(np.int8)
    score, sx, sy = swalign.sw_matrices_batch(ac, bc[None, :])
    a_p, b_p = swalign.sw_traceback(score[0], sx[0], sy[0], len(bc))
    sys.stdout.write("align_len %d\n" % len(a_p))
    for i in range(len(a_p)):
        sys.stdout.write("%d %d\n" % (a_p[i], b_p[i]))


if __name__ == "__main__":
    raise SystemExit(main())
