"""FASTA/FASTQ ingestion: the whole-file parse (``load_file``) and the
streaming slab readers (the port's copy of ``load_file``,
``iter_code_slabs``, ``iter_slabs_indexed`` and what they call,
``genometester4_tpu/io/fasta.py``). Both readers run one slab loop
(``_slab_loop``), which reads a regular file in place and frames and
decodes FASTQ in one native call, with the JAX package's slabs.

Replaces the reference's byte-at-a-time state machine parser
(src/fasta.c:127-288) with a fully vectorized numpy parse: the whole
buffer is classified in a handful of array passes, producing one packed
uint8 code array (values 0-3; 255 = invalid/N/record separator) ready to
ship to the device k-mer extraction kernel.

Semantics preserved from the reference:
* any byte outside ACGTUacgtu resets the k-mer window (src/fasta.c:258-264)
  — here such bytes simply carry code 255 and the device kernel masks
  every window containing one;
* sequences never run together: one 255 sentinel separates consecutive
  records, so no window spans a record boundary;
* gzip input is supported (src/sequence-zstream.c) via Python's zlib;
* ``-`` reads stdin (src/sequence-stream.h:64-66).
"""

from __future__ import annotations

import ctypes
import gzip
import mmap
import os
import stat
import sys
import threading
from dataclasses import dataclass

import numpy as np

from genometester4_tpu_torch.ops.encode import NUCL_CODES
from genometester4_tpu_torch.utils import trace

_NL = ord("\n")
_CR = ord("\r")
_GT = ord(">")
_AT = ord("@")
_SEP = np.full(1, 255, np.uint8)  # separates windows at a record's end


def open_source(path: str) -> bytes:
    """Read a FASTA/FASTQ file (plain, .gz, or '-' for stdin) into bytes."""
    if path == "-":
        return sys.stdin.buffer.read()
    with open(path, "rb") as f:
        head = f.read(2)
        f.seek(0)
        if head == b"\x1f\x8b":
            return gzip.decompress(f.read())
        return f.read()


@dataclass
class ParsedSequences:
    """Result of a parse: packed codes plus per-record bookkeeping.

    codes          uint8[ total_bases + n_records ] — 2-bit codes with a
                   255 sentinel after each record's bases
    rec_starts     int64[n_records] — offset of each record's first base
                   in ``codes``
    rec_lengths    int64[n_records] — number of bases per record
    """

    codes: np.ndarray
    rec_starts: np.ndarray
    rec_lengths: np.ndarray
    _name_spans: np.ndarray | None = None  # (n,2) byte offsets into _data
    # FASTQ only: raw byte length of each sequence line INCLUDING a
    # trailing '\r' — the reference's registry seq_len is cpos at the
    # ending '\n' minus seq_pos (src/glistmaker.c:1042-1049), a byte
    # span, not a nucleotide count (fuzz_ingest finding, round 3)
    _seq_raw_lengths: np.ndarray | None = None
    _data: bytes | None = None
    # number of 'N'/'n' bytes among sequence characters (gmer_counter
    # --stats counts Ns separately from other invalid chars,
    # src/gmer_counter.c:929-936)
    count_n: int = 0

    @property
    def n_records(self) -> int:
        return len(self.rec_starts)

    @property
    def total_bases(self) -> int:
        return int(self.rec_lengths.sum())


def _line_index(data: np.ndarray):
    """Return (line_starts, line_ends) excluding the trailing empty line."""
    nl = np.flatnonzero(data == _NL)
    starts = np.empty(len(nl) + 1, dtype=np.int64)
    starts[0] = 0
    starts[1:] = nl + 1
    ends = np.append(nl, len(data))
    keep = starts < ends  # drop empty trailing line
    return starts[keep], ends[keep]


def _strip_cr(data: np.ndarray, ends: np.ndarray) -> np.ndarray:
    e = ends.copy()
    has_cr = (e > 0) & (data[np.minimum(e - 1, len(data) - 1)] == _CR) & (e <= len(data))
    e[has_cr] -= 1
    return e


def _scatter_records(data: np.ndarray, seq_spans_start, seq_spans_end,
                     rec_id_of_span, n_records):
    """Compact sequence-line spans into the packed code array.

    Each record's bases are concatenated; a 255 sentinel follows each
    record. Mask-based single-pass extraction: spans are marked with a
    +1/-1 delta array whose prefix sum is the keep mask — no per-base
    index arrays (building 8-byte indices per base was 10x slower than
    the whole parse needs to be).
    """
    span_lens = (seq_spans_end - seq_spans_start).astype(np.int64)
    total = int(span_lens.sum())
    delta = np.zeros(len(data) + 1, np.int32)
    np.add.at(delta, seq_spans_start, 1)
    np.add.at(delta, seq_spans_end, -1)
    mask = np.cumsum(delta[:-1], dtype=np.int32) > 0
    seq_bytes = data[mask]
    count_n = int(((seq_bytes == ord("N")) | (seq_bytes == ord("n"))).sum())
    codes_flat = NUCL_CODES[seq_bytes]
    rec_lengths = np.zeros(n_records, np.int64)
    np.add.at(rec_lengths, rec_id_of_span, span_lens)
    # one 255 sentinel after each record: insert at cumulative lengths
    sentinel_at = np.cumsum(rec_lengths)
    out = np.insert(codes_flat, sentinel_at, np.uint8(255))
    rec_starts = np.concatenate([[0], (rec_lengths + 1).cumsum()[:-1]])
    return out, rec_starts, rec_lengths, count_n


def parse_fasta(raw: bytes) -> ParsedSequences:
    data = np.frombuffer(raw, dtype=np.uint8)
    starts, ends = _line_index(data)
    raw_ends = ends  # name spans keep '\r': the reference's NAME state
    # appends every byte until '\n' (src/fasta.c:145-174), so CRLF names
    # include the '\r' and registry seq positions shift accordingly
    ends = _strip_cr(data, ends)
    is_header = data[starts] == _GT
    header_idx = np.flatnonzero(is_header)
    if len(header_idx) == 0:
        raise ValueError("no FASTA records found (no '>' lines)")
    # sequence lines belong to the most recent header
    rec_of_line = np.cumsum(is_header) - 1  # -1 before first header
    seq_mask = (~is_header) & (rec_of_line >= 0)
    out, rec_starts, rec_lengths, count_n = _scatter_records(
        data, starts[seq_mask], ends[seq_mask], rec_of_line[seq_mask],
        len(header_idx))
    name_spans = np.stack([starts[header_idx] + 1, raw_ends[header_idx]],
                          axis=1)
    return ParsedSequences(out, rec_starts, rec_lengths, name_spans,
                           _data=raw, count_n=count_n)


def _line_index_fastq(data: np.ndarray):
    """Line index counting EVERY '\\n'-delimited segment — including
    zero-length ones — minus the virtual segment after a trailing
    newline. The reference's FASTQ state machine is strictly
    line-driven (src/fasta.c:190-293: sequence ends at the first '\\n',
    quality is exactly one line), so a record with an EMPTY sequence or
    quality line ("@n\\n\\n+\\n\\n") still occupies four lines; dropping
    zero-length lines (what _line_index does, correctly, for FASTA)
    shifted the 4-line cadence and lost records (round-4 fuzz_ingest
    finding, seed 517)."""
    nl = np.flatnonzero(data == _NL)
    starts = np.empty(len(nl) + 1, dtype=np.int64)
    starts[0] = 0
    starts[1:] = nl + 1
    ends = np.append(nl, len(data))
    if len(starts) and starts[-1] >= ends[-1]:
        starts, ends = starts[:-1], ends[:-1]
    return starts, ends


def parse_fastq(raw: bytes) -> ParsedSequences:
    """Standard 4-line-per-record FASTQ (name/seq/+/quality)."""
    data = np.frombuffer(raw, dtype=np.uint8)
    starts, ends = _line_index_fastq(data)
    raw_ends = ends  # see parse_fasta: names keep '\r' (src/fasta.c:145-174)
    ends = _strip_cr(data, ends)
    n_lines = len(starts)
    n_records = n_lines // 4
    if n_records == 0:
        raise ValueError("no complete FASTQ records")
    if n_lines % 4 and n_lines - n_records * 4 >= 2:
        # trailing partial record with a sequence line: reference's --recover
        # path skips malformed tails; we do the same silently here
        pass
    seq_lines = np.arange(n_records, dtype=np.int64) * 4 + 1
    out, rec_starts, rec_lengths, count_n = _scatter_records(
        data, starts[seq_lines], ends[seq_lines],
        np.arange(n_records, dtype=np.int64), n_records)
    hdr_lines = seq_lines - 1
    name_spans = np.stack([starts[hdr_lines] + 1, raw_ends[hdr_lines]],
                          axis=1)
    return ParsedSequences(out, rec_starts, rec_lengths, name_spans,
                           (raw_ends[seq_lines] - starts[seq_lines])
                           .astype(np.int64), raw, count_n)


def parse_sequences(raw: bytes) -> ParsedSequences:
    """Auto-detect FASTA ('>') vs FASTQ ('@') by first byte, like the
    reference's format sniffing (src/fasta.c:140-152)."""
    i = 0
    while i < len(raw) and raw[i] in (_NL, _CR, ord(" "), ord("\t")):
        i += 1
    if i >= len(raw):
        raise ValueError("empty sequence file")
    if raw[i] == _GT:
        return parse_fasta(raw)
    if raw[i] == _AT:
        return parse_fastq(raw)
    raise ValueError(f"unrecognized sequence format (first byte {raw[i]!r})")


def load_file(path: str) -> ParsedSequences:
    """Parse a whole FASTA/FASTQ file (plain, .gz or '-') at once."""
    return parse_sequences(open_source(path))

# ---------------------------------------------------------------------------
# Streaming slab ingestion: bounded-RAM parsing for inputs larger than RAM.
#
# The reference never holds a whole file's parse in memory — its byte
# state machine streams (src/fasta.c:127-288) and plain files are cut
# into 100 MB mmap blocks at record boundaries (src/sequence-block.c:
# 148-206, src/listmaker-queue.c:116-161). This is the same role: the
# file is read in slabs, each slab is parsed with the vectorized parser,
# and k-1 trailing codes carry across the seam so no window is lost when
# a record spans slabs. Peak RAM is O(slab), not O(file).
# ---------------------------------------------------------------------------


@dataclass
class SlabMeta:
    """Per-slab bookkeeping (new content only, the overlap prefix of a
    spanning record is not double counted)."""
    n_records: int       # records STARTED in this slab
    total_bases: int     # sequence characters parsed in this slab
    count_n: int         # N/n among them
    prefix_len: int = 0  # leading codes repeated from the previous slab
                         # (overlap carry) — slice them off for per-byte
                         # statistics over new content
    # FASTQ slabs only (records never span slabs there), int64[n_records]
    # each: the start offset of each record within this slab's codes
    # array; the ABSOLUTE byte offsets in the (decompressed) stream of its
    # name and of its header line's end ('\r' kept, as parse_fastq's name
    # spans); its sequence line's raw byte length ('\r' included, as
    # parse_fastq's _seq_raw_lengths) — what the read index needs
    rec_starts: object = None
    name_pos: object = None
    name_end: object = None
    seq_len: object = None


def _iter_raw_slabs(path: str, slab_bytes: int):
    """Yield raw byte slabs from a plain/gzip file or stdin; the open and
    each slab's read or inflate are the span "read"."""
    import zlib
    if path == "-":
        f = sys.stdin.buffer
        while True:
            with trace.span("read"):
                b = f.read(slab_bytes)
            if not b:
                return
            yield b
    else:
        with trace.span("read"):
            f = open(path, "rb")
            head = f.read(2)
            f.seek(0)
        with f:
            if head == b"\x1f\x8b":
                d = zlib.decompressobj(wbits=31)
                eof = False
                while not eof:
                    with trace.span("read"):
                        out = []
                        size = 0
                        while size < slab_bytes:
                            comp = f.read(1 << 20)
                            if not comp:
                                eof = True
                                break
                            piece = d.decompress(comp)
                            out.append(piece)
                            size += len(piece)
                        if eof:
                            tail = d.flush()
                            if tail:
                                out.append(tail)
                        slab = b"".join(out) if out else None
                    if slab is not None:
                        yield slab
            else:
                while True:
                    with trace.span("read"):
                        b = f.read(slab_bytes)
                    if not b:
                        return
                    yield b


def _parse_fasta_slab(head, continuing: bool):
    """Parse a newline-terminated FASTA fragment whose leading lines may
    continue a record opened in a previous slab, with the native byte-scan
    (``fgx_parse_fasta_slab``, native/listkernel.c).

    Returns (codes, n_new_records, count_n, total_bases) where ``codes``
    has a 255 sentinel between records but NONE after the final record,
    which may continue into the next slab."""
    from genometester4_tpu_torch.utils.native import get_lib
    data = np.frombuffer(head, dtype=np.uint8)
    codes = np.empty(len(data) + 1, np.uint8)
    nh = ctypes.c_long(0)
    tb = ctypes.c_long(0)
    cn = ctypes.c_long(0)
    m = get_lib().fgx_parse_fasta_slab(data, len(data), int(continuing),
                                       codes, ctypes.byref(nh),
                                       ctypes.byref(tb), ctypes.byref(cn))
    if m < 0:
        raise ValueError("no FASTA records found (no '>' lines)")
    return codes[:m], int(nh.value), int(cn.value), int(tb.value)


def _fastq_frame_decode(data, at_eof: bool, abs_off: int, piece: int = 0):
    """Frame and decode FASTQ bytes in one native call
    (``csrc/slabparse.c``): (bytes consumed, codes, SlabMeta) of the whole
    4-line groups at the front of ``data``; the rest is the caller's
    carry. ``at_eof`` makes a last line with no newline a line, as
    ``parse_fastq`` reads one. ``piece`` (bytes per piece, 0 for the
    call's own choice) lets the tests set the pieces' seams.

    The codes and the metadata are fresh arrays of the caller's; the
    record arrays are sized by a bound of 32 bytes a record (pages past
    the records written are never touched) and sized again, exactly, in
    the rare slab of shorter records."""
    from genometester4_tpu_torch.utils.native import get_lib
    lib = get_lib()
    raw = np.frombuffer(data, np.uint8)
    n = len(raw)
    codes = np.empty(n + 1, np.uint8)
    out = np.zeros(4, np.int64)
    cap = n // 32 + 4
    while True:
        recs = np.empty((4, cap), np.int64)
        used = lib.gt4_fastq_frame_decode(raw, n, int(at_eof), piece, codes,
                                          *recs, cap, out)
        if used != -1:
            break
        cap = int(out[1])
    if used < 0:
        raise MemoryError("FASTQ slab parse: no memory for its pieces")
    nrec = int(out[1])
    rec_starts, name_pos, name_end, seq_len = recs[:, :nrec]
    name_pos += abs_off
    name_end += abs_off
    return used, codes[:out[0]], SlabMeta(
        nrec, int(out[2]), int(out[3]), rec_starts=rec_starts,
        name_pos=name_pos, name_end=name_end, seq_len=seq_len)


class _BufferPool:
    """Grow-only pool of slab buffers, reused across slabs and calls. A
    reader takes one for its life and gives it back when it ends, so two
    live readers never share one; the ``KEEP`` largest free ones stay.
    A buffer is an anonymous ``mmap``: its pages are first touched by the
    read that fills them, not zeroed beforehand as a ``bytearray``'s are,
    and it has ``rfind`` for the FASTA cut."""

    KEEP = 2

    def __init__(self):
        self._free: list = []
        self._lock = threading.Lock()

    def take(self, n: int) -> mmap.mmap:
        """The smallest free buffer of at least ``n`` bytes, or a new one."""
        with self._lock:
            fits = [i for i, b in enumerate(self._free) if len(b) >= n]
            if fits:
                return self._free.pop(min(fits,
                                          key=lambda i: len(self._free[i])))
        return mmap.mmap(-1, n)

    def give(self, buf: mmap.mmap) -> None:
        with self._lock:
            self._free.append(buf)
            self._free.sort(key=len, reverse=True)
            del self._free[self.KEEP:]


_BUFFERS = _BufferPool()


class _FileSlabs:
    """A regular uncompressed file read in place: each slab is read with
    ``readinto`` into one pooled buffer, behind the carry ``buf[lo:hi]``
    that ``compact`` moved to the front, and no read is made past the
    size ``fstat`` gave. The buffer holds a slab and room for a carry, or
    only what the file holds when that is less."""

    inplace = True

    def __init__(self, f, size: int, slab_bytes: int):
        self.f = f
        self.left = size
        self.slab = slab_bytes
        self.buf = b""        # no buffer until the first read
        self.lo = self.hi = 0

    def compact(self) -> None:
        """Move the carry to the front of the buffer: one memmove."""
        n = self.hi - self.lo
        if self.lo and n:
            base = ctypes.addressof(
                (ctypes.c_char * len(self.buf)).from_buffer(self.buf))
            ctypes.memmove(base, base + self.lo, n)
        self.lo, self.hi = 0, n

    def read(self) -> bool:
        """Read the next slab behind the carry (the span "read"); False
        once the file is read."""
        want = min(self.slab, self.left)
        if not want:
            return False
        with trace.span("read"):
            need = self.hi + want
            if len(self.buf) < need:
                self._grow(need if want == self.left
                           else need + (self.slab >> 4))
            view = memoryview(self.buf)
            got = 0
            while got < want:
                n = self.f.readinto(view[self.hi + got:self.hi + want])
                if not n:
                    break
                got += n
        self.left = self.left - got if got == want else 0
        self.hi += got
        return got > 0

    def _grow(self, size: int) -> None:
        buf = _BUFFERS.take(size)
        buf[:self.hi] = self.buf[:self.hi]
        self._release()
        self.buf = buf

    def _release(self) -> None:
        if len(self.buf):
            _BUFFERS.give(self.buf)
        self.buf = b""

    def close(self) -> None:
        self.f.close()
        self._release()


class _StreamSlabs:
    """stdin, a pipe or gzip: the slabs of ``_iter_raw_slabs``, each
    joined behind the carry."""

    inplace = False

    def __init__(self, raws):
        self.raws = raws
        self.buf = b""
        self.lo = self.hi = 0

    def compact(self) -> None:
        pass

    def read(self) -> bool:
        raw = next(self.raws, None)
        if raw is None:
            return False
        with trace.span("frame"):
            self.buf = self.buf[self.lo:self.hi] + raw
            self.lo, self.hi = 0, len(self.buf)
        return True

    def close(self) -> None:
        self.raws.close()


def _open_slabs(path: str, slab_bytes: int):
    """The slab source of ``path``: in place for a regular uncompressed
    file, else the stream reader. The open is the span "read"."""
    if path != "-":
        with trace.span("read"):
            f = open(path, "rb", buffering=0)
        try:
            st = os.fstat(f.fileno())
            if (stat.S_ISREG(st.st_mode)
                    and os.pread(f.fileno(), 2, 0) != b"\x1f\x8b"):
                return _FileSlabs(f, st.st_size, slab_bytes)
        except BaseException:
            f.close()
            raise
        f.close()
    return _StreamSlabs(_iter_raw_slabs(path, slab_bytes))


def _slab_loop(path: str, k: int, slab_bytes: int, whole_lines: bool = False):
    """The one slab loop behind ``iter_code_slabs`` and
    ``iter_slabs_indexed``.

    Yields (kind, codes, SlabMeta, head, offset, seam) a slab: ``kind`` is
    how the slab was decoded ("fasta": whole lines, "fastq": whole 4-line
    groups, "line": part of a FASTA line longer than a slab), ``codes``
    and ``meta`` are the slab's own codes and counts, with no prefix from
    the slab before (each reader joins its own), ``head`` is a view of the
    raw bytes decoded, valid until the next ``next()``, ``offset`` is its
    first byte's offset in the (decompressed) stream, and ``seam`` says
    that the FASTA record open at the seam ended exactly there. The last
    item is ("end", None, None, the format found ("fasta", "fastq", or
    None for a file of blanks), bytes read, False). With ``whole_lines`` a
    FASTA slab holding no newline raises ``ValueError``, as the JAX
    package's ``iter_slabs_indexed`` does, instead of being read on or
    decoded as a "line".

    A regular file is parsed in place: its slabs are read into one reused
    buffer (``_FileSlabs``), and a FASTQ slab is framed and decoded by one
    native call. stdin, pipes and gzip are read by ``_iter_raw_slabs``.
    Every yielded array is the caller's own; only the raw buffer is
    reused.

    Each slab's work is the span "parse", split into "read" (the open,
    each read or inflate), "frame" (the carry's move or join, the format
    sniff and the FASTA cut at the last whole line) and "decode" (for
    FASTQ the one native call, which also finds the cut). The counters ``parse.slabs`` and
    ``parse.inplace`` count the slabs read and those read in place.
    """
    fmt = None          # 'fasta' | 'fastq'
    open_record = False  # a FASTA record spans the seam
    abs_off = 0         # stream byte offset of src.buf[src.lo]
    src = None

    def frame():
        """What is ready to decode at the front of the carry and the new
        slab, src.buf[lo:hi], as (kind, view), or None; what is not taken
        stays in the carry (for "fastq" the native call takes its whole
        4-line groups)."""
        nonlocal fmt, abs_off
        buf, lo, hi = src.buf, src.lo, src.hi
        if fmt is None:
            i = lo
            while i < hi and buf[i] in (_NL, _CR, ord(" "), ord("\t")):
                i += 1
            abs_off += i - lo
            src.lo = lo = i
            if i >= hi:
                return None
            if buf[i] == _GT:
                fmt = "fasta"
            elif buf[i] == _AT:
                fmt = "fastq"
            else:
                raise ValueError(
                    f"unrecognized sequence format (first byte {buf[i]!r})")
        if fmt == "fastq":
            return "fastq", memoryview(buf)[lo:hi]
        cut = buf.rfind(b"\n", lo, hi) + 1
        if cut:
            src.lo = cut
            return "fasta", memoryview(buf)[lo:cut]
        if whole_lines:
            raise ValueError("iter_slabs_indexed: line longer than a slab")
        # no newline in a whole slab: a monster single-line sequence
        # — consume it directly unless it could be a header (headers
        # are assumed to fit one slab)
        if buf[lo] == _GT or not open_record:
            return None
        # a trailing '\r' could be the first half of a CRLF split across
        # slabs — the whole-file parse strips it (_strip_cr)
        end = hi - 1 if buf[hi - 1] == _CR else hi
        src.lo = end
        return "line", memoryview(buf)[lo:end]

    def decode(kind: str, head, at_eof: bool = False):
        nonlocal open_record, abs_off
        offset = abs_off
        if kind == "fastq":
            used, codes, meta = _fastq_frame_decode(head, at_eof, offset)
            src.lo += used
            abs_off += used
            return (kind, codes, meta, head[:used], offset, False) \
                if used else None
        seam = open_record and head[0] == _GT
        if kind == "line":
            seq = np.frombuffer(head, np.uint8)
            count_n = int(((seq == ord("N")) | (seq == ord("n"))).sum())
            codes = NUCL_CODES[seq]
            meta = SlabMeta(0, len(codes), count_n)
        else:
            codes, n_new, count_n, bases = _parse_fasta_slab(head,
                                                             open_record)
            meta = SlabMeta(n_new, bases, count_n)
            open_record = open_record or n_new > 0
        abs_off += len(head)
        return kind, codes, meta, head, offset, seam

    try:
        while True:
            item = None
            with trace.span("parse"):
                if src is None:
                    src = _open_slabs(path, slab_bytes)
                with trace.span("frame"):
                    src.compact()
                more = src.read()
                if more:
                    trace.count("parse.slabs")
                    if src.inplace:
                        trace.count("parse.inplace")
                    with trace.span("frame"):
                        ready = frame()
                    if ready is not None:
                        with trace.span("decode"):
                            item = decode(*ready)
            if not more:
                break
            if item is not None:
                yield item
        # EOF: flush whatever remains as final (possibly unterminated) lines
        carry = bytes(src.buf[src.lo:src.hi])
        size = abs_off + len(carry)
        if carry.strip() and (fmt == "fasta" or carry.count(b"\n") >= 3):
            with trace.span("parse"), trace.span("decode"):
                item = decode(fmt, carry, at_eof=True)
            if item is None:   # a whole FASTQ record at least
                raise ValueError("no complete FASTQ records")
            yield item
        yield "end", None, None, fmt, size, False
    finally:
        if src is not None:
            src.close()


def iter_code_slabs(path: str, k: int, slab_bytes: int = 1 << 28):
    """Stream a FASTA/FASTQ file as ready-to-count code slabs.

    Yields (codes, SlabMeta) where ``codes`` is a uint8 2-bit code array
    (255 = invalid/separator). Each slab is prefixed with the previous
    slab's final k-1 codes (plus a 255 separator when the record ended
    exactly at the seam), so running window extraction per slab loses no
    k-mer and counts none twice. Concatenating all slabs minus prefixes
    reproduces load_file(path).codes exactly. The slabs, their spans and
    counters are ``_slab_loop``'s; the prefix is joined in the span
    "decode".
    """
    tail = np.empty(0, np.uint8)  # the last k-1 codes decoded
    for kind, codes, meta, _, _, seam in _slab_loop(path, k, slab_bytes):
        if kind == "fastq":
            yield codes, meta
        elif kind != "end":
            with trace.span("parse"), trace.span("decode"):
                prefix = tail
                if seam and len(tail):
                    prefix = np.concatenate([tail, _SEP])
                meta.prefix_len = len(prefix)
                out = np.concatenate([prefix, codes])
                if k > 1:
                    tail = codes[-(k - 1):] if len(codes) >= k - 1 \
                        else np.concatenate([tail, codes])[-(k - 1):]
            yield out, meta


# ---------------------------------------------------------------------------
# Indexed slab streaming: O(slab) ingestion that ALSO tracks per-record
# identity and character positions — what gmer_counter --compile_index
# needs for FASTA input (role of the reference's block registry,
# src/sequence-block.c:148-206 + src/glistmaker.c:1030-1068). Each slab
# comes with a piecewise "segment" map: segment s covers code offsets
# [seg_starts[s], seg_starts[s+1]) and belongs to global record
# seg_rec[s], whose record-character offset at the segment start is
# seg_lpos0[s]. A window starting at code offset p therefore lies in
# record seg_rec[j], j = searchsorted(seg_starts, p, 'right')-1, at local
# position p - seg_starts[j] + seg_lpos0[j]. Sentinel (255) separator
# slots fall inside the preceding segment; windows there are invalid
# so their mapping is never read.
# ---------------------------------------------------------------------------


@dataclass
class IdxSlabMeta:
    seg_starts: np.ndarray    # int64[S]
    seg_rec: np.ndarray       # int64[S] global record index
    seg_lpos0: np.ndarray     # int64[S]
    name_spans: np.ndarray    # int64[n_started, 2] absolute byte offsets
    rec_base: int             # global index of first record started here
    n_started: int
    total_bases: int
    count_n: int
    prefix_len: int
    rec_lengths: np.ndarray | None = None  # FASTQ: chars per started rec


@dataclass
class IdxStreamEnd:
    stream_size: int          # total (decompressed) byte length
    n_records: int
    # not a field: the format the reader found, "fasta", "fastq", or None
    # for a file of blanks
    fmt = None


def _fasta_slab_meta(data: np.ndarray, continuing: bool):
    """Per-slab record metadata matching _parse_fasta_slab's code
    layout: (n_headers, name_spans_rel[n,2], rec_lengths[slots])."""
    starts, ends = _line_index(data)
    if len(starts) == 0:
        return (0, np.zeros((0, 2), np.int64),
                np.zeros(1 if continuing else 0, np.int64))
    raw_ends = ends  # see parse_fasta: names keep '\r' (src/fasta.c:145-174)
    ends = _strip_cr(data, ends)
    is_header = data[starts] == _GT
    n_headers = int(is_header.sum())
    rec_of_line = np.cumsum(is_header) - 1
    if continuing:
        rec_of_line = rec_of_line + 1
    n_recs = n_headers + (1 if continuing else 0)
    seq_mask = (~is_header) & (rec_of_line >= 0)
    rec_lengths = np.zeros(max(n_recs, 1), np.int64)[:n_recs]
    np.add.at(rec_lengths, rec_of_line[seq_mask],
              (ends - starts)[seq_mask])
    hs = starts[is_header]
    he = raw_ends[is_header]
    name_spans = np.stack([hs + 1, he], axis=1).astype(np.int64)
    return n_headers, name_spans, rec_lengths


def iter_slabs_indexed(path: str, k: int, slab_bytes: int = 1 << 28):
    """Stream FASTA/FASTQ as code slabs with record/position maps.

    Yields (codes, IdxSlabMeta) per slab and finally (None,
    IdxStreamEnd), field for field the JAX package's. Concatenating the
    slabs minus their prefixes reproduces the whole-file parse's codes
    exactly (same guarantee as iter_code_slabs; the k-1 overlap carry
    means no window is lost or double-counted at seams). The slabs are
    ``_slab_loop``'s, with its spans and counters: a FASTQ slab's maps
    come from its one native call, a FASTA slab's from its raw lines,
    built and joined to its prefix in the span "decode". The end's
    ``fmt`` says which format the file held."""
    tail_codes = np.empty(0, np.uint8)
    tail_segs = (np.zeros(1, np.int64), np.full(1, -1, np.int64),
                 np.zeros(1, np.int64))
    cur_rec = -1
    cur_lpos = 0
    next_rec = 0

    def build_fasta_slab(new, slab: SlabMeta, head, offset: int,
                         seam: bool):
        nonlocal tail_codes, tail_segs, cur_rec, cur_lpos, next_rec
        n_headers = slab.n_records
        bases = slab.total_bases
        open_record = next_rec > 0   # a record is open at the seam
        nh2, name_spans_rel, rec_lengths = _fasta_slab_meta(
            np.frombuffer(head, np.uint8), open_record)
        if nh2 != n_headers:
            raise ValueError("FASTA slab parsers disagree on the number of "
                             f"records ({n_headers} vs {nh2})")
        sep = seam and len(tail_codes)
        prefix = np.concatenate([tail_codes, _SEP]) if sep else tail_codes
        plen = len(prefix)
        codes = np.concatenate([prefix, new])
        # body segments from the parser's [cont][255][rec0][255]... layout
        seg_s = list(tail_segs[0])
        seg_r = list(tail_segs[1])
        seg_l = list(tail_segs[2])
        off = plen
        slot = 0
        if open_record and not sep:
            ln = int(rec_lengths[slot]) if len(rec_lengths) else 0
            seg_s.append(off)
            seg_r.append(cur_rec)
            seg_l.append(cur_lpos)
            off += ln
            slot = 1
        elif open_record and sep:
            # carried record closed at the seam: its zero-length slot
            # still occupies a sentinel in the parser layout
            ln = int(rec_lengths[0]) if len(rec_lengths) else 0
            off += ln          # always 0 chars (record had ended)
            slot = 1
        for j in range(n_headers):
            if slot + j > 0 or (open_record and not sep):
                off += 1       # sentinel before this record
            elif not open_record and j > 0:
                off += 1
            seg_s.append(off)
            seg_r.append(next_rec + j)
            seg_l.append(0)
            off += int(rec_lengths[slot + j]) if slot + j < len(
                rec_lengths) else 0
        meta = IdxSlabMeta(
            seg_starts=np.array(seg_s, np.int64),
            seg_rec=np.array(seg_r, np.int64),
            seg_lpos0=np.array(seg_l, np.int64),
            name_spans=(name_spans_rel + offset),
            rec_base=next_rec, n_started=n_headers,
            total_bases=bases, count_n=slab.count_n, prefix_len=plen)
        # state updates
        if n_headers:
            cur_rec = next_rec + n_headers - 1
            cur_lpos = int(rec_lengths[-1])
        else:
            cur_lpos += bases
        next_rec += n_headers
        # carry tail mapping for the next slab
        t = min(k - 1, len(codes)) if k > 1 else 0
        q0 = len(codes) - t
        tail_codes = codes[q0:]
        ss, sr, sl = meta.seg_starts, meta.seg_rec, meta.seg_lpos0
        keep = []
        for s in range(len(ss)):
            seg_end = ss[s + 1] if s + 1 < len(ss) else len(codes)
            if seg_end > q0:
                new_start = max(0, int(ss[s]) - q0)
                new_l = int(sl[s]) + max(0, q0 - int(ss[s]))
                keep.append((new_start, int(sr[s]), new_l))
        if not keep:
            keep = [(0, cur_rec, cur_lpos)]
        tail_segs = (np.array([x[0] for x in keep], np.int64),
                     np.array([x[1] for x in keep], np.int64),
                     np.array([x[2] for x in keep], np.int64))
        return codes, meta

    for kind, codes, slab, head, offset, seam in _slab_loop(
            path, k, slab_bytes, whole_lines=True):
        if kind == "fasta":
            with trace.span("parse"), trace.span("decode"):
                item = build_fasta_slab(codes, slab, head, offset, seam)
            yield item
        elif kind == "fastq":
            n = slab.n_records
            yield codes, IdxSlabMeta(
                seg_starts=slab.rec_starts,
                seg_rec=np.arange(next_rec, next_rec + n, dtype=np.int64),
                seg_lpos0=np.zeros(n, np.int64),
                name_spans=np.stack([slab.name_pos, slab.name_end], axis=1),
                rec_base=next_rec, n_started=n,
                total_bases=slab.total_bases, count_n=slab.count_n,
                prefix_len=0, rec_lengths=slab.seq_len.copy())
            next_rec += n
        else:
            end = IdxStreamEnd(stream_size=offset, n_records=next_rec)
            end.fmt = head
            yield None, end
