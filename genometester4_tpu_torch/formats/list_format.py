"""GenomeTester4 ``.list`` file format — byte-compatible reader/writer (the
port's copy of ``genometester4_tpu/formats/list_format.py``).

Layout (reference: src/word-list.h:40-72, src/word-list.c:31-45):

* 48-byte little-endian header (``GT4ListHeader_4_4``)::

      u32 code           'G'<<24|'T'<<16|'4'<<8|'C'  (0x47543443)
      u32 version_major  4
      u32 version_minor  2
      u32 word_length    k (1..32)
      u64 n_words
      u64 total_count    sum of written counts (after cutoff)
      u64 list_start     offset of record data from header start (48)
      u32 word_bytes     8
      u32 count_bytes    4

* ``n_words`` packed 12-byte records: ``u64 word`` + ``u32 count``,
  sorted ascending by unsigned word (reference: src/word-map.h:89-105).

Older header versions 4.0 (no list_start; 40 bytes with padding) and 4.2
(no word_bytes/count_bytes) are up-converted on read exactly like
src/word-map.c:198-209 does.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

import numpy as np

# large record buffers: no transparent huge pages (utils.backend)
from genometester4_tpu_torch.utils.backend import disable_numpy_thp as _thp

_thp()

GT4_LIST_CODE = (ord("G") << 24) | (ord("T") << 16) | (ord("4") << 8) | ord("C")


class ListFileError(Exception):
    """A malformed list file the reference constructor rejects with its
    own stderr diagnostic and a NULL return (src/word-map.c:179-215);
    args[0] is the file path for the caller's "invalid or corrupted"
    line."""
VERSION_MAJOR = 4
VERSION_MINOR = 2

_HEADER_4_4 = struct.Struct("<IIIIQQQII")  # 48 bytes
_HEADER_4_0 = struct.Struct("<IIIIQQQ")  # 40 bytes

HEADER_SIZE = _HEADER_4_4.size
RECORD_SIZE = 12

# numpy dtype of one packed record (u64 word + u32 count, little-endian)
RECORD_DTYPE = np.dtype([("word", "<u8"), ("count", "<u4")])
assert RECORD_DTYPE.itemsize == RECORD_SIZE


@dataclass
class ListHeader:
    word_length: int
    n_words: int = 0
    total_count: int = 0
    list_start: int = HEADER_SIZE
    word_bytes: int = 8
    count_bytes: int = 4
    version_major: int = VERSION_MAJOR
    version_minor: int = VERSION_MINOR
    code: int = field(default=GT4_LIST_CODE)

    def pack(self) -> bytes:
        return _HEADER_4_4.pack(
            self.code,
            self.version_major,
            self.version_minor,
            self.word_length,
            self.n_words,
            self.total_count,
            self.list_start,
            self.word_bytes,
            self.count_bytes,
        )

    @staticmethod
    def unpack(buf: bytes) -> "ListHeader":
        if len(buf) < HEADER_SIZE:
            # the reference reads the header through an mmap: a file
            # shorter than 48 bytes yields zeros for the missing tail
            # (same page, stable zero-fill; src/word-map.c:173-210)
            buf = bytes(buf) + b"\0" * (HEADER_SIZE - len(buf))
        code, vmaj, vmin, wlen = struct.unpack_from("<IIII", buf, 0)
        if code != GT4_LIST_CODE:
            raise ValueError(f"not a GT4 .list file (magic {code:#x})")
        # Layout selection is on version_minor ALONE, exactly like
        # src/word-map.c:197-209: minor 0 -> 40-byte header with a
        # padding u64 and data at byte 40; minor 1-2 -> header's
        # list_start with implied 8/4 record bytes; minor >= 3 -> full
        # 4.4 header including word_bytes/count_bytes.
        if vmin >= 3:
            (code, vmaj, vmin, wlen, n_words, total, start, wb, cb) = (
                _HEADER_4_4.unpack_from(buf, 0)
            )
            return ListHeader(wlen, n_words, total, start, wb, cb, vmaj, vmin, code)
        (code, vmaj, vmin, wlen, n_words, total, start) = _HEADER_4_0.unpack_from(buf, 0)
        if vmin == 0:
            start = _HEADER_4_0.size
        return ListHeader(wlen, n_words, total, start, 8, 4, vmaj, vmin, code)


def read_list_header(path: str | os.PathLike) -> ListHeader:
    with open(path, "rb") as f:
        return ListHeader.unpack(f.read(HEADER_SIZE))


def read_list(path: str | os.PathLike, mmap: bool = True):
    """Read a .list file → (header, words u64 array, counts u32 array).

    With ``mmap=True`` the record region is memory-mapped (zero-copy view,
    like the reference's GT4WordMap, src/word-map.c:165-241).
    """
    hdr = read_list_header(path)
    need = hdr.list_start + hdr.n_words * RECORD_SIZE
    if os.path.getsize(path) < need:
        # Corrupt/truncated file that still passed the reference's size
        # check (word_bytes/count_bytes of 0 from a zero page make the
        # u64 product wraps; src/word-map.c:211). The reference's 12-byte
        # record macros then read whatever memory follows the mapping —
        # unstable garbage — so the reference is not an oracle here; we
        # read the bytes that exist and zero-fill the rest.
        try:
            blob = np.zeros(hdr.n_words * RECORD_SIZE, dtype=np.uint8)
        except (ValueError, MemoryError, OverflowError):
            raise ListFileError(str(path))
        with open(path, "rb") as f:
            f.seek(hdr.list_start)
            got = np.frombuffer(f.read(len(blob)), dtype=np.uint8)
        blob[:len(got)] = got
        recs = blob.view(RECORD_DTYPE)
    elif mmap and hdr.n_words:
        raw = np.memmap(path, dtype=np.uint8, mode="r", offset=hdr.list_start,
                        shape=(hdr.n_words * RECORD_SIZE,))
        recs = raw.view(RECORD_DTYPE)
    else:
        with open(path, "rb") as f:
            f.seek(hdr.list_start)
            recs = np.fromfile(f, dtype=RECORD_DTYPE, count=hdr.n_words)
    return hdr, recs["word"], recs["count"]


def raw_record_view(words: np.ndarray,
                    counts: np.ndarray | None = None) -> np.ndarray | None:
    """The raw 12-byte records behind a word view of a record array (a
    read_list(mmap) column, a shard copied back as records), as a uint8
    slice of exactly ``12 * len(words)`` bytes; None when ``words`` is no
    such view, or when ``counts`` is given and is not the same records'
    count field, 8 bytes after each word. Native kernels and the writer
    take the raw stream directly: no strided gather copy."""
    w = np.asarray(words)
    if w.ndim != 1 or w.strides != (RECORD_SIZE,) or w.dtype.itemsize != 8:
        return None
    if counts is not None:
        c = np.asarray(counts)
        if (c.shape != w.shape or c.strides != (RECORD_SIZE,)
                or c.dtype.itemsize != 4
                or c.ctypes.data != w.ctypes.data + 8):
            return None
    # walk to the deepest ndarray base holding the raw bytes; the view
    # chain's shape varies across numpy versions, so the reliable check
    # is POINTER arithmetic: the words must lie inside the buffer, on the
    # record grid it holds from their first byte on
    b = getattr(w, "base", None)
    deepest = None
    while isinstance(b, np.ndarray):
        deepest = b
        b = getattr(b, "base", None)
    if deepest is None or not deepest.flags.c_contiguous:
        return None
    raw = deepest.reshape(-1).view(np.uint8)
    off = w.ctypes.data - raw.ctypes.data
    if 0 <= off and off + RECORD_SIZE * len(w) <= raw.nbytes:
        return raw[off: off + RECORD_SIZE * len(w)]
    return None


def pack_records(words: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Pack parallel (u64, u32) arrays into the 12-byte record byte stream."""
    recs = np.empty(len(words), dtype=RECORD_DTYPE)
    recs["word"] = words
    recs["count"] = counts
    return recs.view(np.uint8)


def record_bytes(words: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """The 12-byte record stream of a (words, counts) pair: the raw bytes
    behind them where they are the fields of one record array (no copy),
    else the pair packed."""
    raw = raw_record_view(words, counts)
    if raw is not None:
        return raw
    return pack_records(np.asarray(words, np.uint64),
                        np.asarray(counts, np.uint32))


def write_list(path: str | os.PathLike, word_length: int, words: np.ndarray,
               counts: np.ndarray, atomic: bool = True) -> ListHeader:
    """Write a sorted (words, counts) pair as a .list file.

    Caller is responsible for sorting and cutoff filtering. Uses the
    tmp-file + rename atomic publish convention of the reference
    (src/glistmaker.c:305-353).
    """
    counts = np.asarray(counts, dtype=np.uint32)
    recs = record_bytes(words, counts)
    hdr = ListHeader(word_length, n_words=len(counts),
                     total_count=int(counts.sum(dtype=np.uint64)))
    tmp = f"{path}.tmp.{os.getpid()}" if atomic else path
    with open(tmp, "wb") as f:
        f.write(hdr.pack())
        recs.tofile(f)
    if atomic:
        os.replace(tmp, path)
    return hdr


class ListWriter:
    """Streaming .list writer: append sorted record chunks, finalize header.

    Mirrors gt4_write_union's write-then-pwrite-header pattern
    (src/set-operations.c:40-129) so multi-gigabyte outputs never need to
    be resident in memory.
    """

    def __init__(self, path: str | os.PathLike, word_length: int, atomic: bool = True):
        self.path = os.fspath(path)
        self.word_length = word_length
        self.atomic = atomic
        self._tmp = f"{self.path}.tmp.{os.getpid()}" if atomic else self.path
        self._f = open(self._tmp, "wb")
        self._f.write(ListHeader(word_length).pack())  # placeholder
        self.n_words = 0
        self.total_count = 0

    # single write(2) calls above ~1 MB stall in the kernel's dirty-page
    # throttling (measured on a VM host: 600 MB in 12 MB calls = 5.8 s,
    # in 1 MB calls = 1.3 s); split large appends accordingly
    _WRITE_CHUNK = 1 << 20

    def _write_pieces(self, buf: np.ndarray):
        mv = memoryview(np.ascontiguousarray(buf).view(np.uint8)
                        .reshape(-1))
        for off in range(0, len(mv), self._WRITE_CHUNK):
            self._f.write(mv[off: off + self._WRITE_CHUNK])

    def append(self, words: np.ndarray, counts: np.ndarray):
        if len(words) == 0:
            return
        self._write_pieces(pack_records(
            np.asarray(words, dtype=np.uint64),
            np.asarray(counts, dtype=np.uint32)).reshape(-1))
        self.n_words += len(words)
        self.total_count += int(np.asarray(counts, dtype=np.uint64).sum())

    def append_records(self, rec_bytes: np.ndarray, n_words: int,
                       total_count: int):
        """Append pre-packed 12-byte records (native producers)."""
        if n_words == 0:
            return
        self._write_pieces(rec_bytes)
        self.n_words += n_words
        self.total_count += int(total_count)

    def close(self) -> ListHeader:
        hdr = ListHeader(self.word_length, self.n_words, self.total_count)
        self._f.seek(0)
        self._f.write(hdr.pack())
        self._f.close()
        if self.atomic:
            os.replace(self._tmp, self.path)
        return hdr

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        else:
            self._f.close()
            if self.atomic and os.path.exists(self._tmp):
                os.unlink(self._tmp)
