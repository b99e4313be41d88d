"""GenomeTester4 ``.index`` file format — byte-compatible reader/writer
(the port's copy of ``genometester4_tpu/formats/index_format.py``).

Layout (reference: src/index-map.h:60-83, writer src/glistmaker.c:366-782):

* 72-byte header: u32 code 'GT4I' (bytes "I4TG"), u32 version major(4)
  minor(2), u32 word_length, u64 num_words, u64 num_locations,
  u32 n_file_bits, u32 n_subseq_bits, u32 n_pos_bits, u32 filler,
  u64 files_start, u64 kmers_start, u64 locations_start.
* file block: "F4TG", u32 major, u32 minor, u32 n_files; per file:
  u64 size, u64 n_subseqs, u16 name_len (incl NUL), name bytes, then
  per subsequence 28 bytes (u64 name_pos, u32 name_len, u64 seq_pos,
  u64 seq_len); block zero-padded to 8 bytes.
* k-mer block: num_words records of (u64 word, u64 first_location).
* locations: u64 codes
  ``file << (sb+pb+1) | subseq << (pb+1) | pos << 1 | dir``, sorted
  ascending within each word's block.

Cutoff bug-compat (src/glistmaker.c:425-495 vs 499-576): words outside
[min,max] are dropped from the k-mer block and their locations are NOT
counted in the offsets, but their location blocks ARE still written —
so cutoff indices contain orphaned location data and the per-word
offsets point at the wrong blocks. We reproduce this for byte identity.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

GT4_INDEX_CODE = (ord("G") << 24) | (ord("T") << 16) | (ord("4") << 8) | ord("I")
_HEADER = struct.Struct("<IIIIQQIIIIQQQ")
assert _HEADER.size == 72


def get_bitsize(max_value: int) -> int:
    """src/glistmaker.c:116-125."""
    size = 1
    max_value >>= 1
    while max_value:
        size += 1
        max_value >>= 1
    return size


@dataclass
class IndexFile:
    name: bytes
    size: int
    # (n_subseqs, 4): name_pos, name_len, seq_pos, seq_len
    subseqs: np.ndarray


class IndexVersionError(ValueError):
    """Major version mismatch (gt4_index_map_new, src/index-map.c:330-334
    — the reference validates ONLY the magic and the major version; every
    other header field is consumed lazily and unvalidated)."""

    def __init__(self, version_major: int):
        self.version_major = version_major
        super().__init__(f"incompatible major version {version_major}")


def _parse_files_block(fblock: bytes) -> list:
    p = 0
    assert fblock[p:p + 4] == b"F4TG"
    p += 12
    (n_files,) = struct.unpack_from("<I", fblock, p)
    p += 4
    files = []
    for _ in range(n_files):
        size, n_ss = struct.unpack_from("<QQ", fblock, p)
        p += 16
        (nlen,) = struct.unpack_from("<H", fblock, p)
        p += 2
        name = fblock[p:p + nlen].split(b"\0")[0]
        p += nlen
        ss = np.zeros((n_ss, 4), np.int64)
        for j in range(n_ss):
            np_, nl = struct.unpack_from("<QI", fblock, p)
            sp, sl = struct.unpack_from("<QQ", fblock, p + 12)
            ss[j] = (np_, nl, sp, sl)
            p += 28
        files.append(IndexFile(name, size, ss))
    return files


class IndexMap:
    """Loaded .index. ``kmer_recs`` (when set) is the mmapped
    interleaved (word, loc_start) u64 blob; ``words``/``loc_start``
    deinterleave lazily on first access so blob-level consumers (the
    --locations dump) never pay the strided copies."""

    def __init__(self, word_length: int, n_file_bits: int,
                 n_subseq_bits: int, n_pos_bits: int, files: list,
                 words, loc_start, locations,
                 num_locations: int = 0, path: str = "",
                 kmer_recs=None, files_raw=None):
        self.word_length = word_length
        self.n_file_bits = n_file_bits
        self.n_subseq_bits = n_subseq_bits
        self.n_pos_bits = n_pos_bits
        self._files = files
        self._files_raw = files_raw
        self._words = words
        self._loc_start = loc_start
        self._locations = locations
        self._locations_src = None  # (data, locations_start) until read
        self.num_locations = num_locations
        self.path = path
        self.version_major = 4   # get_statistics prints the header's
        self.version_minor = 2   # actual fields (src/glistquery.c:425)
        self._kmer_recs = kmer_recs
        self._kmers_src = None      # (data, kmers_start, n_words)

    @property
    def kmer_recs(self):
        """Built lazily, bounds-clamped: a truncated file makes the
        reference read past its mmap (SIGBUS or adjacent-mapping
        garbage, address-space dependent — non-oracle UB); we return the
        in-bounds prefix zero-padded to the declared length so every
        command stays deterministic and crash-free (round-4
        fuzz_index_chrome finding)."""
        if self._kmer_recs is None:
            data, start, n_words = self._kmers_src
            want = n_words * 2
            avail = max(0, min(want, (len(data) - start) // 8))
            recs = np.frombuffer(data, np.uint64, avail, start)
            if avail < want:
                recs = np.concatenate(
                    [recs, np.zeros(want - avail, np.uint64)])
            self._kmer_recs = recs
        return self._kmer_recs

    @property
    def locations(self) -> np.ndarray:
        """Built lazily: the reference dereferences the locations
        pointer only on location-consuming commands, so a corrupt
        locations_start must not fail a plain dump (round-4
        fuzz_index_chrome finding)."""
        if self._locations is None:
            data, start = self._locations_src
            n = max(0, (len(data) - start) // 8)
            start = min(start, len(data))
            self._locations = np.frombuffer(data, np.uint64, n, start)
        return self._locations

    @property
    def files(self) -> list:
        """Parsed lazily: the reference touches the files block only for
        --files/--sequences (print_files/print_sequences), so a corrupt
        block must not fail commands that never read it (round-4
        fuzz_index_chrome finding)."""
        if self._files is None:
            self._files = _parse_files_block(bytes(self._files_raw))
        return self._files

    @property
    def words(self) -> np.ndarray:
        if self._words is None:
            self._words = self.kmer_recs[0::2].copy()
        return self._words

    @property
    def loc_start(self) -> np.ndarray:
        if self._loc_start is None:
            self._loc_start = self.kmer_recs[1::2].copy()
        return self._loc_start

    @property
    def counts(self) -> np.ndarray:
        """Per-word location counts from offset differences
        (src/index-map.c:128-139)."""
        if not len(self.words):
            return np.zeros(0, np.uint32)
        nxt = np.concatenate([self.loc_start[1:],
                              [np.uint64(self.num_locations)]])
        return (nxt - self.loc_start).astype(np.uint32)

    def word_locations(self, idx: int) -> np.ndarray:
        s = int(self.loc_start[idx])
        n = int(self.counts[idx])
        return self.locations[s:s + n]

    def decode_locations(self, codes: np.ndarray):
        pb, sb, fb = self.n_pos_bits, self.n_subseq_bits, self.n_file_bits
        c = codes.astype(np.uint64)
        dirs = c & np.uint64(1)
        pos = (c >> np.uint64(1)) & np.uint64((1 << pb) - 1)
        seq = (c >> np.uint64(pb + 1)) & np.uint64((1 << sb) - 1)
        fil = (c >> np.uint64(sb + pb + 1)) & np.uint64((1 << fb) - 1)
        return fil, seq, pos, dirs


def read_index_map(path: str | os.PathLike) -> IndexMap:
    # mmap, not read(): dump/query paths touch pages on demand, and the
    # k-mer/location blocks stay zero-copy views into the map
    data = np.memmap(path, np.uint8, mode="r")
    (code, vmaj, vmin, wlen, n_words, n_locs, fb, sb, pb, _fill,
     files_start, kmers_start, locations_start) = _HEADER.unpack_from(data, 0)
    if code != GT4_INDEX_CODE:
        raise ValueError(f"not a GT4 .index file (magic {code:#x})")
    if vmaj != 4:
        raise IndexVersionError(vmaj)
    if files_start + 16 > len(data):
        # header-only index (glistmaker with zero words writes just the
        # 72-byte header, src/glistmaker.c:343-346)
        im = IndexMap(wlen, fb, sb, pb, [], np.empty(0, np.uint64),
                      np.empty(0, np.uint64), np.empty(0, np.uint64),
                      num_locations=n_locs, path=os.fspath(path),
                      kmer_recs=np.empty(0, np.uint64))
        im.version_minor = vmin
        return im
    # files block kept as a raw view and parsed lazily (IndexMap.files):
    # the reference touches it only for --files/--sequences, so corrupt
    # bytes there must not fail commands that never read it (round-4
    # fuzz_index_chrome finding)
    fblock = data[files_start:kmers_start]
    im = IndexMap(wlen, fb, sb, pb, None, None, None, None,
                  num_locations=n_locs, path=os.fspath(path),
                  files_raw=fblock)
    im.version_minor = vmin
    im._kmers_src = (data, kmers_start, n_words)
    im._locations_src = (data, locations_start)
    return im


def _write_chunked(f, view, chunk: int = 1 << 20):
    """write(2) calls >= 12 MB stall in dirty-page throttling on this
    VM class (the same split ListWriter uses) — and a memoryview
    source skips the tobytes copy."""
    for i in range(0, len(view), chunk):
        f.write(view[i:i + chunk])


def write_index_file(path: str | os.PathLike, word_length: int,
                     files: list, words: np.ndarray, loc_start: np.ndarray,
                     num_locations: int, locations: np.ndarray,
                     n_file_bits: int, n_subseq_bits: int, n_pos_bits: int,
                     atomic: bool = True, kmer_recs: np.ndarray = None):
    """Write byte-identically to write_index (src/glistmaker.c:631-782).

    The k-mer block is (word, loc_start) u64 pairs; pass either the two
    columns (words, loc_start) or the pre-interleaved pair array
    ``kmer_recs`` (native producers emit it directly, skipping the
    interleave copies)."""
    n_kmers = (len(kmer_recs) // 2 if kmer_recs is not None
               else len(words))
    tmp = f"{os.fspath(path)}.tmp" if atomic else os.fspath(path)
    with open(tmp, "wb") as f:
        f.write(b"I4TG")
        f.write(struct.pack("<II", 4, 2))
        f.write(struct.pack("<I", word_length))
        f.write(struct.pack("<QQ", n_kmers, num_locations))
        f.write(struct.pack("<IIII", n_file_bits, n_subseq_bits,
                            n_pos_bits, 0))
        starts_at = f.tell()
        f.write(b"\0" * 24)
        files_start = f.tell()
        f.write(b"F4TG")
        f.write(struct.pack("<II", 4, 2))
        f.write(struct.pack("<I", len(files)))
        blen = 16
        subseq_dt = np.dtype([("np", "<u8"), ("nl", "<u4"),
                              ("sp", "<u8"), ("sl", "<u8")])
        assert subseq_dt.itemsize == 28
        for fi in files:
            name = fi.name if isinstance(fi.name, bytes) else fi.name.encode()
            f.write(struct.pack("<QQ", fi.size, len(fi.subseqs)))
            f.write(struct.pack("<H", len(name) + 1))
            f.write(name + b"\0")
            blen += 18 + len(name) + 1
            # vectorized: the per-record struct.pack loop cost seconds
            # on multi-million-read FASTQ registries
            ss = np.asarray(fi.subseqs)
            blob = np.empty(len(ss), subseq_dt)
            if len(ss):
                blob["np"] = ss[:, 0]
                blob["nl"] = ss[:, 1]
                blob["sp"] = ss[:, 2]
                blob["sl"] = ss[:, 3]
            _write_chunked(f, memoryview(blob).cast("B"))
            blen += 28 * len(fi.subseqs)
        if blen & 7:
            f.write(b"\0" * (8 - (blen & 7)))
        kmers_start = f.tell()
        if kmer_recs is None:
            kmer_recs = np.empty(len(words) * 2, np.uint64)
            kmer_recs[0::2] = words
            kmer_recs[1::2] = loc_start
        _write_chunked(f, memoryview(
            np.ascontiguousarray(kmer_recs)).cast("B"))
        locations_start = f.tell()
        _write_chunked(f, memoryview(
            np.ascontiguousarray(locations, np.uint64)).cast("B"))
        f.seek(starts_at)
        f.write(struct.pack("<QQQ", files_start, kmers_start,
                            locations_start))
    if atomic:
        os.replace(tmp, path)
