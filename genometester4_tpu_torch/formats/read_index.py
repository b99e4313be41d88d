"""KATK read index — per-DB-k-mer lists of read locations: the reader and
the writer (the port's copy of ``genometester4_tpu/formats/read_index.py``).

Layout (reference: src/index.h:34-49, reader src/index.c:40-89):

    0  code u32 ('GT4I')  major u32  minor u32  filler u32   (v>=0.4 only)
    16 nbits_file u32  nbits_npos u32  nbits_kmer u32
    28 n_files u32  n_kmers u64  n_reads u64
    48 files_start u64  blocks_start u64  reads_start u64
       NUL-terminated file names, read_blocks u64[n_kmers],
       reads u64[n_reads]

``read_blocks[kmer]`` is the first read offset (v0.4; older versions
pack start:40|count:24, src/index.c:9-25).  Each read packs
``dir:1 | file:nbits_file | name_pos:nbits_npos | kmer_pos:nbits_kmer``
(src/index.c:27-36, writer src/gmer_counter.c:504-507).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np


@dataclass
class ReadIndex:
    nbits_file: int
    nbits_npos: int
    nbits_kmer: int
    files: list  # list[bytes]
    read_blocks: np.ndarray  # u64[n_kmers]
    reads: np.ndarray  # u64[n_reads]
    version: tuple = (0, 4)

    @property
    def n_reads(self) -> int:
        return len(self.reads)

    def kmer_reads(self, kmer: int) -> np.ndarray:
        """Read codes for one DB k-mer slot (src/index.c:9-25)."""
        if self.version < (0, 4):
            start = int(self.read_blocks[kmer]) >> 24
            n = int(self.read_blocks[kmer]) & 0xFFFFFF
        else:
            start = int(self.read_blocks[kmer])
            if kmer >= len(self.read_blocks) - 1:
                n = self.n_reads - start
            else:
                n = int(self.read_blocks[kmer + 1]) - start
        return self.reads[start:start + n]

    def decode_reads(self, codes: np.ndarray):
        """(kmer_pos, name_pos, file_idx, dir) from packed read codes."""
        c = codes.astype(np.uint64)
        kmer_pos = c & np.uint64((1 << self.nbits_kmer) - 1)
        name_pos = (c >> np.uint64(self.nbits_kmer)) & np.uint64(
            (1 << self.nbits_npos) - 1)
        file_idx = (c >> np.uint64(self.nbits_npos + self.nbits_kmer)
                    ) & np.uint64((1 << self.nbits_file) - 1)
        dirs = (c >> np.uint64(self.nbits_file + self.nbits_npos
                               + self.nbits_kmer)) & np.uint64(1)
        return kmer_pos, name_pos, file_idx, dirs


def parse_read_index(data: bytes, start: int, n_kmers: int,
                     compat: bool = False) -> ReadIndex:
    pos = start
    version = (0, 3)
    if not compat:
        _code, major, minor, _fill = struct.unpack_from("<IIII", data, pos)
        version = (major, minor)
        pos += 16
    nbits_file, nbits_npos, nbits_kmer = struct.unpack_from("<III", data, pos)
    pos += 12
    n_files, nk, n_reads = struct.unpack_from("<IQQ", data, pos)
    pos += 20
    files_start, blocks_start, reads_start = struct.unpack_from("<QQQ", data,
                                                                pos)
    files = []
    p = start + files_start
    for _ in range(n_files):
        # data may be a memmap: search within a bounded bytes window
        window = bytes(data[p:p + 65536])
        ln = window.index(b"\0")
        files.append(window[:ln])
        p += ln + 1
    nblocks = nk or n_kmers
    if nblocks and start + blocks_start + nblocks * 8 <= len(data):
        read_blocks = np.frombuffer(data, np.uint64, nblocks,
                                    start + blocks_start)
    else:
        read_blocks = np.zeros(nblocks, np.uint64)
    if n_reads and start + reads_start + n_reads * 8 <= len(data):
        reads = np.frombuffer(data, np.uint64, n_reads, start + reads_start)
    else:
        reads = np.zeros(n_reads, np.uint64)
    return ReadIndex(nbits_file, nbits_npos, nbits_kmer, files,
                     read_blocks, reads, version)


def pack_read_index(nbits_file: int, nbits_npos: int, nbits_kmer: int,
                    files: list, read_blocks: np.ndarray,
                    reads: np.ndarray) -> tuple[bytes, int, int]:
    """Serialize byte-identically to gt4_index_write_with_reads_callback
    (src/index.c:101-166).

    Returns ``(blob, physical_len, buggy_blocksize)``:

    * the reference's trailing alignment pad is a seek hole never
      materialized on disk when the index is the file's last block, so
      ``physical_len`` ends at the last actual write;
    * ``buggy_blocksize`` is what gmer_counter --compile_index records
      as the index blocksize: its write_reads callback returns the READ
      COUNT where bytes are expected (src/gmer_counter.c:482-521 vs
      src/index.c:155), so the stored blocksize is
      pad16(reads_start + n_reads) instead of the real size.
    """
    out = bytearray()
    out += struct.pack("<I", (ord("G") << 24) | (ord("T") << 16)
                       | (ord("4") << 8) | ord("I"))
    out += struct.pack("<III", 0, 4, 0)
    out += struct.pack("<III", nbits_file, nbits_npos, nbits_kmer)
    out += struct.pack("<IQQ", len(files), len(read_blocks), len(reads))
    starts_at = len(out)
    out += b"\0" * 24
    files_start = len(out)
    for fn in files:
        out += fn + b"\0"
    physical = len(out)
    while len(out) & 15:
        out += b"\0"
    blocks_start = len(out)
    if len(read_blocks):
        out += np.ascontiguousarray(read_blocks, np.uint64).tobytes()
        physical = len(out)
    while len(out) & 15:
        out += b"\0"
    reads_start = len(out)
    if len(reads):
        out += np.ascontiguousarray(reads, np.uint64).tobytes()
        physical = len(out)
    while len(out) & 15:
        out += b"\0"
    struct.pack_into("<QQQ", out, starts_at, files_start, blocks_start,
                     reads_start)
    buggy_blocksize = (reads_start + len(reads) + 15) & ~15
    return bytes(out), max(physical, starts_at + 24), buggy_blocksize
