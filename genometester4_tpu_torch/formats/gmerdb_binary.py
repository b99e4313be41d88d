"""Binary GMDB database format: the reader (the port's copy of the read
path of ``genometester4_tpu/formats/gmerdb_binary.py``).

Layout (reference: src/database.h:79-107, writer src/database.c:285-395):

    0   "GMDB"  major u16(=0)  minor u16(=4)
    8   wordsize u32  node_bits u32  kmer_bits u32  count_bits u32
    24  n_nodes u64  n_kmers u64  names_size u64
    48  nodes_start u64  kmers_start u64  names_start u64
        trie_start u64  index_start u64
    ... 5 blocks, each ``u64 blocksize`` (16-byte-padded) + data:
        nodes (12-byte {name,kmers,nkmers} u32 triples), kmer counts
        (0-size when written by ``gmer_counter -w``), names blob,
        serialized trie, serialized read index.

Serialized trie (src/trie.c:177-203): ``nbits u32, nbits_root u32,
nbranches u64``, the 2^nbits_root root-ref table, then ``nbranches``
24-byte branch slots.  A ref is a u64: 0 = empty; odd = leaf packing
(nbits:5 @59, word:26 @33, code:32 @1, type:1 @0); even = branch whose
slot index is ``ref >> 2`` (src/trie.h:28-66).  A branch packs
(nbits_this:5, nbits_children:6, word:26) into its first u64 followed by
two child refs.

The reader never materializes the trie: a point lookup walks the
branch table from the root ref to its leaf.
"""

from __future__ import annotations

import struct

import numpy as np

from genometester4_tpu_torch.formats.gmerdb import GmerDB


def parse_binary_db(data) -> GmerDB | None:
    """Load a binary GMDB (src/database.c:397-525). Counts stored in the
    file (if any) are discarded. The (possibly multi-GB) trie stays a raw
    view of ``data`` and serves point lookups by walking it per query,
    like the reference's mmap'd trie; pass a np.memmap as ``data`` for
    lazy paging."""
    if bytes(data[:4]) != b"GMDB":
        return None
    major, minor = struct.unpack_from("<HH", data, 4)
    version = (major << 16) | minor
    wordsize, node_bits, kmer_bits, count_bits = struct.unpack_from(
        "<IIII", data, 8)
    if version == 0:
        count_bits = 16
    n_nodes, n_kmers, names_size = struct.unpack_from("<QQQ", data, 24)
    if version > 1:
        nodes_start, kmers_start, names_start, trie_start, index_start = (
            struct.unpack_from("<QQQQQ", data, 48))
    else:
        # sequential blocks right after the 48-byte header
        nodes_start = 48
        kmers_start = names_start = trie_start = index_start = None

    def block(start):
        (bs,) = struct.unpack_from("<Q", data, start)
        return start + 8, bs

    pos, bs = block(nodes_start)
    nodes = np.frombuffer(data, np.uint32, n_nodes * 3, pos).reshape(-1, 3)
    if kmers_start is None:
        kmers_start = pos + bs
    pos, bs = block(kmers_start)
    if names_start is None:
        names_start = pos + bs
    pos, bs = block(names_start)
    names_blob = bytes(data[pos:pos + names_size])
    if trie_start is None:
        trie_start = pos + bs
    pos, _bs = block(trie_start)
    trie_blob = np.frombuffer(data, np.uint8, len(data) - pos, pos)

    names = [names_blob[o:names_blob.index(b"\0", o)]
             for o in nodes[:, 0]]

    db = GmerDB(wordsize=wordsize, node_bits=node_bits, kmer_bits=kmer_bits,
                count_bits=count_bits, names=names,
                node_kmers_start=nodes[:, 1].astype(np.uint64),
                node_nkmers=nodes[:, 2].copy(), trie_blob=trie_blob)
    if index_start is not None and version >= 3:
        pos, bs = block(index_start)
        if bs:
            from genometester4_tpu_torch.formats.read_index import \
                parse_read_index
            idx = parse_read_index(data, pos, n_kmers, compat=version < 4)
            if idx.n_reads or idx.files:
                db.index = idx
    return db


def trie_lookup_one(blob: np.ndarray, word: int) -> int:
    """Point lookup in a serialized trie — the reference's trie_lookup
    walk (src/trie.c:85-90, 398-445), touching only the pages on the
    path. Returns the stored code or 0."""
    nbits, nbits_root = struct.unpack_from("<II", blob, 0)
    cbits = nbits - nbits_root
    nroots = 1 << nbits_root
    roots = np.frombuffer(blob, np.uint64, nroots, 16)
    branches_off = 16 + nroots * 8
    ref = int(roots[word >> cbits])
    w = word % (1 << cbits)
    nb = cbits
    while True:
        if ref == 0:
            return 0
        if ref & 1:
            kw = (ref >> 33) & 0x3FFFFFF
            return (ref >> 1) & 0xFFFFFFFF if kw == w else 0
        slot = ref >> 2
        rec = np.frombuffer(blob, np.uint64, 3, branches_off + slot * 24)
        bits0 = int(rec[0])
        nthis = bits0 & 0x1F
        nchild = (bits0 >> 5) & 0x3F
        bword = (bits0 >> 11) & 0x3FFFFFF
        if (w >> (nb - nthis)) != bword:
            return 0
        cw = (w >> (nb - nthis - nchild)) % (1 << nchild)
        w = w % (1 << (nb - nthis - nchild))
        nb = nb - nthis - nchild
        ref = int(rec[1 + cw])


def load_binary_db(path: str) -> GmerDB | None:
    return parse_binary_db(np.memmap(path, dtype=np.uint8, mode="r"))
