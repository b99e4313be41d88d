"""Binary GMDB database format: byte-compatible reader and writer (the
port's copy of ``genometester4_tpu/formats/gmerdb_binary.py``).

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

The writer must reproduce the reference's ALLOCATION ORDER, because refs
embed slot indices: slots are handed out sequentially starting at 1
(slot 0 is reserved for the empty ref), and ``nbranches`` grows in
65536-slot allocator grabs (src/trie.c:205-238) — so the serialized
branch table includes zeroed never-used tail slots.  We simulate the
insert algorithm (src/trie.c:266-396) slot-for-slot. The root table is 2
GiB at the default 28 root bits and almost all zero: the writer writes
only its pages that hold a ref and seeks over the rest, so the file reads
back byte for byte the same with the zero pages left as holes.

The read path never materializes a pointer trie: a vectorized
breadth-first walk over the branch table reconstructs the flat
(canonical word, code) pairs, which is all the sorted-array lookup
needs; a lazy load keeps the trie as a view and walks it per point
lookup (``trie_lookup_one``).
"""

from __future__ import annotations

import struct

import numpy as np

from genometester4_tpu_torch.formats.gmerdb import GmerDB
# GMDB blobs run to gigabytes: no transparent huge pages (utils.backend)
from genometester4_tpu_torch.utils.backend import disable_numpy_thp as _thp

_thp()

_ALLOC_BLOCK = 65536  # src/trie.c:18
_TRIE_BLOCK_BITS = 30
_KMER_MAX_BITS = 26
_ROOT_PAGE = 1 << 13  # root refs per written page (64 KiB)

_M26 = np.uint64((1 << 26) - 1)
_M32 = np.uint64(0xFFFFFFFF)


def _pad16(n: int) -> int:
    return (n + 15) & ~15


# ---------------------------------------------------------------------------
# Trie simulation (write path)
# ---------------------------------------------------------------------------

class _TrieSim:
    """Replays the reference trie's insert + allocator behavior.

    Branch slots live in three parallel python lists (bits0/child0/child1
    as ints); list index == global slot index (block*2^30 + idx, always
    < 2^30 in practice here).
    """

    def __init__(self, nbits: int, nbits_root: int = 28):
        self.nbits = nbits
        self.nbits_root = min(nbits_root, nbits)
        self.roots = {}  # sparse: root index -> ref
        self.bits0: list[int] = []
        self.child: list[list[int]] = []
        self.nbranches = 0  # includes allocator padding
        self._next = 0

    # -- allocator (src/trie.c:205-238) ------------------------------------
    def _alloc_branch(self) -> int:
        if (self._next & (_ALLOC_BLOCK - 1)) == 0:
            idx = self.nbranches % (1 << _TRIE_BLOCK_BITS)
            idx = ((idx + _ALLOC_BLOCK - 1) // _ALLOC_BLOCK) * _ALLOC_BLOCK
            self._next = idx
            if idx == 0:
                self._next = 1  # slot 0 reserved for the empty ref
            self.nbranches += _ALLOC_BLOCK
        slot = self._next
        self._next += 1
        while len(self.bits0) <= slot:
            self.bits0.append(0)
            self.child.append([0, 0])
        self.bits0[slot] = 0
        self.child[slot] = [0, 0]
        return slot

    @staticmethod
    def _make_kmer(nbits: int, word: int, code: int) -> int:
        return (nbits << 59) | (word << 33) | ((code & 0xFFFFFFFF) << 1) | 1

    def _new_branch(self, word: int, nbits_this: int, nbits_children: int) -> int:
        slot = self._alloc_branch()
        self.bits0[slot] = (nbits_this & 0x1F) | ((nbits_children & 0x3F) << 5) \
            | ((word & ((1 << 26) - 1)) << 11)
        return slot << 2  # branch ref

    def _branch_fields(self, ref: int):
        b = self.bits0[ref >> 2]
        return b & 0x1F, (b >> 5) & 0x3F, (b >> 11) & ((1 << 26) - 1)

    # -- insert (src/trie.c:266-396) ----------------------------------------
    def add_word(self, word: int, code: int) -> bool:
        cbits = self.nbits - self.nbits_root
        root = word >> cbits
        ref = self._add(self.roots.get(root, 0), word % (1 << cbits), cbits, code)
        if ref == 0:
            return False
        self.roots[root] = ref
        return True

    def _add(self, ref: int, word: int, nbits: int, code: int) -> int:
        if ref == 0:
            if nbits <= _KMER_MAX_BITS:
                return self._make_kmer(nbits, word, code)
            nrem = nbits - _KMER_MAX_BITS - 1
            if nrem > 52:
                nrem = 52
            branch = self._new_branch(word >> (nbits - nrem), nrem, 1)
            return self._branch_add(branch, word, nbits, code)
        if ref & 1:
            return self._kmer_add(ref, word, nbits, code)
        return self._branch_add(ref, word, nbits, code)

    def _kmer_add(self, ref: int, word: int, nbits: int, code: int) -> int:
        kword = (ref >> 33) & ((1 << 26) - 1)
        knbits = (ref >> 59) & 0x1F
        kcode = (ref >> 1) & 0xFFFFFFFF
        if kword == word:
            # duplicate: codes SUM like trie counts (src/trie.c:272-282)
            return self._make_kmer(knbits, kword, kcode + code)
        bit = (kword ^ word).bit_length() - 1
        old_idx = (kword >> bit) & 1
        new_ref = self._new_branch(word >> (bit + 1), knbits - bit - 1, 1)
        old_kmer = self._make_kmer(bit, kword % (1 << bit), kcode)
        self.child[new_ref >> 2][old_idx] = old_kmer
        return self._add(new_ref, word, nbits, code)

    def _branch_add(self, ref: int, word: int, nbits: int, code: int) -> int:
        nthis, nchild, bword = self._branch_fields(ref)
        lword = word >> (nbits - nthis)
        if bword == lword:
            cword = (word >> (nbits - nthis - nchild)) % (1 << nchild)
            dword = word % (1 << (nbits - nthis - nchild))
            slot = ref >> 2
            self.child[slot][cword] = self._add(
                self.child[slot][cword], dword, nbits - nthis - nchild, code)
            return ref
        bit = (bword ^ lword).bit_length() - 1
        # split (src/trie.c:316-342)
        old_idx = (bword >> bit) & 1
        new_ref = self._new_branch(bword >> (bit + 1), nthis - bit - 1, 1)
        slot = ref >> 2
        self.bits0[slot] = (bit & 0x1F) | ((nchild & 0x3F) << 5) \
            | ((bword % (1 << bit)) << 11)
        self.child[new_ref >> 2][old_idx] = ref
        return self._branch_add(new_ref, word, nbits, code)

    # -- serialization (src/trie.c:177-203) ---------------------------------
    def serialize_parts(self):
        """Zero-copy serialization: (header, root pages, branches, total
        bytes). The root table (2^nbits_root u64 refs, 2 GiB at the
        default 28 bits) comes as (offset, array) pages holding its
        nonzero refs; every other byte of it is zero."""
        hdr = struct.pack("<IIQ", self.nbits, self.nbits_root,
                          self.nbranches)
        keys = np.fromiter(self.roots.keys(), np.int64, len(self.roots))
        refs = np.fromiter(self.roots.values(), np.uint64, len(self.roots))
        page_of = keys // _ROOT_PAGE
        pages = []
        for p in np.unique(page_of):
            page = np.zeros(min(_ROOT_PAGE, (1 << self.nbits_root)
                                - int(p) * _ROOT_PAGE), np.uint64)
            sel = page_of == p
            page[keys[sel] - p * _ROOT_PAGE] = refs[sel]
            pages.append((int(p) * _ROOT_PAGE * 8, page))
        branches = np.zeros((self.nbranches, 3), np.uint64)
        n = min(len(self.bits0), self.nbranches)
        if n:
            branches[:n, 0] = np.asarray(self.bits0[:n], np.uint64)
            ch = np.asarray(self.child[:n], np.uint64)
            branches[:n, 1] = ch[:, 0]
            branches[:n, 2] = ch[:, 1]
        total = len(hdr) + (8 << self.nbits_root) + branches.nbytes
        return hdr, pages, branches, total


def build_trie_sim(db: GmerDB) -> "_TrieSim":
    """Build the trie for ``db`` exactly as the reference's text-DB load
    does (src/database.c:155,203-243): insert canonical words node by
    node, single allocator."""
    sim = _TrieSim(db.wordsize * 2, 28)
    starts = db.node_kmers_start.astype(np.int64)
    nks = db.node_nkmers.astype(np.int64)
    words = db.kmer_words
    dirs = db.kmer_dirs
    kb = db.kmer_bits
    for node in range(db.n_nodes):
        for i in range(int(nks[node])):
            s = int(starts[node]) + i
            code = ((0x80000000 if dirs[s] else 0)
                    | ((node + 1) << kb) | i) & 0xFFFFFFFF
            sim.add_word(int(words[s]), code)
    return sim


# ---------------------------------------------------------------------------
# Trie walk (read path) — vectorized BFS
# ---------------------------------------------------------------------------

def _walk_trie(blob: np.ndarray):
    """Extract (words u64, codes u32) from a serialized trie blob."""
    nbits, nbits_root = struct.unpack_from("<II", blob, 0)
    (nbranches,) = struct.unpack_from("<Q", blob, 8)
    p = 16
    nroots = 1 << nbits_root
    roots = np.frombuffer(blob, np.uint64, nroots, p)
    p += nroots * 8
    branches = np.frombuffer(blob, np.uint64, nbranches * 3, p).reshape(-1, 3)

    cbits = nbits - nbits_root
    live = np.flatnonzero(roots != 0)
    refs = roots[live]
    prefixes = live.astype(np.uint64)
    rembits = np.full(len(refs), cbits, np.int64)

    words_out, codes_out = [], []
    while len(refs):
        is_kmer = (refs & np.uint64(1)) != 0
        if is_kmer.any():
            kr = refs[is_kmer]
            kw = (kr >> np.uint64(33)) & _M26
            kp = prefixes[is_kmer]
            kb = rembits[is_kmer].astype(np.uint64)
            words_out.append((kp << kb) | kw)
            codes_out.append(((kr >> np.uint64(1)) & _M32).astype(np.uint32))
        br = refs[~is_kmer]
        if not len(br):
            break
        bp = prefixes[~is_kmer]
        bb = rembits[~is_kmer]
        slot = (br >> np.uint64(2)).astype(np.int64)
        bits0 = branches[slot, 0]
        nthis = (bits0 & np.uint64(0x1F)).astype(np.int64)
        nchild = ((bits0 >> np.uint64(5)) & np.uint64(0x3F)).astype(np.int64)
        bword = (bits0 >> np.uint64(11)) & np.uint64((1 << 26) - 1)
        base = (bp << nthis.astype(np.uint64)) | bword
        childbits = bb - nthis - nchild
        c0 = branches[slot, 1]
        c1 = branches[slot, 2]
        nrefs = np.concatenate([c0, c1])
        nprefix = np.concatenate([base << np.uint64(1),
                                  (base << np.uint64(1)) | np.uint64(1)])
        nbitsr = np.concatenate([childbits, childbits])
        keep = nrefs != 0
        refs, prefixes, rembits = nrefs[keep], nprefix[keep], nbitsr[keep]

    if words_out:
        return np.concatenate(words_out), np.concatenate(codes_out)
    return np.empty(0, np.uint64), np.empty(0, np.uint32)


# ---------------------------------------------------------------------------
# GMDB file assembly / parse
# ---------------------------------------------------------------------------

def write_binary_db(db: GmerDB, f, write_counts: bool = False,
                    counts: np.ndarray | None = None,
                    index_blob: bytes | None = None,
                    index_physical: int | None = None,
                    index_blocksize: int | None = None) -> int:
    """Serialize ``db`` byte-identically to write_db_to_file
    (src/database.c:285-395)."""
    names_blob = b"".join(n + b"\0" for n in db.names)
    name_offsets = np.zeros(db.n_nodes, np.uint32)
    off = 0
    for i, n in enumerate(db.names):
        name_offsets[i] = off
        off += len(n) + 1

    nodes = np.zeros((db.n_nodes, 3), np.uint32)
    nodes[:, 0] = name_offsets
    nodes[:, 1] = db.node_kmers_start.astype(np.uint32)
    nodes[:, 2] = db.node_nkmers

    hdr, root_pages, branches, trie_len = build_trie_sim(db).serialize_parts()
    if index_blob is None:
        index_blob, index_physical, _bbs = _empty_index_blob()
    elif index_physical is None:
        index_physical = len(index_blob)
    if index_blocksize is None:
        index_blocksize = _pad16(len(index_blob))

    f.write(b"GMDB")
    f.write(struct.pack("<HH", 0, 4))
    f.write(struct.pack("<IIII", db.wordsize, db.node_bits, db.kmer_bits,
                        db.count_bits))
    f.write(struct.pack("<QQQ", db.n_nodes, db.n_kmers, len(names_blob)))
    written = 48 + 40  # header + start table (filled at the end)
    f.seek(written)

    starts = []

    def block(data: bytes, blocksize: int | None = None):
        nonlocal written
        starts.append(written)
        bs = _pad16(len(data)) if blocksize is None else blocksize
        f.write(struct.pack("<Q", bs))
        f.write(data)
        written += 8 + bs
        f.seek(written)

    block(nodes.tobytes())
    if write_counts and counts is not None:
        dt = np.uint16 if db.count_bits == 16 else np.uint32
        block(counts.astype(dt).tobytes())
    else:
        block(b"", blocksize=0)
    block(names_blob)
    # the trie block through memoryviews: only the root table's pages that
    # hold a ref are written, the seeks between them leave zeros
    starts.append(written)
    f.write(struct.pack("<Q", _pad16(trie_len)))
    f.write(hdr)
    roots_at = written + 8 + len(hdr)
    for page_off, page in root_pages:
        f.seek(roots_at + page_off)
        f.write(memoryview(page))
    f.seek(roots_at + trie_len - len(hdr) - branches.nbytes)
    if branches.nbytes:
        f.write(memoryview(branches))
    written += 8 + _pad16(trie_len)
    f.seek(written)
    # final block: the reference never materializes the trailing
    # alignment pad (it is a seek hole at EOF), so write only the
    # physical bytes while recording the (possibly buggy) blocksize
    starts.append(written)
    f.write(struct.pack("<Q", index_blocksize))
    f.write(index_blob[:index_physical])
    end = written + 8 + index_physical

    f.seek(48)
    f.write(struct.pack("<QQQQQ", *starts))
    f.seek(end)
    try:
        f.truncate()
    except OSError:
        pass  # non-regular sink (e.g. /dev/null)
    return written + 8 + _pad16(len(index_blob))


def _empty_index_blob() -> tuple[bytes, int, int]:
    """The empty read index gt4_index_write produces for a DB with no
    index (src/index.c:101-166 with an all-zero GT4Index): 80 padded
    bytes, 72 physical."""
    from genometester4_tpu_torch.formats.read_index import pack_read_index
    return pack_read_index(0, 0, 0, [], np.empty(0, np.uint64),
                           np.empty(0, np.uint64))


def parse_binary_db(data, lazy: bool = False) -> GmerDB | None:
    """Load a binary GMDB (src/database.c:397-525). Counts stored in the
    file (if any) are discarded — counting starts at zero, matching
    gmer_counter -dbb semantics.

    ``lazy=True`` keeps the (possibly multi-GB) trie as a raw view and
    serves point lookups by walking it per query, like the reference's
    mmap'd trie — consumers that need the full sorted table call
    ``db.ensure_lookup()``.  Pass a np.memmap as ``data`` for lazy
    paging."""
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
    if not lazy:
        db.ensure_lookup()
    if index_start is not None and version >= 3:
        pos, bs = block(index_start)
        if bs:
            from genometester4_tpu_torch.formats.read_index import \
                parse_read_index
            idx = parse_read_index(data, pos, n_kmers, compat=version < 4)
            if idx.n_reads or idx.files:
                db.index = idx
    return db


def ensure_lookup_from_trie(db: GmerDB):
    """Walk the serialized trie once to materialize the sorted lookup
    table and the flat kmer table (DB order)."""
    words, codes = _walk_trie(db.trie_blob)
    kmer_bits = db.kmer_bits
    n_nodes = db.n_nodes
    n_kmers = int(db.node_nkmers.astype(np.int64).sum())
    node_idx = ((codes & np.uint32(0x7FFFFFFF)) >> np.uint32(kmer_bits)
                ).astype(np.int64) - 1
    kmer_idx = (codes & np.uint32((1 << kmer_bits) - 1)).astype(np.int64)
    dirs_arr = (codes & np.uint32(0x80000000)) != 0
    starts = db.node_kmers_start.astype(np.int64)
    ok = (node_idx >= 0) & (node_idx < n_nodes)
    kmer_words = np.zeros(n_kmers, np.uint64)
    kmer_dirs = np.zeros(n_kmers, bool)
    slots = starts[node_idx[ok]] + kmer_idx[ok]
    kmer_words[slots] = words[ok]
    kmer_dirs[slots] = dirs_arr[ok]
    db.kmer_words = kmer_words
    db.kmer_dirs = kmer_dirs
    # lookup table straight from the trie pairs (duplicate codes were
    # already summed inside the trie)
    order = np.argsort(words, kind="stable")
    db.sorted_words = words[order]
    db.sorted_codes = codes[order]


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


def load_binary_db(path: str, lazy: bool = False) -> GmerDB | None:
    return parse_binary_db(np.memmap(path, dtype=np.uint8, mode="r"),
                           lazy=lazy)
