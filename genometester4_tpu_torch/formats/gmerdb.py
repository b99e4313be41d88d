"""FastGT SNV k-mer database (GmerDB): the text parser and the in-memory
tables (the port's copy of ``genometester4_tpu/formats/gmerdb.py``).

The reference stores the database as per-marker lines

    NAME  N_KMERS  KMER1  KMER2 ...

parsed into a node table, a flat count table, a name blob and a pointer
trie mapping canonical k-mer -> 32-bit code (reference:
src/database.c:94-260, src/database.h:13-46). The code packs
``dir | (node+1) << kmer_bits | kmer`` (src/database.c:217-218).

The trie is replaced by a **sorted canonical k-mer array + parallel code
array** (``sorted_words``/``sorted_codes``): gmer_counter's DB lookup is a
batched binary search on the device (``ops.lookup``). A binary database
loaded lazily (``formats.gmerdb_binary.load_binary_db(lazy=True)``, what
gassembler does) keeps its serialized trie as it is in the file
(``trie_blob``) and walks it per point lookup, like the reference's mmap'd
trie; ``ensure_lookup`` materializes the sorted table from it only when a
caller needs the whole table.

Bit-exact parity notes (verified against the reference sources):

* wordsize is the length of the 3rd whitespace token of the first
  non-comment line (src/database.c:57-60);
* a k-mer token is consumed as: skip bytes < 0x20, take exactly
  ``wordsize`` raw bytes, then skip bytes >= 0x20 — so only TAB-separated
  k-mer columns parse cleanly and over-long tokens contribute their
  prefix (src/database.c:208-243);
* invalid characters inside a k-mer warn on stderr but still contribute
  their bit-trick value (src/sequence.c:118-130);
* adding the same canonical k-mer twice SUMS the stored codes (u32 wrap)
  because the reference trie treats the code as a count
  (src/trie.c:266-282) — duplicates therefore yield garbage codes, which
  we reproduce;
* per-node k-mer counts are clipped to ``--max_kmers``
  (src/database.c:196-199); lines with fewer k-mers than declared abort
  that node and stop it being counted (src/database.c:245-249).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np

from genometester4_tpu_torch.ops.encode import (NUCL_CODES,
                                                reverse_complement_u64)

# byte -> 2-bit value used by string_to_word for ANY byte: valid bases map
# via NUCL_CODES, everything else gets the reference's bit-trick garbage
# value ((ch & 4) ? ((ch >> 4) | 2) & 3 : (ch & 6) >> 1, src/sequence.c:45-53)
_ALL_BYTE_CODES = np.empty(256, np.uint8)
for _ch in range(256):
    if _ch & 4:
        _ALL_BYTE_CODES[_ch] = ((_ch >> 4) | 2) & 3
    else:
        _ALL_BYTE_CODES[_ch] = (_ch & 6) >> 1
_VALID = NUCL_CODES != 255
_ALL_BYTE_CODES[_VALID] = NUCL_CODES[_VALID]


def _get_bits(value: int) -> int:
    """src/database.c:86-93."""
    bits = 0
    while value > 0:
        bits += 1
        value //= 2
    return bits


@dataclass
class GmerDB:
    """A FastGT database: per-node names and k-mer slots, the lookup tables
    (canonical k-mer -> code), and the KATK read index."""

    wordsize: int
    node_bits: int
    kmer_bits: int
    count_bits: int
    # per node
    names: list  # list[bytes]
    node_kmers_start: np.ndarray  # u64[n_nodes] offset into flat kmer table
    node_nkmers: np.ndarray  # u32[n_nodes]
    # per flat kmer slot (DB order); None until a lazy DB's lookup is built
    kmer_words: np.ndarray | None = None  # u64[n_kmers] canonical
    kmer_dirs: np.ndarray | None = None  # bool[n_kmers] True if revcomp taken
    # lookup tables: unique canonical words sorted ascending + summed codes
    sorted_words: np.ndarray | None = None  # u64[n_unique]
    sorted_codes: np.ndarray | None = None  # u32[n_unique]
    # read index (KATK), populated by gmer_counter --compile_index or
    # loaded from a binary GMDB
    index: "object | None" = None
    # a lazily loaded binary DB's serialized trie (src/trie.c:177-203)
    trie_blob: "np.ndarray | None" = field(default=None, repr=False)

    @property
    def n_nodes(self) -> int:
        return len(self.names)

    @property
    def n_kmers(self) -> int:
        return len(self.kmer_words)

    def finalize_lookup(self):
        """Build the sorted-array dictionary (replaces the trie).

        Codes of duplicate canonical words are SUMMED with u32 wrap to
        match trie_node_kmer_add_word (src/trie.c:266-282).
        """
        n = self.n_kmers
        nodes = np.repeat(
            np.arange(self.n_nodes, dtype=np.uint32),
            self.node_nkmers.astype(np.int64))
        within = (np.arange(n, dtype=np.uint64)
                  - np.repeat(self.node_kmers_start,
                              self.node_nkmers.astype(np.int64)))
        codes = (np.where(self.kmer_dirs, np.uint32(0x80000000), np.uint32(0))
                 | ((nodes + np.uint32(1)) << np.uint32(self.kmer_bits))
                 | within.astype(np.uint32))
        order = np.argsort(self.kmer_words, kind="stable")
        sw = self.kmer_words[order]
        sc = codes[order]
        head = np.concatenate([[True], sw[1:] != sw[:-1]])
        # summed codes per unique word (u32 wrap)
        seg = np.cumsum(head) - 1
        summed = np.zeros(int(head.sum()), np.uint64)
        np.add.at(summed, seg, sc.astype(np.uint64))
        self.sorted_words = sw[head]
        self.sorted_codes = (summed & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    def ensure_lookup(self):
        """Materialize the sorted lookup table (walks the lazy trie once
        if the DB came from a binary file loaded lazily)."""
        if self.sorted_words is not None:
            return
        if self.trie_blob is not None:
            from genometester4_tpu_torch.formats.gmerdb_binary import \
                ensure_lookup_from_trie
            ensure_lookup_from_trie(self)
        else:
            self.finalize_lookup()

    def lookup_code(self, word: int) -> int:
        """Point lookup of one canonical word -> stored code (0 if
        absent). Lazy binary DBs walk the serialized trie like the
        reference's trie_lookup — only the path's pages are touched."""
        if self.sorted_words is not None:
            idx = int(np.searchsorted(self.sorted_words, np.uint64(word)))
            if (idx < len(self.sorted_words)
                    and self.sorted_words[idx] == np.uint64(word)):
                return int(self.sorted_codes[idx])
            return 0
        from genometester4_tpu_torch.formats.gmerdb_binary import \
            trie_lookup_one
        return trie_lookup_one(self.trie_blob, word)

    def decode(self, codes: np.ndarray):
        """code -> (node i64, kmer i64, valid bool) vectorized
        (src/gmer_counter.c:779-795)."""
        c = codes.astype(np.uint32) & np.uint32(0x7FFFFFFF)
        node = (c >> np.uint32(self.kmer_bits)).astype(np.int64) - 1
        kmer = (c & np.uint32((1 << self.kmer_bits) - 1)).astype(np.int64)
        ok_node = (node >= 0) & (node < self.n_nodes)
        nk = np.zeros(len(c), np.int64)
        nk[ok_node] = self.node_nkmers[node[ok_node]]
        ok = ok_node & (kmer < nk)
        return node, kmer, ok

    def flat_slot(self, node: np.ndarray, kmer: np.ndarray) -> np.ndarray:
        return self.node_kmers_start[node].astype(np.int64) + kmer


def _parse_text_db_fast(data: bytes, max_kmers_per_node: int,
                        count_bits: int) -> "GmerDB | None":
    """Native fast path for strictly clean databases (the common shape:
    NAME\\tCOUNT\\tKMER... lines, single tabs, exact-wordsize ACGTU
    tokens). Returns None on ANY deviation — the bug-compatible Python
    walk below then handles the file exactly like src/database.c:94-260,
    quirks included."""
    import ctypes
    import subprocess

    from genometester4_tpu_torch.utils.native import get_lib
    try:
        lib = get_lib()
    except (OSError, subprocess.SubprocessError):   # no cc: the slow path
        return None
    n = len(data)
    if n < 256:
        return None
    buf = np.frombuffer(data, np.uint8)
    cap_lines = data.count(b"\n") + 2
    cap_words = n // 2 + 1
    name_off = np.empty(cap_lines, np.int64)
    name_len = np.empty(cap_lines, np.int64)
    nkm = np.empty(cap_lines, np.int64)
    words = np.empty(cap_words, np.uint64)
    nw = ctypes.c_long(0)
    ws = ctypes.c_int(0)
    n_lines = lib.fgx_parse_text_db(buf, n, max_kmers_per_node, name_off,
                                    name_len, nkm, words,
                                    ctypes.byref(nw), ctypes.byref(ws))
    if n_lines < 0:
        return None
    wordsize = ws.value
    node_bits = _get_bits(n_lines + 1)
    kmer_bits = _get_bits(int(nkm[:n_lines].max()))
    if node_bits + kmer_bits > 31:
        return None        # slow path reproduces the error chrome
    names = [bytes(data[int(o):int(o) + int(ln)])
             for o, ln in zip(name_off[:n_lines], name_len[:n_lines])]
    nkmers = nkm[:n_lines].astype(np.uint32)
    starts = np.zeros(n_lines, np.uint64)
    if n_lines:
        starts[1:] = np.cumsum(nkmers.astype(np.uint64))[:-1]
    w = words[: nw.value]
    rc = reverse_complement_u64(w, wordsize)
    dirs = rc < w
    cwords = np.minimum(w, rc)
    db = GmerDB(wordsize=wordsize, node_bits=node_bits,
                kmer_bits=kmer_bits, count_bits=count_bits, names=names,
                node_kmers_start=starts, node_nkmers=nkmers,
                kmer_words=cwords, kmer_dirs=dirs)
    db.finalize_lookup()
    return db


def parse_text_db(data: bytes, max_kmers_per_node: int = 1000000000,
                  count_bits: int = 16) -> GmerDB | None:
    """Parse a text SNV database byte-for-byte like
    gt4_gmer_db_new_from_text (src/database.c:94-260).

    Returns None when the reference would fail to load the file.
    """
    fast = _parse_text_db_fast(data, max_kmers_per_node, count_bits)
    if fast is not None:
        return fast
    if len(data) < 8:
        return None
    if data[5] == 0 or data[7] == 0:
        return None
    buf = np.frombuffer(data, np.uint8)
    csize = len(data)

    # --- pass 1: count lines, establish wordsize/max_kmers (database.c:21-83)
    # Bug-compat: the reference's end-of-line walk is
    # `while ((cdata[cpos] < csize) && (cdata[cpos] != '\n'))` — it
    # compares the BYTE VALUE against the file size, so files smaller
    # than ~'~' bytes stop mid-line at any byte >= csize, splitting real
    # lines into pseudo-lines (usually making the load fail). Large
    # files are unaffected (bytes are < 256 <= csize).
    pos = 0
    wordsize = 0
    max_kmers = 0
    ok = True
    nl_positions = np.flatnonzero(buf == 0x0A)
    if csize < 256:
        stop_positions = np.flatnonzero((buf == 0x0A) | (buf >= csize))
    else:
        stop_positions = nl_positions

    def next_of(positions, p):
        i = int(np.searchsorted(positions, p))
        return int(positions[i]) if i < len(positions) else csize

    n_lines = 0
    while pos < csize:
        if data[pos] == ord("#"):
            pos = next_of(nl_positions, pos) + 1
            continue
        end = next_of(nl_positions, pos)  # split_line scans to real '\n'
        toks = _split_line(data, pos, end, 3)
        if len(toks) < 2:
            sys.stderr.write(f"Line {n_lines} has <2 ({len(toks)}) tokens\n")
            n_lines = 0
            ok = False
            break
        if not wordsize:
            if len(toks) > 2:
                wordsize = toks[2][1] - toks[2][0]
        nk = _strtol(data, toks[1][0], toks[1][1])
        if nk > max_kmers:
            max_kmers = nk
        n_lines += 1
        pos = next_of(stop_positions, pos)
        if pos < csize:
            pos += 1
    if not ok or n_lines == 0:
        sys.stderr.write("File is not text-format kmer database (maybe binary?)\n")
        return None
    # pass 2 walks REAL lines (database.c:164-266 uses a correct
    # end-of-line loop)
    lines = []
    pos = 0
    while pos < csize:
        if data[pos] == ord("#"):
            pos = next_of(nl_positions, pos) + 1
            continue
        end = next_of(nl_positions, pos)
        lines.append((pos, end))
        pos = end + 1
    if max_kmers > max_kmers_per_node:
        max_kmers = max_kmers_per_node
    node_bits = _get_bits(n_lines + 1)
    kmer_bits = _get_bits(max_kmers)
    if node_bits + kmer_bits > 31:
        sys.stderr.write(
            f"Too many nodes and kmers ({n_lines + 1} ({node_bits} bits), "
            f"{max_kmers} ({kmer_bits} bits)\n")
        return None

    # --- pass 2: fill tables (database.c:164-266)
    names: list[bytes] = []
    nkmers_list: list[int] = []
    kmer_starts: list = []  # token start offsets (fast path)
    kmer_chunks: list = []  # packed words (slow path), None for fast lines

    shifts = np.arange(2 * (wordsize - 1), -1, -2, dtype=np.uint64) \
        if wordsize else np.empty(0, np.uint64)

    for (start, end) in lines:
        toks = _split_line(data, start, end, 3)
        name = data[toks[0][0]:toks[0][1]]
        nk = _strtol(data, toks[1][0], toks[1][1])
        if nk > max_kmers_per_node:
            nk = max_kmers_per_node
        kstart = toks[2][0] if len(toks) > 2 else end
        # fast path: TAB-separated tokens of exactly wordsize bytes — the
        # common shape, packed vectorized below. Anything else falls back
        # to the reference's byte walk.
        area = data[kstart:end]
        parts = area.split(b"\t")
        if (len(parts) >= nk and nk > 0
                and all(len(parts[j]) == wordsize for j in range(nk))
                and not any(b < 0x20 for b in area)):
            base = kstart
            starts_line = []
            for j in range(nk):
                starts_line.append(base)
                base += wordsize + 1
            names.append(bytes(name))
            nkmers_list.append(nk)
            kmer_starts.extend(starts_line)
            kmer_chunks.append(None)
            continue
        # slow path: walk kmer tokens exactly like database.c:203-243
        cpos = kstart
        kws = np.empty(nk, np.uint64)
        i = 0
        while i < nk:
            while cpos < csize and data[cpos] < 0x20:
                cpos += 1
            if csize - cpos < wordsize:
                break
            seg = buf[cpos:cpos + wordsize]
            if not _VALID[seg].all():
                for ch in seg[~_VALID[seg]]:
                    sys.stderr.write(f"Invalid character {chr(ch)} in string!\n")
            vals = _ALL_BYTE_CODES[seg].astype(np.uint64)
            w = np.uint64(0)
            for v in vals:  # wordsize <= 32 iterations
                w = ((w << np.uint64(2)) | v) & np.uint64(0xFFFFFFFFFFFFFFFF)
            kws[i] = w
            i += 1
            while cpos < csize and data[cpos] >= 0x20:
                cpos += 1
        if i == nk:
            names.append(bytes(name))
            nkmers_list.append(nk)
            kmer_chunks.append(kws)
        else:
            sys.stderr.write(
                f"Inconsisten number of kmers at node {len(names)}: {i} "
                f"(should be {nk})\n")

    # pack all fast-path k-mers in one vectorized pass
    if kmer_starts:
        st = np.asarray(kmer_starts, np.int64)
        seg = buf[st[:, None] + np.arange(wordsize)]
        bad = ~_VALID[seg]
        if bad.any():
            for ch in seg[bad]:
                sys.stderr.write(f"Invalid character {chr(ch)} in string!\n")
        vals = _ALL_BYTE_CODES[seg].astype(np.uint64)
        fast_words = (vals << shifts[None, :]).sum(axis=1, dtype=np.uint64)
        fi = 0
        for idx, ch in enumerate(kmer_chunks):
            if ch is None:
                nk = nkmers_list[idx]
                kmer_chunks[idx] = fast_words[fi:fi + nk]
                fi += nk

    nkmers = np.asarray(nkmers_list, np.uint32)
    starts = np.zeros(len(nkmers), np.uint64)
    if len(nkmers):
        starts[1:] = np.cumsum(nkmers.astype(np.uint64))[:-1]
    words = (np.concatenate(kmer_chunks) if kmer_chunks
             else np.empty(0, np.uint64))
    rc = reverse_complement_u64(words, wordsize)
    dirs = rc < words
    cwords = np.minimum(words, rc)

    db = GmerDB(wordsize=wordsize, node_bits=node_bits, kmer_bits=kmer_bits,
                count_bits=count_bits, names=names,
                node_kmers_start=starts, node_nkmers=nkmers,
                kmer_words=cwords, kmer_dirs=dirs)
    db.finalize_lookup()
    return db


def _split_line(data: bytes, start: int, end: int, max_tokens: int):
    """Tokenizer matching split_line (src/utils.c:234-248) exactly:
    a token is a maximal run of bytes >= 0x20 (spaces are INSIDE tokens);
    each token is followed by exactly one control-character separator, so
    consecutive tabs yield empty tokens. ``end`` is the newline position."""
    toks = []
    p = start
    while len(toks) < max_tokens and p < end:
        s = p
        while p < end and data[p] >= 0x20:
            p += 1
        toks.append((s, p))
        if p < end and data[p] != 0x0A:
            p += 1
    return toks


def _strtol(data: bytes, start: int, end: int) -> int:
    """C strtol base 10 on the token (stops at first non-digit)."""
    s = data[start:end].decode("latin1")
    i = 0
    neg = False
    if i < len(s) and s[i] in "+-":
        neg = s[i] == "-"
        i += 1
    j = i
    while j < len(s) and s[j].isdigit():
        j += 1
    if j == i:
        return 0
    v = int(s[i:j])
    return -v if neg else v


def load_text_db(path: str, max_kmers_per_node: int = 1000000000,
                 count_bits: int = 16) -> GmerDB | None:
    with open(path, "rb") as f:
        return parse_text_db(f.read(), max_kmers_per_node, count_bits)
