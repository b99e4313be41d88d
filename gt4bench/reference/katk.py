"""The plain reference of a KATK job: the read index, the Smith-Waterman
fill, and the judge of the calls.

Written from the published semantics (GenomeTester4's KATK: the read
index of ``gmer_counter --compile_index``, ``README.KATK.md``; the fill's
scores and tie-breaks as ``BENCHMARK.json``'s configuration states them),
independent of the program: it imports nothing of it and reads only what
the benchmark generated and what the program wrote. Plain PyTorch; it runs
on any device, the CPU in the tests and the card after a run's window.

**The read index** lists, under each database word, every read window
whose canonical word equals it, as (read, direction, position): the read's
ordinal in the FASTQ, 1 where the window is the reverse complement of the
canonical word, and the window's first base in the read. An entry is one
int64 key, ``((slot * n_reads + read) * 2 + dir) * 256 + pos``, and an
index is the sorted multiset of its keys. ``gt4i_keys`` reads the same
keys out of the program's file: a GMDB database whose last block is a
``GT4I`` read index (per slot a first offset; per entry ``dir | file |
name_pos | kmer_pos`` in the bit widths of its header), where ``name_pos``
is the byte offset of the read's name, one past its record's ``@``.

**The fill** of a lane aligns a read (columns j = 1..m) to a reference
(rows i = 1..n, at most the lane's length). With codes A C G T = 0..3 and
anything above 3 (N, gap, padding) scoring 0, a match 2 and a mismatch -3:

    diag = H[i-1, j-1] + s;  H = max(diag, 0);  sx = sy = -1 if diag > 0
    left gap  E = max(E[i, j-1] - 2, H - 4); its length grows by one (an
              int8, wrapping) when the extension is strictly larger, else
              is 0; taken when E >= H: H = E, sx = -length, sy = 0
    top gap   F = max(F[i-1, j] - 2, H - 4) on the H after the left gap;
              length likewise; taken when F >= H: H = F, sx = 0,
              sy = -length

Row 0, column 0 and every row past the lane's length hold H = 0, sx = sy
= 0 and gap scores of -1000 (the least of the score type) with length 0.
The sweep runs over anti-diagonals i + j, a vector over the rows.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from gt4bench.reference.kmers import canonical_windows, canonical_words

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MATCH, MISMATCH, GAP_OPEN, GAP_EXTEND = 2, -3, -4, -2
PAD = 6            # the padding code of references and reads
NEG = -1000


def _key(slot, read, direction, pos, n_reads):
    return ((slot * n_reads + read) * 2 + direction) * 256 + pos


def read_index(read_codes: np.ndarray, db_words: np.ndarray, k: int,
               device, canonical: bool = True,
               block_rows: int = 1 << 16) -> np.ndarray:
    """The sorted keys of the read index of ``read_codes`` (uint8 [n, L],
    2-bit codes) under ``db_words`` (forward int64 words, database order).
    With ``canonical`` false only the windows whose forward word is the
    database word's canonical word are listed (the control)."""
    n, L = read_codes.shape
    db = canonical_words(torch.from_numpy(
        np.ascontiguousarray(db_words, np.int64)).to(device), k)
    sdb, order = torch.sort(db)
    keys = []
    for s in range(0, n, block_rows):
        block = torch.from_numpy(read_codes[s:s + block_rows]).to(device)
        fw = canonical_windows(block, k, canonical=False)
        can = canonical_windows(block, k) if canonical else fw
        at = torch.searchsorted(sdb, can).clamp(max=len(sdb) - 1)
        hit = sdb[at] == can
        rows, pos = torch.nonzero(hit, as_tuple=True)
        keys.append(_key(order[at[rows, pos]], rows + s,
                         (fw[rows, pos] != can[rows, pos]).to(torch.int64),
                         pos, n))
    return torch.sort(torch.cat(keys)).values.cpu().numpy()


def gt4i_keys(path: str, record_bytes: int, n_reads: int) -> np.ndarray:
    """The sorted keys of the read index in the program's ``.idx`` file.
    An entry that names another file, or a byte offset that is no
    record's name, gets a key of its own that no reference key equals."""
    with open(path, "rb") as f:
        head = f.read(88)
        if head[:4] != b"GMDB":
            raise ValueError(f"{path}: no GMDB header")
        index_start = struct.unpack_from("<Q", head, 80)[0]
        f.seek(index_start + 8)      # past the block's size
        blob = f.read()
    if blob[:4] != struct.pack("<I", 0x47543449):   # 'G' 'T' '4' 'I'
        raise ValueError(f"{path}: no GT4I read index")
    nb_file, nb_npos, nb_kmer = struct.unpack_from("<III", blob, 16)
    n_files, n_kmers, n_entries = struct.unpack_from("<IQQ", blob, 28)
    _, blocks_at, reads_at = struct.unpack_from("<QQQ", blob, 48)
    firsts = np.frombuffer(blob, np.uint64, n_kmers, blocks_at).astype(
        np.int64)
    codes = np.frombuffer(blob, np.uint64, n_entries, reads_at)
    per_slot = np.diff(np.append(firsts, n_entries))
    if n_kmers and (firsts[0] != 0 or (per_slot < 0).any()):
        return -1 - np.arange(n_entries, dtype=np.int64)   # no layout
    slot = np.repeat(np.arange(n_kmers, dtype=np.int64), per_slot)
    pos = (codes & np.uint64((1 << nb_kmer) - 1)).astype(np.int64)
    npos = ((codes >> np.uint64(nb_kmer))
            & np.uint64((1 << nb_npos) - 1)).astype(np.int64)
    fidx = ((codes >> np.uint64(nb_kmer + nb_npos))
            & np.uint64((1 << nb_file) - 1)).astype(np.int64)
    direction = (codes >> np.uint64(nb_kmer + nb_npos + nb_file)
                 ).astype(np.int64) & 1
    read, off = np.divmod(npos - 1, record_bytes)
    keys = _key(slot, read, direction, pos, n_reads)
    bad = (fidx != 0) | (off != 0) | (read >= n_reads) | (pos > 255)
    keys[bad] = -1 - np.arange(int(bad.sum()))
    return np.sort(keys)


def entries_wrong(got: np.ndarray, want: np.ndarray) -> int:
    """Entries of the multiset ``got`` that ``want`` lacks, and of
    ``want`` that ``got`` lacks."""
    gv, gc = np.unique(got, return_counts=True)
    wv, wc = np.unique(want, return_counts=True)
    _, gi, wi = np.intersect1d(gv, wv, assume_unique=True,
                               return_indices=True)
    return int(len(got) + len(want) - 2 * np.minimum(gc[gi], wc[wi]).sum())


def _wrap(x: torch.Tensor, bits: int) -> torch.Tensor:
    half = 1 << (bits - 1)
    return ((x + half) & ((1 << bits) - 1)) - half


def sw_fill(refs: torch.Tensor, reads: torch.Tensor, nvec: torch.Tensor,
            score_bits: int = 16):
    """Lanes refs int8 [B, n], reads int8 [B, m], lengths nvec [B] ->
    (H, sx, sy) [B, n + 1, m + 1], H as int16, sx and sy int8. Scores are
    kept in ``score_bits`` (16, or 8 for the control), wrapping."""
    B, n = refs.shape
    m = reads.shape[1]
    dev = refs.device
    i32 = torch.int32
    neg = max(NEG, -(1 << (score_bits - 1)))
    rows = torch.arange(n + 1, device=dev)
    ref = torch.cat([torch.full((B, 1), PAD, dtype=i32, device=dev),
                     refs.to(i32)], 1)                       # row i: ref[i-1]
    # column j's read base, for the rows of a diagonal in ascending order:
    # a padded, reversed read, sliced at an offset that moves with d
    rd = torch.cat([torch.full((B, n + 1), PAD, dtype=i32, device=dev),
                    torch.full((B, 1), PAD, dtype=i32, device=dev),
                    reads.to(i32),
                    torch.full((B, n + 1), PAD, dtype=i32, device=dev)],
                   1).flip(1)
    width = rd.shape[1]
    lim = nvec.to(torch.int64).clamp(max=n)[:, None]
    ref_bad = ref > 3
    zero = torch.zeros((B, n + 1), dtype=i32, device=dev)
    negs = torch.full((B, n + 1), neg, dtype=i32, device=dev)
    h2, h1 = zero, zero                  # H on diagonals d - 2, d - 1
    e1, el1, f1, fl1 = negs, zero, negs, zero
    outs = [torch.zeros((n + m + 1, B, n + 1), dtype=dt, device=dev)
            for dt in (torch.int16, torch.int8, torch.int8)]
    for d in range(2, n + m + 1):
        j = d - rows                                          # (n + 1,)
        valid = (rows >= 1) & (rows <= lim) & (j >= 1) & (j <= m)
        at = width - d - n - 2
        b = rd[:, at:at + n + 1]
        s = torch.where(ref == b, MATCH, MISMATCH)
        s = torch.where(ref_bad | (b > 3), 0, s)
        diag = torch.cat([zero[:, :1], h2[:, :-1]], 1) + s
        h = diag.clamp_min(0)
        sx = sy = -(diag > 0).to(i32)
        ext = e1 + GAP_EXTEND
        e = torch.maximum(ext, h + GAP_OPEN)
        el = torch.where(ext > h + GAP_OPEN, _wrap(el1 + 1, 8), 0)
        take = e >= h
        h = torch.maximum(e, h)
        sx = torch.where(take, _wrap(-el, 8), sx)
        sy = torch.where(take, 0, sy)
        ext = torch.cat([negs[:, :1], f1[:, :-1]], 1) + GAP_EXTEND
        fl_up = torch.cat([zero[:, :1], fl1[:, :-1]], 1)
        f = torch.maximum(ext, h + GAP_OPEN)
        fl = torch.where(ext > h + GAP_OPEN, _wrap(fl_up + 1, 8), 0)
        take = f >= h
        h = torch.maximum(f, h)
        sx = torch.where(take, 0, sx)
        sy = torch.where(take, _wrap(-fl, 8), sy)
        h = torch.where(valid, _wrap(h, score_bits), 0)
        outs[0][d] = h.to(torch.int16)
        outs[1][d] = torch.where(valid, sx, 0).to(torch.int8)
        outs[2][d] = torch.where(valid, sy, 0).to(torch.int8)
        h2, h1 = h1, h
        e1 = torch.where(valid, _wrap(e, score_bits), neg)
        el1 = torch.where(valid, el, 0)
        f1 = torch.where(valid, _wrap(f, score_bits), neg)
        fl1 = torch.where(valid, fl, 0)
    ii = rows[:, None]
    jj = torch.arange(m + 1, device=dev)[None, :]
    return tuple(o[ii + jj, :, ii].permute(2, 0, 1).contiguous()
                 for o in outs)


def fill_regions(region_inputs, device, score_bits: int = 16,
                 block_lanes: int = 1024) -> list:
    """Every region's fill, as the program's ``sw_matrices_batch_device_
    multi`` returns it: per (ref int8 [n], reads int8 [B, m]) the numpy
    (H int16, sx int8, sy int8) [B, n + 1, m + 1]. Lanes run in blocks,
    padded to the block's longest reference and read."""
    lanes = [(ref, read) for ref, batch in region_inputs for read in batch]
    got = []
    for s in range(0, len(lanes), block_lanes):
        part = lanes[s:s + block_lanes]
        n = max(len(r) for r, _ in part)
        m = max(len(q) for _, q in part)
        refs = np.full((len(part), n), PAD, np.int8)
        reads = np.full((len(part), m), PAD, np.int8)
        for x, (r, q) in enumerate(part):
            refs[x, :len(r)] = r
            reads[x, :len(q)] = q
        nvec = torch.tensor([len(r) for r, _ in part], dtype=torch.int32)
        mats = sw_fill(torch.from_numpy(refs).to(device),
                       torch.from_numpy(reads).to(device), nvec.to(device),
                       score_bits)
        mats = [t.cpu().numpy() for t in mats]
        got.extend((mats[0][x], mats[1][x], mats[2][x])
                   for x in range(len(part)))
    out, at = [], 0
    for ref, batch in region_inputs:
        n, (b, m) = len(ref), batch.shape
        out.append(tuple(np.stack([got[at + x][c][:n + 1, :m + 1]
                                   for x in range(b)])
                         if b else np.zeros((0, n + 1, m + 1), dt)
                         for c, dt in enumerate((np.int16, np.int8,
                                                 np.int8))))
        at += b
    return out


def lane_crcs(mats) -> list:
    """CRC-32 of each lane's H, then sx, then sy bytes."""
    sc, sx, sy = (np.ascontiguousarray(a) for a in mats)
    return [zlib.crc32(sy[b], zlib.crc32(sx[b], zlib.crc32(sc[b])))
            for b in range(len(sc))]


def parse_calls(text: str) -> dict:
    """gassembler's printed calls: (pos, sub) -> (ref, call)."""
    out = {}
    for line in text.splitlines():
        f = line.split("\t")
        if len(f) < 7 or line.startswith(("#", "CHR")):
            continue
        out[(int(f[1]), int(f[2]))] = (f[3], f[5])
    return out


def calls_wrong(text: str, regions, judged, variants) -> int:
    """Judged planted variants whose printed call is not the planted
    genotype (a deletion: at either of its bases), plus printed
    non-reference calls at the other positions of judged regions."""
    calls = parse_calls(text)
    planted = set()
    wrong = 0
    for v in variants:
        if not judged[v.region]:
            continue
        ok = True
        for q, gt in enumerate(v.genotype):
            planted.add(v.pos + q)
            got = calls.get((v.pos + q, 0))
            ok &= got is not None and tuple(sorted(got[1])) == tuple(gt)
        wrong += not ok
    starts = np.array([s for s, _ in regions])
    for (pos, sub), (ref, call) in calls.items():
        r = int(np.searchsorted(starts, pos, side="right")) - 1
        if r < 0 or pos >= regions[r][1] or not judged[r]:
            continue
        if sub == 0 and pos in planted:
            continue
        if call != "NC" and call != ref + ref:
            wrong += 1
    return wrong
