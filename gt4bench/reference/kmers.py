"""The plain reference: canonical k-mer counting in plain PyTorch.

Independent of the program: it imports nothing of it and reads only what
the benchmark generated (bases, reads, marker words). A k-mer is the 2k-bit
word of its bases, the first base most significant (A=0 C=1 G=2 T=3); its
canonical word is the smaller of the word and its reverse complement. It
runs on any device: the CPU in the tests, the card after a run's window.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

LIST_MAGIC = 0x47543443          # 'G' 'T' '4' 'C'
LIST_RECORD = np.dtype([("word", "<u8"), ("count", "<u4")])


def canonical_windows(codes: torch.Tensor, k: int,
                      canonical: bool = True) -> torch.Tensor:
    """Every window's canonical word (its forward word with ``canonical``
    false) along the last axis of 2-bit ``codes`` (values 0..3): int64
    [..., L - k + 1]."""
    c = codes.to(torch.int64)
    n = c.shape[-1] - k + 1
    fw = torch.zeros(c.shape[:-1] + (n,), dtype=torch.int64,
                     device=c.device)
    rc = torch.zeros_like(fw)
    for j in range(k):
        part = c[..., j:j + n]
        fw = (fw << 2) | part
        rc = rc | ((3 - part) << (2 * j))
    return torch.minimum(fw, rc) if canonical else fw


def canonical_words(words: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical form of forward int64 words (base by base)."""
    rc = torch.zeros_like(words)
    x = words.clone()
    for _ in range(k):
        rc = (rc << 2) | (3 - (x & 3))
        x = x >> 2
    return torch.minimum(words, rc)


def genome_list(codes: np.ndarray, k: int, device, canonical: bool = True):
    """The sorted canonical (or, with ``canonical`` false, forward) k-mers
    of one record and their counts: (words int64, counts int64) on
    ``device``."""
    if (codes > 3).any():
        raise ValueError("the reference takes ACGT records only")
    can = canonical_windows(torch.from_numpy(codes).to(device), k, canonical)
    words, counts = torch.unique(can, sorted=True, return_counts=True)
    return words, counts


def list_file(words: torch.Tensor, counts: torch.Tensor, k: int,
              block: int = 1 << 24):
    """The ``.list`` file of a sorted list, as (48-byte header, CRC-32 of
    the 12-byte records, number of records): header ``GT4C`` version 4.2,
    k, records, total count, data at byte 48, 8-byte words, 4-byte
    counts; records little-endian u64 word then u32 count."""
    n = words.numel()
    total = int(counts.sum())
    header = struct.pack("<IIIIQQQII", LIST_MAGIC, 4, 2, k, n, total, 48,
                         8, 4)
    crc = 0
    for s in range(0, n, block):
        recs = np.empty(min(block, n - s), LIST_RECORD)
        recs["word"] = words[s:s + block].cpu().numpy().view(np.uint64)
        recs["count"] = counts[s:s + block].cpu().numpy().astype(np.uint32)
        crc = zlib.crc32(recs.view(np.uint8), crc)
    return header, crc, n


def lane_counts(read_codes: np.ndarray, db_words: np.ndarray, k: int,
                device, block_rows: int = 1 << 17) -> np.ndarray:
    """Occurrences of each database word among the canonical windows of
    the reads (no window spans two reads): int64[len(db_words)], in the
    order of ``db_words`` (forward words, canonicalised here)."""
    db = canonical_words(
        torch.from_numpy(np.ascontiguousarray(db_words).view(np.int64))
        .to(device), k)
    out = torch.zeros_like(db)
    for s in range(0, len(read_codes), block_rows):
        block = torch.from_numpy(read_codes[s:s + block_rows]).to(device)
        if bool((block > 3).any()):
            raise ValueError("the reference takes ACGT reads only")
        win = torch.sort(canonical_windows(block, k).reshape(-1)).values
        out += (torch.searchsorted(win, db, right=True)
                - torch.searchsorted(win, db))
    return out.cpu().numpy()
