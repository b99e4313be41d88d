"""The plain reference of glistcompare's two-list set operations, and of the
sample list they take, in plain PyTorch with no float.

Independent of the program: it imports nothing of it and is written from
the operations' definitions (Kaplinski et al. 2015; the reference
glistcompare's rules), for ``glistcompare LIST1 LIST2 -u -i -d -dd`` over
two sorted unique lists (words int64, counts int64 holding u32 values; a
word absent from a list has the count 0 there). A word's output count is
its rule's over its two counts c1 and c2:

* union: every word whose count reaches the cutoff in either list; by
  default ADD, the sum wrapped as a C unsigned int;
* intersection: every word of both lists whose counts both reach the
  cutoff; by default MIN;
* difference (``-d``): every word of list 1 that reaches the cutoff there
  and not in list 2; by default SUBTRACT, c1 - c2 where positive, else 0;
* double difference (``-dd``): the same with the lists' roles swapped,
  the rule taking (c2, c1);

the other rules are MAX, FIRST (c1), SECOND (c2) and NUMBER (a given
count), and a word whose count comes out 0 is left out of every output.
Each output is ascending. It runs on any device: the CPU in the tests,
the card after a run's window.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from gt4bench.reference.kmers import (LIST_MAGIC, LIST_RECORD,
                                      canonical_windows, list_file)

U32 = 0xFFFFFFFF
OPS = ("union", "intrsec", "diff1", "diff2")


def reads_list(read_codes: np.ndarray, k: int, device, canonical: bool = True,
               block_rows: int = 1 << 16):
    """The sorted canonical (forward with ``canonical`` false) k-mers of
    reads, 2-bit codes uint8[n, L] (no window spans two reads), and their
    counts: (words int64, counts int64) on ``device``. Each block of reads
    is counted alone, then the blocks' counts are summed by word."""
    words, counts = [], []
    for s in range(0, len(read_codes), block_rows):
        block = torch.from_numpy(read_codes[s:s + block_rows]).to(device)
        if bool((block > 3).any()):
            raise ValueError("the reference takes ACGT reads only")
        w, c = torch.unique(canonical_windows(block, k, canonical)
                            .reshape(-1), return_counts=True)
        words.append(w)
        counts.append(c)
    if not words:
        empty = torch.zeros(0, dtype=torch.int64, device=device)
        return empty, empty.clone()
    uw, inv = torch.unique(torch.cat(words), return_inverse=True)
    return uw, torch.zeros_like(uw).index_add_(0, inv, torch.cat(counts))


def _lookup(words: torch.Tensor, in_words: torch.Tensor,
            in_counts: torch.Tensor):
    """Whether each of ``words`` is in the sorted list ``in_words``, and
    its count there (0 where absent)."""
    if not in_words.numel():
        return (torch.zeros_like(words, dtype=torch.bool),
                torch.zeros_like(words))
    at = torch.searchsorted(in_words, words).clamp(max=in_words.numel() - 1)
    hit = in_words[at] == words
    return hit, torch.where(hit, in_counts[at], 0)


DEFAULT_RULES = {"union": "add", "intrsec": "min", "diff1": "subtract",
                 "diff2": "subtract"}


def rule_count(a: torch.Tensor, b: torch.Tensor, rule: str,
               number: int = 1) -> torch.Tensor:
    """A rule's count of a word with the counts ``a`` and ``b``."""
    if rule == "add":
        return (a + b) & U32
    if rule == "subtract":
        return torch.where(a > b, a - b, 0)
    if rule == "min":
        return torch.minimum(a, b)
    if rule == "max":
        return torch.maximum(a, b)
    if rule == "first":
        return a
    if rule == "second":
        return b
    if rule == "number":
        return torch.full_like(a, number & U32)
    raise ValueError(f"no rule {rule}")


def set_ops(w1, c1, w2, c2, cutoff: int = 1, rule: str = "default",
            number: int = 1) -> dict:
    """{op: (words, counts)} of union ("union"), intersection
    ("intrsec"), difference ("diff1") and double difference ("diff2")
    of list 1 (w1, c1) and list 2 (w2, c2): each op under ``rule``, or
    its own default rule."""
    _, f2 = _lookup(w1, w2, c2)     # list 2's count of list 1's words
    in1, _ = _lookup(w2, w1, c1)
    # every word of either list once, ascending, with its two counts
    words = torch.cat([w1, w2[~in1]])
    order = torch.argsort(words)
    words = words[order]
    a = torch.cat([c1, torch.zeros_like(c2[~in1])])[order]
    b = torch.cat([f2, c2[~in1]])[order]
    on1, on2 = a >= cutoff, b >= cutoff
    keep = {"union": on1 | on2,
            "intrsec": (a > 0) & (b > 0) & on1 & on2,
            "diff1": (a > 0) & on1 & ~on2,
            "diff2": (b > 0) & on2 & ~on1}
    out = {}
    for op, k in keep.items():
        r = DEFAULT_RULES[op] if rule == "default" else rule
        n = (rule_count(b, a, r, number) if op == "diff2"
             else rule_count(a, b, r, number))
        k = k & (n != 0)
        out[op] = (words[k], n[k])
    return out


def expected_files(outputs: dict, k: int) -> dict:
    """{op: ((48-byte header, CRC-32 of the records), number of records)}
    of each output's ``.list``."""
    res = {}
    for op, (w, c) in outputs.items():
        hdr, crc, n = list_file(w, c, k)
        res[op] = ((hdr, crc), n)
    return res


def write_list_file(path: str, words: torch.Tensor, counts: torch.Tensor,
                    k: int, block: int = 1 << 24) -> None:
    """Write a sorted list as a ``.list`` file: the header of
    ``reference.kmers.list_file``, then its 12-byte records."""
    n = words.numel()
    header = struct.pack("<IIIIQQQII", LIST_MAGIC, 4, 2, k, n,
                         int(counts.sum()), 48, 8, 4)
    with open(path, "wb") as f:
        f.write(header)
        for s in range(0, n, block):
            recs = np.empty(min(block, n - s), LIST_RECORD)
            recs["word"] = words[s:s + block].cpu().numpy().view(np.uint64)
            recs["count"] = counts[s:s + block].cpu().numpy().astype(
                np.uint32)
            f.write(recs.tobytes())
