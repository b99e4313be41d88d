"""Mismatch-neighborhood generation (the port's copy of
``genometester4_tpu/ops/mismatch.py``; host numpy).

The reference generates neighborhoods recursively into a word table
(gt4_word_table_generate_mismatches, src/word-table.c:360-382): choose
strictly-increasing positions and XOR a non-zero 2-bit value at each, so
the exactly-m neighborhood of a word is ``word ^ mask`` over all masks
with exactly m non-zero 2-bit groups.

Masks are word-independent, so we precompute them once per (k, m) and
broadcast-XOR against whole candidate batches — turning the reference's
per-word recursion + per-neighbor binary search into one batched lookup.
"""

from __future__ import annotations

from functools import lru_cache
from itertools import combinations

import numpy as np

from genometester4_tpu_torch.ops.encode import canonical_u64


@lru_cache(maxsize=None)
def exact_mismatch_masks(k: int, m: int) -> np.ndarray:
    """All u64 XOR masks flipping exactly m of the k base positions.

    Position i is bit offset 2*i (LSB-first, as in the reference's
    ``mismatch << (2 * i)``). C(k,m)·3^m masks.
    """
    if m == 0:
        return np.zeros(1, dtype=np.uint64)
    vals = np.array([1, 2, 3], dtype=np.uint64)
    combos = list(combinations(range(k), m))
    # value assignment grids for m positions: 3^m rows
    grids = np.stack(np.meshgrid(*([vals] * m), indexing="ij"),
                     axis=-1).reshape(-1, m)
    masks = np.zeros((len(combos), len(grids)), dtype=np.uint64)
    for ci, pos in enumerate(combos):
        acc = np.zeros(len(grids), dtype=np.uint64)
        for j, p in enumerate(pos):
            acc |= grids[:, j] << np.uint64(2 * p)
        masks[ci] = acc
    return masks.reshape(-1)


def upto_mismatch_words(word: int, k: int, nmm: int, canonical: bool = False,
                        equal_mm_only: bool = False) -> np.ndarray:
    """Neighborhood of one word: ≤nmm (or exactly nmm) mismatches.

    Matches the word set produced by gt4_word_table_generate_mismatches
    (order differs; all consumers treat the table as a set).
    """
    ms = [exact_mismatch_masks(k, nmm)] if equal_mm_only else [
        exact_mismatch_masks(k, m) for m in range(nmm + 1)]
    masks = np.concatenate(ms)
    words = np.uint64(word) ^ masks
    if canonical:
        words = canonical_u64(words, k)
    return words


@lru_cache(maxsize=None)
def preorder_masks(k: int, n_mm: int, start: int = 0,
                   equal_mm_only: bool = False) -> np.ndarray:
    """XOR masks in the reference's exact DFS emission order.

    gt4_word_table_generate_mismatches (src/word-table.c:360-382) emits
    the current word first, then recurses over positions ``start..k-1``
    (LSB-first) × values 1..3. glistquery's ``--all`` prints results in
    this table order, so order-faithful output needs the same sequence.
    ``start`` implements the 3' perfect-match prefix (pm_3 is passed as
    the start position, src/word-dict.c:92).
    """
    out: list[int] = []

    def rec(mask: int, n: int, s: int):
        if not equal_mm_only or not n:
            out.append(mask)
        if not n:
            return
        for i in range(s, k):
            for v in (1, 2, 3):
                rec(mask ^ (v << (2 * i)), n - 1, i + 1)

    rec(0, n_mm, start)
    return np.array(out, dtype=np.uint64)


def lookup_counts(sorted_words: np.ndarray, sorted_counts: np.ndarray,
                  queries: np.ndarray) -> np.ndarray:
    """Vectorized point lookup into a sorted list; 0 when absent.

    Host-side equivalent of the mmap binary search
    (src/word-map.c:134-163); device batched search lives in ops.lookup.
    """
    idx = np.searchsorted(sorted_words, queries)
    idx_c = np.minimum(idx, max(len(sorted_words) - 1, 0))
    if len(sorted_words) == 0:
        return np.zeros(len(queries), dtype=np.uint32)
    hit = sorted_words[idx_c] == queries
    return np.where(hit, sorted_counts[idx_c], 0).astype(np.uint32)
