"""FastGT-shaped marker database from a seed.

A marker is a single-nucleotide variant: its REF 25-mer and its ALT 25-mer,
the same word with the middle base changed. Markers on the source genome
take their REF word from it, at the density a whole-genome database has
(``markers`` over ``genome_bp``); the rest are random words, standing for
the chromosomes whose reads the run leaves out. A marker any of whose
canonical words occurs twice among the candidates is dropped, as FastGT
keeps only markers unique in its database, so every seed gives exactly
``markers`` markers.
"""

from __future__ import annotations

import numpy as np
import torch


def words_at(codes: np.ndarray, pos: np.ndarray, k: int) -> np.ndarray:
    """The forward k-mer words (first base most significant) of 2-bit
    ``codes`` at positions ``pos``: uint64[len(pos)]."""
    w = np.zeros(len(pos), np.uint64)
    for j in range(k):
        w = (w << np.uint64(2)) | codes[pos + j].astype(np.uint64)
    return w


def canonical_np(w: np.ndarray, k: int):
    """(canonical words, reverse complement taken) of forward uint64 words:
    the complement of each base, in reverse order, is the reverse
    complement (2-bit groups swapped pairwise, then in fours, ...); the
    canonical word is the smaller of the two."""
    x = ~w
    for shift, mask in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                        (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF)):
        s, m = np.uint64(shift), np.uint64(mask)
        x = ((x >> s) & m) | ((x & m) << s)
    x = (x >> np.uint64(32)) | (x << np.uint64(32))
    rc = x >> np.uint64(64 - 2 * k)
    return np.minimum(w, rc), rc < w


def repeated(words: np.ndarray, device) -> np.ndarray:
    """bool[len(words)]: the word occurs more than once (a sort on
    ``device``)."""
    t = torch.from_numpy(words.view(np.int64)).to(device)
    s, order = torch.sort(t)
    dup = torch.zeros_like(s, dtype=torch.bool)
    same = s[1:] == s[:-1]
    dup[1:] |= same
    dup[:-1] |= same
    out = torch.empty_like(dup)
    out[order] = dup
    return out.cpu().numpy()


def draw_markers(rng: np.random.Generator, source_codes: np.ndarray,
                 p: dict, device) -> tuple[np.ndarray, int]:
    """(forward words uint64[markers, 2] as REF, ALT; the number of
    markers on the source, which come first). ``p``: ``markers``,
    ``genome_bp``, ``word_length``."""
    k = int(p["word_length"])
    n = int(p["markers"])
    n_on = round(n * len(source_codes) / float(p["genome_bp"]))
    n_off = n - n_on
    mid = np.uint64(2 * (k - 1 - k // 2))
    # a source word in a repeat family or drawn twice is dropped: draw
    # twice the markers needed
    cand_on = 2 * n_on + 64
    cand_off = n_off + max(64, n_off // 1000)
    pos = rng.integers(0, len(source_codes) - k + 1, cand_on)
    ref = np.concatenate([
        words_at(source_codes, pos, k),
        rng.integers(0, 1 << (2 * k), cand_off, dtype=np.uint64)])
    alt = ref ^ (rng.integers(1, 4, len(ref)).astype(np.uint64) << mid)
    pair = np.stack([ref, alt], axis=1)
    can, _ = canonical_np(pair.reshape(-1), k)
    bad = repeated(can, device).reshape(-1, 2).any(axis=1)
    on = np.flatnonzero(~bad[:cand_on])[:n_on]
    off = cand_on + np.flatnonzero(~bad[cand_on:])[:n_off]
    if len(on) < n_on or len(off) < n_off:
        raise RuntimeError("too few unique markers drawn")
    return np.ascontiguousarray(pair[np.concatenate([on, off])]), n_on
