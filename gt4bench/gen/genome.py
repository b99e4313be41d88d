"""Genome-shaped sequence from a seed, and its FASTA file.

A vectorised copy of the generator in ``chip_smoke.py`` (``genome_bases``,
``write_fasta``): isochores of one GC fraction each, then planted repeat
families whose copies carry point mutations and lie on either strand. The
shape comes from a traffic mix's ``genome`` parameters, so every seed gives
the same sizes and only the sequence changes.
"""

from __future__ import annotations

import numpy as np

ALPHABET = np.frombuffer(b"ACGT", np.uint8)
_COMP = np.zeros(256, np.uint8)
_COMP[ALPHABET] = np.frombuffer(b"TGCA", np.uint8)


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """One generator per (seed, stream...): independent draws for each
    input of a run, whatever order they are made in."""
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), *stream])


def genome_bases(rng: np.random.Generator, length: int, p: dict) -> np.ndarray:
    """ASCII ACGT bases, uint8[length].

    ``p``: ``isochore_bp`` (block length), ``gc`` ([lo, hi]: a block's GC
    fraction is lo + (hi - lo) * Beta(2, 2)), ``repeat_families``,
    ``family_bp`` ([lo, hi) of a family's consensus length), ``copies``
    ([lo, hi) copies a family), ``copy_mutation`` (share of a copy's bases
    redrawn)."""
    blk = int(p["isochore_bp"])
    n_blk = -(-length // blk)
    lo, hi = p["gc"]
    gc = (lo + (hi - lo) * rng.beta(2.0, 2.0, n_blk)).astype(np.float32)
    gc = np.repeat(gc, blk)[:length]
    u = rng.random(length, dtype=np.float32)
    # A below (1 - gc) / 2, C and G gc / 2 each, T the rest
    at = (1.0 - gc) * 0.5
    out = ALPHABET[(u >= at).astype(np.uint8) + (u >= at + gc * 0.5)
                   + (u >= 1.0 - at)]
    del u, gc, at
    f_lo, f_hi = p["family_bp"]
    c_lo, c_hi = p["copies"]
    mut = float(p["copy_mutation"])
    for _ in range(int(p["repeat_families"])):
        flen = int(rng.integers(f_lo, f_hi))
        fam = rng.choice(ALPHABET, size=flen)
        for _ in range(int(rng.integers(c_lo, c_hi))):
            copy = fam.copy()
            nmut = max(1, int(mut * flen))
            copy[rng.integers(0, flen, nmut)] = ALPHABET[
                rng.integers(0, 4, nmut)]
            if rng.random() < 0.5:
                copy = _COMP[copy][::-1]
            at0 = int(rng.integers(0, length - flen))
            out[at0:at0 + flen] = copy
    return out


def fasta_bytes(name: bytes, bases: np.ndarray, width: int) -> bytes:
    """One FASTA record, ``width`` bases a line."""
    full = len(bases) // width * width
    lines = np.concatenate(
        [bases[:full].reshape(-1, width),
         np.full((full // width, 1), ord("\n"), np.uint8)], axis=1)
    tail = bases[full:].tobytes() + b"\n" if full < len(bases) else b""
    return b">" + name + b"\n" + lines.tobytes() + tail


def codes_of(bases: np.ndarray) -> np.ndarray:
    """ASCII ACGT -> 2-bit codes 0..3 (uint8)."""
    lut = np.full(256, 255, np.uint8)
    lut[ALPHABET] = np.arange(4, dtype=np.uint8)
    out = lut[bases]
    if (out == 255).any():
        raise ValueError("a base outside ACGT")
    return out
