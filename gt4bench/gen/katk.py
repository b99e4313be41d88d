"""A KATK sample from a seed: a genome-shaped stretch, its regions and their
anchor database, a diploid sample with planted variants, and its reads.

The stretch is ``gen.genome.genome_bases`` with the traffic's ``genome``
block, each family's copies scaled to the stretch's length (at least 2),
so that some anchors repeat as in a whole genome. Regions of
``region_bp`` start every ``spacing`` bases, each with anchor 25-mers every
``anchor_step`` bases of its reference (``tools/katk_fixture.py``'s
layout). The database lists each anchor word once (canonically), under the
name of its first region; a region's line lists all its anchors.

The sample is diploid: by seed a region carries a het SNV, a hom SNV or
none, at an offset in ``snv_offset``; every ``deletion_every``-th region
also carries a het 2-bp deletion at an offset where no shift of it gives
the same haplotype. Reads are drawn uniformly over both haplotypes of the
whole stretch (``gen.reads.draw_reads``), shuffled, and written as one
FASTQ whose records all have one length, so a record's name offset gives
its ordinal.

A judged region has every 25-mer of its read window (the region and
``read_len`` on each side) unique in the stretch on both strands: its
anchors among them, and no repeat copy overlaps it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from gt4bench.gen.genome import codes_of, genome_bases, rng_for
from gt4bench.gen.reads import draw_reads, fastq_bytes, record_bytes
from gt4bench.reference.kmers import canonical_windows

ACGT = "ACGT"
K = 25


@dataclass
class Variant:
    region: int
    pos: int            # first base on the stretch (0-based)
    kind: str           # "het", "hom" or "del"
    genotype: tuple     # per position: the two bases of the call, sorted


@dataclass
class Sample:
    reads_fq: str
    db_txt: str
    regions_txt: str
    read_codes: np.ndarray      # uint8 [n_reads, read_len], as written
    record_bytes: int
    db_words: np.ndarray        # int64 forward words, in database order
    regions: list               # (start, end) of each region
    judged: np.ndarray          # bool per region
    variants: list              # Variant, every planted one

    @property
    def bases(self) -> int:
        return int(self.read_codes.size)


def scaled_genome(p: dict, bases: int) -> dict:
    """The ``genome`` block with each family's copies scaled from
    ``scale_from_bp`` to ``bases``, at least 2."""
    g = dict(p["genome"])
    f = bases / float(p["source"]["scale_from_bp"])
    lo, hi = g["copies"]
    g["copies"] = [max(2, round(lo * f)), max(3, round(hi * f))]
    return g


def _windows(codes: np.ndarray):
    """(forward 25-mer words of ``codes``, their canonical words, whether
    each canonical word occurs once among all of them)."""
    t = torch.from_numpy(codes)
    fw = canonical_windows(t, K, canonical=False).numpy()
    can = canonical_windows(t, K).numpy()
    _, inv, counts = np.unique(can, return_inverse=True, return_counts=True)
    return fw, can, counts[inv] == 1


def _deletion_at(rng, ref: np.ndarray, lo: int, hi: int, avoid: int):
    """An offset in [lo, hi] at which a 2-bp deletion of ``ref`` is the
    only one that gives its haplotype, at least 10 bases from ``avoid``;
    None when no such offset is found."""
    for _ in range(64):
        o = int(rng.integers(lo, hi + 1))
        if abs(o - avoid) < 10:
            continue
        if ref[o - 1] != ref[o + 1] and ref[o] != ref[o + 2]:
            return o
    return None


def make_sample(seed: int, t: dict, workdir: str) -> Sample:
    """Write reads.fq, db.txt and regions.txt for ``seed`` in
    ``workdir``."""
    bases = int(t["source"]["bases"])
    src = genome_bases(rng_for(seed, 0), bases, scaled_genome(t, bases))
    codes = codes_of(src)
    r = t["regions"]
    n_reg, reg_bp = int(r["count"]), int(r["region_bp"])
    spacing, first = int(r["spacing"]), int(r["first"])
    step, a_off = int(r["anchor_step"]), int(r["anchor_offset"])
    L = int(t["reads"]["read_len"])
    fw, can, once = _windows(codes)

    regions, lines, db_lines, db_words = [], [], [], []
    seen = set()
    judged = np.zeros(n_reg, bool)
    for i in range(n_reg):
        start = first + spacing * i
        end = start + reg_bp
        regions.append((start, end))
        anchors = list(range(start + a_off, end - 30, step))
        kmers = [src[a:a + K].tobytes().decode() for a in anchors]
        for j, (a, km) in enumerate(zip(anchors, kmers)):
            if can[a] not in seen:
                seen.add(can[a])
                db_words.append(fw[a])
                db_lines.append(f"R{i}_{j}\t1\t{km}")
        lines.append(f"1\t{start}\t{end}\t{src[start:end].tobytes().decode()}"
                     "\t" + "\t".join(kmers))
        lo, hi = max(0, start - L), min(bases, end + L)
        judged[i] = bool(once[lo:hi - K + 1].all())

    v = t["variants"]
    rng = rng_for(seed, 1)
    hap1, hap2 = src.copy(), src.copy()
    variants, cuts = [], []
    o_lo, o_hi = v["snv_offset"]
    for i, (start, end) in enumerate(regions):
        u = rng.random()
        off = int(rng.integers(o_lo, o_hi + 1))
        alt = (int(codes[start + off]) + int(rng.integers(1, 4))) % 4
        ref_b, alt_b = ACGT[codes[start + off]], ACGT[alt]
        if u < v["het_share"]:
            hap2[start + off] = ord(alt_b)
            variants.append(Variant(i, start + off, "het",
                                    (tuple(sorted(ref_b + alt_b)),)))
        elif u < v["het_share"] + v["hom_share"]:
            hap1[start + off] = hap2[start + off] = ord(alt_b)
            variants.append(Variant(i, start + off, "hom",
                                    ((alt_b, alt_b),)))
        else:
            off = -100
        if i % int(v["deletion_every"]) == 0:
            d = _deletion_at(rng, codes[start:end], o_lo, o_hi, off)
            if d is not None:
                p = start + d
                variants.append(Variant(i, p, "del", tuple(
                    tuple(sorted(ACGT[codes[q]] + "-")) for q in (p, p + 1))))
                cuts.append(p)
    if cuts:
        keep = np.ones(bases, bool)
        keep[np.array(cuts)] = keep[np.array(cuts) + 1] = False
        hap2 = hap2[keep]

    rp = t["reads"]
    n_reads = int(round(float(rp["depth"]) * bases / L))
    n1 = n_reads // 2
    reads = np.concatenate([draw_reads(rng_for(seed, 2), hap1, n1, rp),
                            draw_reads(rng_for(seed, 3), hap2, n_reads - n1,
                                       rp)])
    reads = reads[rng_for(seed, 4).permutation(n_reads)]

    paths = [os.path.join(workdir, n)
             for n in ("reads.fq", "db.txt", "regions.txt")]
    fastq_bytes(reads).tofile(paths[0])
    with open(paths[1], "w") as f:
        f.write("\n".join(db_lines) + "\n")
    with open(paths[2], "w") as f:
        f.write("\n".join(lines) + "\n")
    return Sample(*paths, codes_of(reads), record_bytes(n_reads, L),
                  np.array(db_words, np.int64), regions, judged, variants)
