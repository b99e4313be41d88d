"""A sequenced sample of a genome-shaped source, from a seed: the source
(the reference genome), the sample's genome (the source with point
substitutions, its SNVs) and one FASTQ lane of reads drawn from the
sample's genome, with the lane's reads as 2-bit codes for the reference.

The source and the lane are made as ``wgs_lane``'s (``gen.genome``,
``gen.reads``): the same streams of the seed, the source drawn from stream
0 and the reads from stream 1; the SNVs come from stream 3.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from gt4bench.gen.genome import ALPHABET, codes_of, genome_bases, rng_for
from gt4bench.gen.reads import draw_reads, fastq_bytes, reads_for_lane


@dataclass
class LaneSample:
    source_codes: np.ndarray     # the reference genome, 2-bit codes
    read_codes: np.ndarray       # the lane's reads, uint8[n, L] 2-bit codes
    lane_fq: str                 # the lane's FASTQ file
    snvs: int                    # substitutions made in the sample genome


def substituted(rng: np.random.Generator, bases: np.ndarray,
                share: float) -> tuple[np.ndarray, int]:
    """A copy of ASCII ``bases`` with ``share`` of its positions (drawn
    with repeats) changed to another base, and the number drawn."""
    lut = np.zeros(256, np.uint8)
    lut[ALPHABET] = np.arange(4, dtype=np.uint8)
    out = bases.copy()
    n = int(round(share * len(bases)))
    at = rng.integers(0, len(bases), n)
    out[at] = ALPHABET[(lut[bases[at]] + rng.integers(1, 4, n)) % 4]
    return out, n


def make_lane_sample(seed: int, traffic: dict, workdir: str) -> LaneSample:
    """The traffic mix's source, sample genome and lane (written as
    ``lane.fq`` in ``workdir``) from ``seed``."""
    src = genome_bases(rng_for(seed, 0), int(traffic["source"]["bases"]),
                       traffic["genome"])
    sample, snvs = substituted(rng_for(seed, 3), src,
                               float(traffic["sample_snv"]))
    lane = traffic["lane"]
    n_reads = reads_for_lane(int(lane["bytes"]), int(lane["read_len"]))
    reads = draw_reads(rng_for(seed, 1), sample, n_reads, lane)
    del sample
    path = os.path.join(workdir, "lane.fq")
    fastq_bytes(reads).tofile(path)
    return LaneSample(codes_of(src), codes_of(reads), path, snvs)
