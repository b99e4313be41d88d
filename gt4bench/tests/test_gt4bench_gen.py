"""The generators: the same seed gives the same inputs, every seed the
same sizes."""

import numpy as np
import pytest

from gt4bench.gen.genome import codes_of, fasta_bytes, genome_bases, rng_for
from gt4bench.gen.markers import canonical_np, draw_markers
from gt4bench.gen.reads import (draw_reads, fastq_bytes, reads_for_lane,
                                record_bytes)
from gt4bench.tests.tiny import GENOME

SEEDS = [0, 7, (1 << 31) + 5, (1 << 40) + 3]


@pytest.mark.parametrize("seed", SEEDS)
def test_genome_is_the_seeds(seed):
    a = genome_bases(rng_for(seed, 0), 25_000, GENOME)
    b = genome_bases(rng_for(seed, 0), 25_000, GENOME)
    c = genome_bases(rng_for(seed + 1, 0), 25_000, GENOME)
    assert a.shape == (25_000,) and np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert set(np.unique(a).tolist()) <= set(b"ACGT")


def test_genome_gc_follows_its_isochores():
    p = {**GENOME, "repeat_families": 0, "gc": [0.6, 0.6]}
    b = genome_bases(rng_for(3, 0), 200_000, p)
    gc = np.isin(b, np.frombuffer(b"GC", np.uint8)).mean()
    assert abs(gc - 0.6) < 0.01


def test_fasta_lines():
    b = genome_bases(rng_for(1, 0), 1001, GENOME)
    text = fasta_bytes(b"x", b, 60)
    lines = text.split(b"\n")
    assert lines[0] == b">x" and all(len(ln) == 60 for ln in lines[1:17])
    assert b"".join(lines[1:]) == b.tobytes()


@pytest.mark.parametrize("seed", SEEDS)
def test_lane_fills_its_bytes(seed):
    src = genome_bases(rng_for(seed, 0), 20_000, GENOME)
    n = reads_for_lane(100_000, 150)
    reads = draw_reads(rng_for(seed, 1), src, n,
                       {"read_len": 150, "substitution": 0.002,
                        "rc_share": 0.5})
    fq = fastq_bytes(reads)
    assert fq.size == n * record_bytes(n, 150) <= 100_000
    assert (n + 1) * record_bytes(n + 1, 150) > 100_000
    again = draw_reads(rng_for(seed, 1), src, n,
                       {"read_len": 150, "substitution": 0.002,
                        "rc_share": 0.5})
    assert np.array_equal(reads, again)
    recs = fq.tobytes().split(b"\n")
    assert recs[0] == b"@r" + b"0" * len(str(n - 1))
    assert recs[1] == reads[0].tobytes() and recs[2] == b"+"


def test_full_lane_is_one_slab_of_857k_reads():
    n = reads_for_lane(1 << 28, 150)
    assert n == 857_621
    assert n * record_bytes(n, 150) <= 1 << 28


@pytest.mark.parametrize("seed", SEEDS)
def test_markers_are_unique_and_sized(seed):
    src = codes_of(genome_bases(rng_for(seed, 0), 40_000, GENOME))
    p = {"markers": 4000, "genome_bp": 160_000, "word_length": 25}
    m, n_on = draw_markers(rng_for(seed, 2), src, p, "cpu")
    m2, _ = draw_markers(rng_for(seed, 2), src, p, "cpu")
    assert m.shape == (4000, 2) and np.array_equal(m, m2)
    assert n_on == 1000
    can, _ = canonical_np(m.reshape(-1), 25)
    assert len(np.unique(can)) == can.size
    # REF and ALT differ in the middle base alone
    diff = m[:, 0] ^ m[:, 1]
    assert np.all(diff >> np.uint64(24) <= 3) and np.all(diff != 0)
    assert np.all(diff & np.uint64((1 << 24) - 1) == 0)


def test_canonical_np_matches_base_by_base():
    rng = np.random.default_rng(4)
    w = rng.integers(0, 1 << 50, 1000, dtype=np.uint64)
    can, rc_taken = canonical_np(w, 25)
    for x, c, t in zip(w[:50].tolist(), can[:50].tolist(),
                       rc_taken[:50].tolist()):
        rc = 0
        y = x
        for _ in range(25):
            rc = (rc << 2) | (3 - (y & 3))
            y >>= 2
        assert c == min(x, rc) and t == (rc < x)
