"""A KATK gassembler workload made from a seed.

``chip_smoke.py`` (its katk phase), ``tools/profile_torch_gassembler.py``
and the tests build their gassembler input here, so the fixture the card
runs is the one the CPU tests rehearse at a smaller size:

    inputs = write_katk_fixture(path, seed)  # reads.fq db.txt regions.txt chr/

Its read index (``db.idx``) comes from ``gmer_counter INDEX_ARGS`` run in
``path``; gassembler then runs with ``ARGS``. ``chip_smoke.py`` builds it
with the port's own gmer_counter on the card and holds its bytes against
the JAX package's host route; the gassembler tests keep the JAX-built
index, and ``tests/test_torch_lookup.py`` runs the chain from the port
alone.
"""

from __future__ import annotations

import os

import numpy as np

REGIONS = 1000       # 200 bp regions (= max_reference_length), 1 kb apart
REGION_BP = 200
SPACING = 1000
READ_BP = 150
FLANK = 150          # reads lie within this many bp of their region
DEPTH = 40           # diploid read depth
DENSE_DEPTH = 120    # the two regions around the oversized one
INDEX_ARGS = ["-db", "db.txt", "--compile_index", "db.idx", "--num_threads",
              "1", "reads.fq"]
ARGS = ["--dbi", "db.idx", "--region_file", "regions.txt", "--num_threads",
        "1", "--coverage", "40", "--sex", "female"]


def write_katk_fixture(path: str, seed: int, n_regions: int = REGIONS):
    """KATK gassembler input in ``path``: reads.fq, db.txt, regions.txt,
    and the chromosome as ``chr/1.fa`` (katk2vcf's ``--chr_dir``).

    One chromosome with ``n_regions`` exome-style regions of 200 bp, 1 kb
    apart, each with anchor 25-mers every 30 bp (as ``bench.py:199-248``).
    Reads of 150 bp come only from each region's window of +-150 bp, at
    40x diploid depth, with 0.2% substitutions and half of them reverse
    complemented. The second haplotype carries a het SNV in every region
    and a het 2 bp deletion in every tenth. The first two regions have 3x
    the depth (more than 200 unique reads each), and an oversized region
    (300 bp, over max_reference_length, with no reads) sits between them.

    Returns, per region, (reference codes int8[200], forward read codes
    int8[B, 150]) with A C G T = 0..3.
    """
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    comp = np.zeros(256, np.uint8)
    comp[alphabet] = np.frombuffer(b"TGCA", np.uint8)
    lut = np.zeros(256, np.int8)
    lut[alphabet] = np.arange(4, dtype=np.int8)
    genome = rng.choice(alphabet, size=(n_regions + 1) * SPACING)
    regions, dblines, fastq, inputs = [], [], [], []

    def add_region(start, length, tag):
        ref = genome[start:start + length]
        kmers = [genome[p:p + 25].tobytes().decode()
                 for p in range(start + 5, start + length - 30, 30)]
        dblines.extend(f"{tag}_{i}\t1\t{km}" for i, km in enumerate(kmers))
        regions.append(f"1\t{start}\t{start + length}\t"
                       f"{ref.tobytes().decode()}\t" + "\t".join(kmers))

    for r in range(n_regions):
        start = SPACING * (r + 1)
        add_region(start, REGION_BP, f"R{r}")
        if r == 0:   # oversized, between the two dense regions
            add_region(start + 450, 300, "O")
        lo, hi = start - FLANK, start + REGION_BP + FLANK
        hap1 = genome[lo:hi]
        hap2 = hap1.copy()
        snv = FLANK + 100
        hap2[snv] = alphabet[(lut[hap2[snv]] + 1) % 4]
        if r % 10 == 0:
            cut = FLANK + 150
            hap2 = np.concatenate([hap2[:cut], hap2[cut + 2:]])
        depth = DENSE_DEPTH if r < 2 else DEPTH
        n_reads = depth * (hi - lo) // READ_BP
        reads = []
        for h, hap in enumerate((hap1, hap2)):
            k = n_reads // 2 + (n_reads % 2) * h
            at = rng.integers(0, len(hap) - READ_BP + 1, k)
            reads.append(hap[at[:, None] + np.arange(READ_BP)])
        reads = np.concatenate(reads)
        err = rng.random(reads.shape) < 0.002
        reads[err] = alphabet[rng.integers(0, 4, int(err.sum()))]
        inputs.append((lut[genome[start:start + REGION_BP]], lut[reads]))
        flip = rng.random(len(reads)) < 0.5
        reads[flip] = comp[reads[flip]][:, ::-1]
        for i, seq in enumerate(reads):
            fastq.append(b"@r%d_%d\n%s\n+\n%s\n" % (
                r, i, seq.tobytes(), b"I" * READ_BP))
    with open(os.path.join(path, "reads.fq"), "wb") as f:
        f.write(b"".join(fastq))
    with open(os.path.join(path, "db.txt"), "w") as f:
        f.write("\n".join(dblines) + "\n")
    with open(os.path.join(path, "regions.txt"), "w") as f:
        f.write("\n".join(regions) + "\n")
    os.makedirs(os.path.join(path, "chr"), exist_ok=True)
    with open(os.path.join(path, "chr", "1.fa"), "wb") as f:
        f.write(b">1\n" + b"".join(genome[i:i + 60].tobytes() + b"\n"
                                   for i in range(0, len(genome), 60)))
    return inputs


LONG_REGIONS = 24        # 200 bp regions, 2 kb apart
LONG_SPACING = 2000
LONG_READ_BP = (1500, 1700)   # read lengths, uniform
LONG_DEPTH = 12          # reads per haplotype covering each region
LONG_ARGS = ARGS + ["--max_read_length", "1600"]


def write_long_read_fixture(path: str, seed: int,
                            n_regions: int = LONG_REGIONS) -> int:
    """A KATK gassembler input with long reads in ``path``: reads.fq,
    db.txt, regions.txt; gassembler then runs with ``LONG_ARGS``.

    ``n_regions`` regions of 200 bp, 2 kb apart, with anchor 25-mers every
    30 bp. Each region is covered by 2 x 12 reads of 1,500-1,700 bp that
    span it whole (so no read reaches a neighbouring region), with 0.2%
    substitutions and half of them reverse complemented; the second
    haplotype carries a het SNV in every region and a het 2 bp deletion in
    every fourth. Reads past 1,600 bp are cut by ``--max_read_length``,
    with a WARNING each. Returns the number of reads.
    """
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    comp = np.zeros(256, np.uint8)
    comp[alphabet] = np.frombuffer(b"TGCA", np.uint8)
    lut = np.zeros(256, np.int8)
    lut[alphabet] = np.arange(4, dtype=np.int8)
    genome = rng.choice(alphabet, size=(n_regions + 1) * LONG_SPACING
                        + LONG_READ_BP[1])
    regions, dblines, fastq = [], [], []
    lo_bp, hi_bp = LONG_READ_BP
    for r in range(n_regions):
        start = LONG_SPACING * (r + 1)
        ref = genome[start:start + REGION_BP]
        kmers = [genome[p:p + 25].tobytes().decode()
                 for p in range(start + 5, start + REGION_BP - 30, 30)]
        dblines.extend(f"L{r}_{i}\t1\t{km}" for i, km in enumerate(kmers))
        regions.append(f"1\t{start}\t{start + REGION_BP}\t"
                       f"{ref.tobytes().decode()}\t" + "\t".join(kmers))
        lo = start + REGION_BP - hi_bp   # every read starts at or after lo
        hap1 = genome[lo:start + hi_bp]
        hap2 = hap1.copy()
        snv = start - lo + 100
        hap2[snv] = alphabet[(lut[hap2[snv]] + 1) % 4]
        if r % 4 == 0:
            cut = start - lo + 150
            hap2 = np.concatenate([hap2[:cut], hap2[cut + 2:]])
        for h, hap in enumerate((hap1, hap2)):
            for i in range(LONG_DEPTH):
                rl = int(rng.integers(lo_bp, hi_bp + 1))
                # the read spans the region: [at, at + rl) covers it whole
                at = int(rng.integers(start - lo + REGION_BP - rl,
                                      start - lo + 1))
                seq = hap[at:at + rl].copy()
                err = rng.random(rl) < 0.002
                seq[err] = alphabet[rng.integers(0, 4, int(err.sum()))]
                if rng.random() < 0.5:
                    seq = comp[seq][::-1]
                fastq.append(b"@l%d_%d_%d\n%s\n+\n%s\n" % (
                    r, h, i, seq.tobytes(), b"I" * rl))
    with open(os.path.join(path, "reads.fq"), "wb") as f:
        f.write(b"".join(fastq))
    with open(os.path.join(path, "db.txt"), "w") as f:
        f.write("\n".join(dblines) + "\n")
    with open(os.path.join(path, "regions.txt"), "w") as f:
        f.write("\n".join(regions) + "\n")
    return len(fastq)
