"""Small copies of the cells for the CPU tests: the same generators,
drivers, reference and comparison, at sizes a test run holds."""

from __future__ import annotations

GENOME = {"isochore_bp": 1000, "gc": [0.2, 0.8], "repeat_families": 3,
          "family_bp": [50, 300], "copies": [3, 30], "copy_mutation": 0.01}

OVERRIDES = {
    "glistmaker.chr22": {
        "traffic": {"genomes": {"count": 1, "bases": 30000,
                                "line_width": 60}, "genome": GENOME},
        # several chunks and slabs, so the merge runs
        "config": {"chunk_bases": 8192, "slab_bytes": 1 << 14}},
    "glistmaker.bacteria": {
        "traffic": {"genomes": {"count": 3, "bases": 5000,
                                "line_width": 80}, "genome": GENOME}},
    "glistmaker.chr22x4": {
        "traffic": {"genomes": {"count": 1, "bases": 30000,
                                "line_width": 60}, "genome": GENOME},
        "mesh_devices": ["cpu"] * 4},
    "gmer_counter.wgs": {
        "traffic": {"source": {"bases": 30000}, "genome": GENOME,
                    "lane": {"bytes": 200000, "read_len": 150,
                             "substitution": 0.002, "rc_share": 0.5}},
        "config": {"db": {"markers": 3000, "kmers_per_marker": 2,
                          "genome_bp": 180000},
                   "chunk_bases": 16384, "slab_bytes": 1 << 16}},
}

SEED = (1 << 31) + 12345


def run(name: str, trace: bool = False, seconds: float = 0.2,
        seed: int = SEED) -> dict:
    from gt4bench import manifest
    from gt4bench.run import run_cell
    return run_cell(manifest.cell(name), seed, seconds, trace,
                    device="cpu", overrides=OVERRIDES[name],
                    log=lambda s: None)
