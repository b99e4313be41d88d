"""The plain reference agrees with the port's plain CPU route
(``device="cpu"``) on a small genome, and on a small lane and database."""

import os

import numpy as np
import pytest
import torch

from gt4bench.drivers.gmer_counter import Driver as CountDriver
from gt4bench.gen.genome import codes_of, fasta_bytes, genome_bases, rng_for
from gt4bench.reference.kmers import (canonical_windows, genome_list,
                                      lane_counts, list_file)
from gt4bench.tests.tiny import GENOME, OVERRIDES


@pytest.mark.parametrize("seed", [1, (1 << 31) + 9])
@pytest.mark.parametrize("chunk", [1 << 25, 4096])
def test_reference_list_is_the_ports_file(tmp_path, seed, chunk):
    from genometester4_tpu_torch.pipelines.listmaker import make_list
    bases = genome_bases(rng_for(seed, 0), 20_000, GENOME)
    fa = tmp_path / "g.fa"
    fa.write_bytes(fasta_bytes(b"g", bases, 60))
    out = tmp_path / "g.list"
    make_list([str(fa)], 25, str(out), chunk_bases=chunk, device="cpu")
    data = out.read_bytes()
    words, counts = genome_list(codes_of(bases), 25, "cpu")
    hdr, crc, n = list_file(words, counts, 25, block=1000)
    import zlib
    assert data[:48] == hdr and zlib.crc32(data[48:]) == crc
    assert len(data) == 48 + 12 * n


def test_canonical_windows_base_by_base():
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, 60).astype(np.uint8)
    got = canonical_windows(torch.from_numpy(codes), 25).tolist()
    for i, g in enumerate(got):
        w = rc = 0
        for j in range(25):
            w = (w << 2) | int(codes[i + j])
            rc |= (3 - int(codes[i + j])) << (2 * j)
        assert g == min(w, rc)


@pytest.mark.parametrize("seed", [3, (1 << 31) + 11])
def test_reference_counts_are_the_ports(tmp_path, seed):
    over = OVERRIDES["gmer_counter.wgs"]
    from gt4bench import manifest
    cell = manifest.cell("gmer_counter.wgs")
    d = CountDriver(cell.config, cell.traffic, seed, "cpu", str(tmp_path),
                    over)
    d.make_inputs()
    counter = d._counter(d._db())
    counter.add_file(d.lane, int(d.cfg["slab_bytes"]))
    counter.add_file(d.lane, int(d.cfg["slab_bytes"]))
    counter.finalize()
    got = counter.result.clamped(16)
    want = d.expected(2, 65535)
    assert want.sum() > 0 and np.array_equal(got, want)
    per = lane_counts(d.read_codes, d.markers.reshape(-1), 25, "cpu",
                      block_rows=7)
    assert np.array_equal(per * 2, want)
    assert os.path.getsize(d.lane) <= over["traffic"]["lane"]["bytes"]
