"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one.

This file imports neither jax nor the test conftest, so on a machine
with a GPU and no JAX it runs as
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py``.
"""

import os

import numpy as np
import pytest
import torch

from genometester4_tpu_torch.ops import encode as tenc
from genometester4_tpu_torch.ops.extract_cuda import extract_kmers_cuda
from genometester4_tpu_torch.ops.kmers import extract_kmers
from genometester4_tpu_torch.ops.merge_runs import (merge_runs,
                                                    merge_sorted_runs)
from genometester4_tpu_torch.ops.merge_runs_cuda import merge_runs_cuda
from genometester4_tpu_torch.ops.runmarks_cuda import run_encode_cuda
from genometester4_tpu_torch.ops.sortcount import count_unique, run_encode
from genometester4_tpu_torch.ops.swalign import sw_fill
from genometester4_tpu_torch.ops.swalign_cuda import (
    sw_fill_lanes_cuda, sw_fill_shared_cuda, sw_matrices_batch_device,
    sw_pallas_matrices)
from genometester4_tpu_torch.utils import trace


pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _codes(seed, n):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    codes[rng.integers(0, max(n, 1), size=n // 50)] = 255
    return torch.from_numpy(codes)


@pytest.mark.parametrize("n", [1, 31, 257, 100_003])
@pytest.mark.parametrize("k", [1, 5, 16, 17, 25, 31, 32])
def test_extract_kernel_equals_plain(cuda, k, n):
    codes = _codes(k * 7 + n, n)
    for canonical in (True, False):
        keys_c, valid_c = extract_kmers_cuda(codes.to(cuda), k, canonical)
        keys_p, valid_p = extract_kmers(codes, k, canonical)
        torch.cuda.synchronize()
        assert torch.equal(keys_c.cpu(), keys_p)
        assert (valid_c is None) == (valid_p is None) == (k < 32)
        if valid_c is not None:
            assert torch.equal(valid_c.cpu(), valid_p)


EXTRACT_TILE = 4096   # windows per block of kernel A (csrc/extract.cu)


@pytest.mark.parametrize("k", [1, 5, 16, 17, 25, 31, 32])
def test_extract_kernel_tile_edges_and_unaligned_codes(cuda, k):
    """Kernel A at n = tile - 1, tile, tile + 1, tile + k - 1 and 2^25,
    both canonical modes, and on codes 1, 7 and 15 bytes past a 16-byte
    boundary (contiguous slices of one tensor)."""
    full = _codes(k, (1 << 25) + 16).to(cuda)
    for n in (EXTRACT_TILE - 1, EXTRACT_TILE, EXTRACT_TILE + 1,
              EXTRACT_TILE + k - 1, 1 << 25):
        for off in (0, 1, 7, 15):
            if n == 1 << 25 and off not in (0, 1):
                continue
            codes = full[off:off + n]
            assert codes.is_contiguous() and codes.data_ptr() % 16 == off
            for canonical in (True, False):
                keys_c, valid_c = extract_kmers_cuda(codes, k, canonical)
                keys_p, valid_p = extract_kmers(codes, k, canonical)
                torch.cuda.synchronize()
                assert torch.equal(keys_c, keys_p), (n, off, canonical)
                if k == 32:
                    assert torch.equal(valid_c, valid_p), (n, off)


RUN_TILE = 4096   # keys per tile of kernel B (csrc/runmarks.cu)


def _run_stream(kind, word_bits, seed):
    """Sorted keys (CPU) of one of kernel B's edge streams."""
    rng = np.random.default_rng(seed)
    T = RUN_TILE

    def runs(lengths):
        words = np.unique(rng.integers(0, 2 ** word_bits - 1,
                                       size=2 * len(lengths),
                                       dtype=np.uint64, endpoint=True))
        return tenc.keys_from_u64(np.repeat(words[:len(lengths)], lengths))

    if kind == "empty":
        return torch.zeros(0, dtype=torch.int64)
    if kind == "every slot invalid":
        return torch.full((3 * T + 5,), tenc.flag_key(word_bits))
    if kind == "one word over 2^25":
        return runs([1 << 25])
    if kind == "every key distinct":
        return runs(np.ones(5 * T + 7, np.int64))
    if kind == "runs ending on and past tile edges":
        return runs([T, T + 1, T - 1, 1, 2 * T - 1, 1, T, 3, T - 3] * 3)
    # "random" (n not a multiple of the tile): ~30% repeats, 10% invalid
    n = 1_000_003
    words = np.sort(rng.integers(0, 2 ** word_bits - 1, n, dtype=np.uint64,
                                 endpoint=True))
    dup = rng.random(n) < 0.3
    words[dup] = words[np.maximum(np.flatnonzero(dup) - 1, 0)]
    keys = tenc.keys_from_u64(np.sort(words))
    if word_bits < 64:
        keys[int(n * 0.9):] = tenc.flag_key(word_bits)
    return keys


RUN_KINDS = ["random", "empty", "every slot invalid", "one word over 2^25",
             "every key distinct", "runs ending on and past tile edges",
             "keys 8 bytes past 16"]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind,word_bits", [
    (kind, bits) for kind in RUN_KINDS for bits in (50, 64)
    if (kind, bits) != ("every slot invalid", 64)])   # 64 bits: none is
def test_run_marks_kernel_equals_plain(cuda, kind, word_bits, weighted):
    """Kernel B equals run_encode bit for bit: unique keys, counts (u32
    weights that wrap), n_unique, total and checksum."""
    keys = _run_stream("random" if kind.startswith("keys 8") else kind,
                       word_bits, RUN_KINDS.index(kind)).to(cuda)
    if kind.startswith("keys 8"):
        buf = torch.empty(keys.numel() + 1, dtype=torch.int64, device=cuda)
        buf[1:] = keys
        keys = buf[1:]
        assert keys.data_ptr() % 16 == 8
    w = None
    if weighted:
        w = torch.randint(0, 1 << 32, keys.shape, device=cuda,
                          generator=torch.Generator(cuda).manual_seed(7))
    got = run_encode_cuda(keys, w, word_bits)
    want = run_encode(keys, w, word_bits)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2:] == want[2:]


@pytest.mark.parametrize("weighted", [False, True])
def test_count_unique_cuda_equals_cpu(cuda, weighted):
    rng = np.random.default_rng(9)
    n = 300_000
    words = rng.integers(0, 2 ** 50, n, dtype=np.uint64)
    words[rng.random(n) < 0.4] = words[0]
    keys = tenc.keys_from_u64(words)
    keys[rng.random(n) < 0.1] = tenc.flag_key(50)
    w = (torch.from_numpy(rng.integers(0, 2 ** 32, n, dtype=np.int64))
         if weighted else None)
    before = trace.total("launch.run_encode")
    got = count_unique(keys.to(cuda), None if w is None else w.to(cuda), 50)
    want = count_unique(keys, w, 50)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert got[2] == want[2]
    assert trace.total("launch.run_encode") == before + 1


def test_make_list_cuda_equals_cpu(cuda, tmp_path):
    from genometester4_tpu_torch.pipelines.listmaker import make_list
    rng = np.random.default_rng(4)
    seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), 50_000,
                     p=[0.24, 0.25, 0.25, 0.25, 0.01])
    fa = tmp_path / "in.fa"
    fa.write_bytes(b">a\n" + seq[:30_000].tobytes() + b"\n>b\n"
                   + seq[30_000:].tobytes() + b"\n")
    for k in (16, 25, 32):
        before = (trace.total("launch.extract"),
                  trace.total("launch.run_encode"),
                  trace.total("list.records_whole"))
        hdr = make_list([str(fa)], k, str(tmp_path / "g.list"),
                        chunk_bases=1 << 14, device="cuda")
        make_list([str(fa)], k, str(tmp_path / "c.list"), chunk_bases=1 << 14,
                  device="cpu")
        assert ((tmp_path / "g.list").read_bytes()
                == (tmp_path / "c.list").read_bytes())
        assert trace.total("launch.extract") > before[0]
        assert trace.total("launch.run_encode") > before[1]
        assert (trace.total("list.records_whole") - before[2]
                == 2 * hdr.n_words)


def test_to_host_cuda_equals_cpu(cuda):
    """The pack step on the card: the CPU's records and total, copied back
    at 12 bytes a record ("copy.d2h_bytes")."""
    from genometester4_tpu_torch.formats.list_format import raw_record_view
    from genometester4_tpu_torch.pipelines.listmaker import to_host
    rng = np.random.default_rng(6)
    for n in (1, 3, 100_003):
        keys = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, n,
                                             dtype=np.int64))
        counts = torch.from_numpy(rng.integers(0, 1 << 33, n,
                                               dtype=np.int64))
        counts[0] = 0xFFFFFFFF
        want = to_host(keys, counts)
        d2h = trace.total("copy.d2h_bytes")
        got = to_host(keys.cuda(), counts.cuda())
        assert trace.total("copy.d2h_bytes") - d2h == 12 * n
        assert (raw_record_view(*got).tobytes()
                == raw_record_view(*want).tobytes())
        assert got.total == want.total


def test_wrappers_reject_bad_tensors(cuda):
    codes = torch.zeros(64, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        extract_kmers_cuda(codes[::2], 5)
    with pytest.raises(ValueError, match="uint8"):
        extract_kmers_cuda(codes.to(torch.int32), 5)
    keys = torch.zeros(64, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        run_encode_cuda(keys[::2])
    with pytest.raises(ValueError, match="int64"):
        run_encode_cuda(keys.to(torch.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        run_encode_cuda(keys.cpu())
    with pytest.raises(ValueError, match="shape"):
        run_encode_cuda(keys, keys[:63])
    with pytest.raises(ValueError, match="CUDA tensor"):
        run_encode_cuda(keys, keys.cpu())
    # 2^31 keys (16 GiB, never written): past kernel B's int32 positions
    with pytest.raises(ValueError, match="at most"):
        run_encode_cuda(torch.empty(1 << 31, dtype=torch.int64, device=cuda))


def _sw_inputs(seed, B, n, m):
    """Codes with 2% N, reads padded with 6 past a random length, per-lane
    reference lengths from -1 to n + 2 (out of range clamps), the first
    lane 0 and the second n + 5 where there are three or more."""
    rng = np.random.default_rng(seed)
    refs = rng.integers(0, 4, (B, n)).astype(np.int8)
    refs[rng.random((B, n)) < 0.02] = 4
    reads = rng.integers(0, 4, (B, m)).astype(np.int8)
    reads[rng.random((B, m)) < 0.02] = 4
    mlen = rng.integers(0, m + 1, B)
    reads[np.arange(m)[None, :] >= mlen[:, None]] = 6
    nvec = rng.integers(-1, n + 3, B).astype(np.int32)
    if B >= 3:
        nvec[:2] = [0, n + 5]
    return (torch.from_numpy(refs), torch.from_numpy(reads),
            torch.from_numpy(nvec))


def _wrap_inputs():
    """Two reads whose best paths open gaps longer than 127."""
    rng = np.random.default_rng(127)
    ref = rng.integers(0, 4, 300).astype(np.int8)
    reads = np.stack([np.concatenate([ref[:140], rng.integers(0, 4, 160)]),
                      np.concatenate([rng.integers(0, 4, 10), ref[:150],
                                      rng.integers(0, 4, 140)])])
    return torch.from_numpy(ref), torch.from_numpy(reads.astype(np.int8))


def _assert_sw_equal(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("B,n,m", [
    (1, 1, 1), (1, 200, 152), (31, 41, 33), (33, 1, 17), (70, 17, 1),
    (130, 64, 100), (512, 200, 152), (3, 0, 5), (4, 9, 0),
    (40, 37, 31), (40, 37, 32), (40, 37, 63), (40, 37, 65), (40, 70, 95),
    (40, 70, 97), (9, 45, 255), (9, 45, 256), (9, 45, 257), (3, 20, 1471),
    (3, 20, 1472), (3, 20, 1473), (5, 40, 2000), (3, 30, 4000),
    (3, 600, 300), (2000, 200, 152)])
def test_sw_lanes_kernel_equals_plain(cuda, B, n, m):
    """Kernel C against sw_fill: n or m of 0 or 1, m one less and one more
    than a multiple of 32 (a lane's strip of columns ends inside the read
    or past it), m one less, equal to and one more than a 256-column slab,
    reads of up to 4,000 columns (16 slabs), a reference of 600 rows with
    two slabs (the boundary in the scratch tensor), lanes of reference
    length 0 and past n_cap, B not a multiple of 32, the gassembler window
    shape and a window of 2,000 reads."""
    refs, reads, nvec = _sw_inputs(B * 7 + n + m, B, n, m)
    got = sw_fill_lanes_cuda(refs.to(cuda), reads.to(cuda), nvec.to(cuda))
    _assert_sw_equal(got, sw_fill(refs, reads, nvec))


@pytest.mark.parametrize("B,n,m", [
    (1, 1, 1), (31, 41, 33), (33, 1, 17), (70, 17, 1), (2, 0, 5), (3, 9, 0),
    (5, 7, 1023), (5, 7, 1024), (3, 30, 1500), (2, 20, 4000), (1, 200, 150),
    (127, 200, 150), (128, 200, 150), (129, 200, 150), (2000, 200, 150),
    (6, 600, 300), (2, 17000, 40)])
def test_sw_shared_kernel_equals_plain(cuda, B, n, m):
    """Kernel D against sw_fill with one reference for all reads: widths
    past one 256-column slab up to 4,000, B that leaves the last block of
    four reads short, n = 0, a reference of 600 rows with two slabs (the
    boundary in the scratch tensor) and one of 17,000 rows (read from
    device memory, not staged)."""
    refs, reads, _ = _sw_inputs(B * 11 + n + m, B, n, m)
    ref = refs[0] if B else torch.zeros(n, dtype=torch.int8)
    got = sw_fill_shared_cuda(ref.to(cuda), reads.to(cuda))
    want = sw_fill(ref.expand(B, -1), reads,
                   torch.full((B,), n, dtype=torch.int32))
    _assert_sw_equal(got, want)


def test_sw_kernels_int8_gap_length_wrap(cuda):
    ref, reads = _wrap_inputs()
    refs = ref.expand(2, -1)
    nvec = torch.full((2,), 300, dtype=torch.int32)
    want = sw_fill(refs, reads, nvec)
    assert int(want[1].min()) == -128 and int(want[2].min()) == -128
    _assert_sw_equal(sw_fill_lanes_cuda(refs.contiguous().to(cuda),
                                        reads.to(cuda), nvec.to(cuda)), want)
    _assert_sw_equal(sw_fill_shared_cuda(ref.to(cuda), reads.to(cuda)), want)


def test_sw_lanes_kernel_past_width_limit(cuda):
    """Kernel C has no width limit: reads of 1,473 columns (one past its
    earlier 32 x 46) equal sw_fill."""
    refs, reads, nvec = _sw_inputs(1473, 4, 10, 1473)
    got = sw_fill_lanes_cuda(refs.to(cuda), reads.to(cuda), nvec.to(cuda))
    _assert_sw_equal(got, sw_fill(refs, reads, nvec))


def test_sw_kernels_gap_wrap_across_slab_boundary(cuda):
    """A read that matches the reference for 300 columns and then leaves a
    left gap of more than 200: its length wraps as int8 and is carried over
    the slab boundary at column 512."""
    rng = np.random.default_rng(512)
    ref = torch.from_numpy(rng.integers(0, 4, 310).astype(np.int8))
    reads = torch.from_numpy(np.stack([
        np.concatenate([ref.numpy()[:300], rng.integers(0, 4, 400)]),
        rng.integers(0, 4, 700)]).astype(np.int8))
    refs = ref.expand(2, -1).contiguous()
    nvec = torch.full((2,), 310, dtype=torch.int32)
    want = sw_fill(refs, reads, nvec)
    assert int(want[1][0, 300, 512]) > 0   # -length, wrapped
    _assert_sw_equal(sw_fill_lanes_cuda(refs.to(cuda), reads.to(cuda),
                                        nvec.to(cuda)), want)
    _assert_sw_equal(sw_fill_shared_cuda(ref.to(cuda), reads.to(cuda)), want)


def test_sw_entries_wide_reads(cuda):
    """Kernel D's entry (sw_pallas_matrices) equals kernel C's
    (sw_matrices_batch_device) for a region with 2,000-column reads."""
    rng = np.random.default_rng(2000)
    ref = rng.integers(0, 5, 150).astype(np.int8)
    reads = rng.integers(0, 5, (12, 2000)).astype(np.int8)
    reads[1::2, 1500:] = 6
    before = (trace.total("launch.sw_lanes"), trace.total("launch.sw_shared"))
    got = sw_pallas_matrices(ref, reads, device="cuda")
    want = sw_matrices_batch_device(ref, reads, device="cuda")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert (trace.total("launch.sw_lanes"),
            trace.total("launch.sw_shared")) == (before[0] + 1, before[1] + 1)


def test_sw_wrappers_reject_bad_tensors(cuda):
    refs = torch.zeros((4, 10), dtype=torch.int8, device=cuda)
    reads = torch.zeros((4, 8), dtype=torch.int8, device=cuda)
    nvec = torch.full((4,), 10, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        sw_fill_lanes_cuda(refs[:, ::2], reads, nvec)
    with pytest.raises(ValueError, match="int8"):
        sw_fill_lanes_cuda(refs.to(torch.int16), reads, nvec)
    with pytest.raises(ValueError, match="int32"):
        sw_fill_lanes_cuda(refs, reads, nvec.to(torch.int64))
    with pytest.raises(ValueError, match="batch sizes"):
        sw_fill_lanes_cuda(refs, reads[:3], nvec)
    with pytest.raises(ValueError, match="one device"):
        sw_fill_lanes_cuda(refs, reads, nvec.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        sw_fill_shared_cuda(refs[0, ::2], reads)
    with pytest.raises(ValueError, match="1-D int8"):
        sw_fill_shared_cuda(refs, reads)
    with pytest.raises(ValueError, match="CUDA"):
        sw_fill_shared_cuda(refs[0].cpu(), reads.cpu())


def test_gassembler_cuda_equals_cpu(cuda, tmp_path):
    """The port's gassembler on CUDA (kernel C) and on the CPU (sw_fill)
    over the KATK fixture of chip_smoke.py at 12 regions: same stdout and
    stderr, kernel C launched in fewer launches than regions."""
    import contextlib
    import io

    from chip_smoke import reference_cli
    from genometester4_tpu_torch.cli.gassembler import main
    from genometester4_tpu_torch.tools import katk_fixture as kf

    kf.write_katk_fixture(str(tmp_path), seed=8, n_regions=12)
    # the read index: the JAX package's gmer_counter host route (no jax)
    r, _ = reference_cli(tmp_path, "gmer_counter", kf.INDEX_ARGS,
                         GT4_TPU_COUNT_IMPL="host")
    assert r.returncode == 0, r.stderr
    results = {}
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        for device in ("cuda", "cpu"):
            before = trace.total("launch.sw_lanes")
            out, err = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = main(kf.ARGS, device=device)
            results[device] = (rc, out.getvalue(), err.getvalue(),
                               trace.total("launch.sw_lanes") - before)
    finally:
        os.chdir(old)
        (tmp_path / "db.idx").unlink()
    assert results["cuda"][:3] == results["cpu"][:3]
    assert results["cuda"][0] == 0 and results["cpu"][3] == 0
    assert 0 < results["cuda"][3] < 13


def _gmer_inputs(path, k, seed):
    """db.txt (nodes of a genome word and its alt allele, and the word 0)
    and reads.fq (100 bp reads, a third reverse complemented, every
    seventh with an N, a tenth over a poly-A run) in ``path``."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    comp = np.zeros(256, np.uint8)
    comp[acgt] = np.frombuffer(b"TGCA", np.uint8)
    g = rng.choice(acgt, 20_000)
    g[500:560] = ord("A")
    lines = [f"ZERO\t1\t{'A' * k}"]
    for i in range(50):
        p = int(rng.integers(0, len(g) - k))
        w = bytearray(g[p:p + k].tobytes())
        alt = bytearray(w)
        alt[k // 2] = b"ACGT"[(b"ACGT".index(alt[k // 2]) + 1) % 4]
        lines.append(f"S{i}\t2\t{w.decode()}\t{alt.decode()}")
    (path / "db.txt").write_text("\n".join(lines) + "\n")
    recs = []
    for r in range(400):
        p = 480 + r % 40 if r % 10 == 0 else int(rng.integers(0, 19_900))
        s = g[p:p + 100].copy()
        if r % 3 == 0:
            s = comp[s][::-1]
        if r % 7 == 0:
            s[int(rng.integers(0, 100))] = ord("N")
        recs.append(b"@r%d\n%s\n+\n%s\n" % (r, s.tobytes(), b"I" * 100))
    (path / "reads.fq").write_bytes(b"".join(recs))


@pytest.mark.parametrize("k", [25, 32])
def test_gmer_counter_cuda_equals_cpu(cuda, tmp_path, monkeypatch, k):
    """gmer_counter on CUDA (kernel A, torch.sort, torch.searchsorted) and
    on the CPU (their plain versions): the same count-mode stdout with
    --stats, and the same --compile_index stdout and index bytes; kernel
    A's launch counter moves on CUDA only."""
    import contextlib
    import filecmp
    import io

    from genometester4_tpu_torch.cli.gmer_counter import main

    _gmer_inputs(tmp_path, k, seed=k)
    monkeypatch.delenv("GT4_TPU_COUNT_IMPL", raising=False)
    monkeypatch.chdir(tmp_path)
    results = {}
    try:
        for device in ("cuda", "cpu"):
            before = trace.total("launch.extract")
            runs = []
            for args in (["-db", "db.txt", "--stats", "--total", "reads.fq"],
                         ["-db", "db.txt", "--compile_index", f"{device}.idx",
                          "--verbose", "reads.fq"]):
                out, err = io.StringIO(), io.StringIO()
                with contextlib.redirect_stdout(out), \
                        contextlib.redirect_stderr(err):
                    rc = main(args, device=device)
                runs.append((rc, out.getvalue(), err.getvalue()))
            results[device] = (runs, trace.total("launch.extract") - before)
        assert filecmp.cmp("cuda.idx", "cpu.idx", shallow=False)
    finally:
        for device in ("cuda", "cpu"):
            (tmp_path / f"{device}.idx").unlink(missing_ok=True)
    assert results["cuda"][0] == results["cpu"][0]
    rc, out, _ = results["cuda"][0][0]
    assert rc == 0 and int(out.split("#LIST_KMERS\t")[1].split("\n")[0]) > 0
    assert results["cuda"][1] >= 2 and results["cpu"][1] == 0


def _genome_fasta(path, seed, n=30_000):
    """Three records with N runs, a repeated segment and a record shorter
    than 25."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    g = rng.choice(acgt, n)
    g[7000:7400] = g[100:500]
    g[9000:9030] = ord("N")
    recs = [g[:12_000].tobytes(), g[12_000:12_010].tobytes(),
            g[12_010:].tobytes()]
    path.write_bytes(b"".join(
        b">r%d\n" % i + b"".join(r[j:j + 80] + b"\n"
                                for j in range(0, len(r), 80))
        for i, r in enumerate(recs)))


@pytest.mark.parametrize("k", [12, 25, 32])
def test_make_index_cuda_equals_cpu(cuda, tmp_path, k):
    """make_index on CUDA (kernel A forward, canonical, nonzero
    compaction) over several 2^12-base chunks: the same .index bytes as
    on the CPU; kernel A launches on CUDA only."""
    from genometester4_tpu_torch.pipelines.listmaker import make_index

    _genome_fasta(tmp_path / "g.fa", seed=k)
    out = {}
    for device in ("cuda", "cpu"):
        before = trace.total("launch.extract")
        make_index([str(tmp_path / "g.fa")], k, str(tmp_path / device),
                   chunk_bases=1 << 12, slab_bytes=10_001, device=device,
                   min_count=2)
        out[device] = ((tmp_path / device).read_bytes(),
                       trace.total("launch.extract") - before)
    assert out["cuda"][0] == out["cpu"][0] and len(out["cpu"][0]) > 1000
    assert out["cuda"][1] > 3 and out["cpu"][1] == 0


def _word_lists(seed, n_lists=3, n=50_000, wrap=False):
    rng = np.random.default_rng(seed)
    base = np.unique(rng.integers(0, 1 << 50, n).astype(np.uint64))
    out = []
    for _ in range(n_lists):
        keep = rng.random(len(base)) < 0.6
        c = rng.integers(1, 9, keep.sum()).astype(np.uint32)
        if wrap:
            c[rng.random(len(c)) < 0.3] = 0xFFFFFFF9
        out.append((base[keep], c))
    return out


@pytest.mark.parametrize("wrap", [False, True])
def test_setops_cuda_equal_cpu(cuda, wrap):
    """pair_align, apply_pair_op (every op, rules add/max/number/subtract,
    -du) and apply_multi_op (every multi rule) on CUDA against the CPU;
    with ``wrap``, counts whose sums wrap as u32."""
    from genometester4_tpu_torch.ops import setops

    def on(dev, w, c):
        return (tenc.keys_from_u64(w).to(dev),
                torch.from_numpy(c.astype(np.int64)).to(dev))

    (w1, c1), (w2, c2), (w3, c3) = _word_lists(3 + wrap, wrap=wrap)
    got = {}
    for dev in ("cuda", "cpu"):
        al = setops.pair_align(*on(dev, w1, c1), *on(dev, w2, c2))
        res = [a.cpu() for a in al]
        for op in ("union", "intrsec", "diff1", "diff2"):
            for rule, sub in (("default", False), ("default", True),
                              ("add", False), ("max", False),
                              ("number", False), ("subtract", False)):
                res += [a.cpu() for a in setops.apply_pair_op(
                    *al, op=op, rule=rule, cutoff=2, count_override=3,
                    subtract=sub)]
        keys, counts = on(dev, np.concatenate([w1, w2, w3]),
                          np.concatenate([c1, c2, c3]))
        for op in ("union", "intrsec"):
            for rule in ("default", "add", "min", "max", "number"):
                res += [a.cpu() for a in setops.apply_multi_op(
                    keys, counts, 3, op, rule, cutoff=2, count_override=4)]
        got[dev] = res
    assert len(got["cuda"]) == len(got["cpu"])
    for a, b in zip(got["cuda"], got["cpu"]):
        assert torch.equal(a, b)
    if wrap:
        assert any((t < 0xFFFFFFF0).all() and t.numel() for t in got["cpu"])


def test_list_clis_cuda_equal_cpu(cuda, tmp_path):
    """Both list CLIs with device="cuda" and device="cpu": glistmaker .list
    (kernels A and B) and --index (kernel A), then glistcompare on two
    lists (compare_pair) and on three sources with an .index
    (compare_multi): the same rc, stdout, stderr and files."""
    import contextlib
    import io

    from genometester4_tpu_torch.cli.glistcompare import main as compare
    from genometester4_tpu_torch.cli.glistmaker import main as maker

    _genome_fasta(tmp_path / "g.fa", seed=1)
    _genome_fasta(tmp_path / "h.fa", seed=2)
    runs = [(maker, ["../g.fa", "-w", "21", "-o", "g"]),
            (maker, ["../h.fa", "-w", "21", "-o", "h"]),
            (maker, ["../g.fa", "-w", "21", "-o", "g", "--index"]),
            (compare, ["g_21.list", "h_21.list", "-u", "-i", "-d", "-dd"]),
            (compare, ["g_21.list", "h_21.list", "g_21.index", "-u", "-o",
                       "m"])]
    got = {}
    for device in ("cuda", "cpu"):
        d = tmp_path / device
        d.mkdir()
        old = os.getcwd()
        os.chdir(d)
        before = (trace.total("launch.extract"),
                  trace.total("launch.run_encode"))
        outs = []
        try:
            for main, args in runs:
                out, err = io.StringIO(), io.StringIO()
                with contextlib.redirect_stdout(out), \
                        contextlib.redirect_stderr(err):
                    rc = main(args, device=device)
                outs.append((rc, out.getvalue(), err.getvalue()))
        finally:
            os.chdir(old)
        files = {p.name: p.read_bytes() for p in d.iterdir()}
        got[device] = (outs, files,
                       (trace.total("launch.extract") - before[0],
                        trace.total("launch.run_encode") - before[1]))
    assert got["cuda"][:2] == got["cpu"][:2]
    assert all(rc == 0 for rc, _, _ in got["cpu"][0])
    assert len(got["cpu"][1]) == 8
    assert min(got["cuda"][2]) > 0 and got["cpu"][2] == (0, 0)


def _query_list(path, k, seed, n=200_000):
    from genometester4_tpu_torch.formats.list_format import write_list
    rng = np.random.default_rng(seed)
    top = (1 << (2 * k)) - 1
    w = np.unique(np.concatenate([
        rng.integers(0, top, n, dtype=np.uint64, endpoint=True),
        np.array([0, top], np.uint64)]))
    c = rng.integers(1, 1000, len(w)).astype(np.uint32)
    c[::101] = 0xFFFFFFFF
    write_list(str(path), k, w, c)
    return w, c


@pytest.mark.parametrize("k", [12, 25, 32])
def test_listquery_lookup_cuda_equals_cpu(cuda, tmp_path, k):
    """ListQuery.lookup_device on the card against the CPU torch lookup
    and the host route: word 0, the largest word, k = 32 words with bit
    63 set, absent queries, several chunks."""
    from genometester4_tpu_torch.pipelines.listquery import ListQuery
    w, c = _query_list(tmp_path / "t.list", k, k)
    rng = np.random.default_rng(k + 1)
    q = np.concatenate([w[rng.permutation(len(w))[:150_000]],
                        rng.integers(0, (1 << (2 * k)) - 1, 100_000,
                                     dtype=np.uint64, endpoint=True),
                        w[[0, -1]]])
    got = ListQuery(str(tmp_path / "t.list"), "cuda").lookup_device(
        q, chunk=1 << 16)
    cpu = ListQuery(str(tmp_path / "t.list"), "cpu")
    assert np.array_equal(got, cpu.lookup_device(q))
    assert np.array_equal(got, cpu.lookup_host(q))
    assert got[-2:].tolist() == [c[0], c[-1]]


def test_glistquery_cuda_equals_cpu(cuda, tmp_path):
    """The glistquery CLI with device="cuda" and device="cpu": -s (kernel
    A's launch counter moves on the card only), -s with -mm 1, -l, -f and
    a two-list dump; the same rc, stdout and stderr, also in -s chunks of
    5,000 codes."""
    import contextlib
    import io

    from genometester4_tpu_torch.cli.glistquery import main
    from genometester4_tpu_torch.pipelines import listmaker, listquery
    _genome_fasta(tmp_path / "g.fa", seed=3, n=200_000)
    _genome_fasta(tmp_path / "h.fa", seed=3, n=60_000)   # g's first 60 kb
    for name in ("g", "h"):
        listmaker.make_list([str(tmp_path / f"{name}.fa")], 25,
                            str(tmp_path / f"{name}_25.list"), device="cpu")
    rng = np.random.default_rng(5)
    (tmp_path / "q.txt").write_text("".join(
        "".join(rng.choice(list("ACGT"), 25)) + "\n" for _ in range(6000)))
    runs = [["g_25.list", "-s", "h.fa"],
            ["g_25.list", "-s", "h.fa", "-mm", "1", "-min", "1"],
            ["g_25.list", "-l", "h_25.list"],
            ["g_25.list", "-f", "q.txt"],
            ["g_25.list", "h_25.list"]]
    got = {}
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        for device, chunk in (("cuda", 1 << 25), ("cpu", 1 << 25),
                              ("cuda", 5000)):
            listquery.SEARCH_CHUNK = chunk
            outs, launches = [], []
            for args in runs:
                before = trace.total("launch.extract")
                out, err = io.StringIO(), io.StringIO()
                with contextlib.redirect_stdout(out), \
                        contextlib.redirect_stderr(err):
                    rc = main(args, device=device)
                outs.append((rc, out.getvalue(), err.getvalue()))
                launches.append(trace.total("launch.extract") - before)
            got[device, chunk] = (outs, launches)
    finally:
        listquery.SEARCH_CHUNK = 1 << 25
        os.chdir(old)
    cpu = got["cpu", 1 << 25]
    assert all(rc == 0 and out.count("\n") > 100 for rc, out, _ in cpu[0])
    assert got["cuda", 1 << 25][0] == cpu[0] == got["cuda", 5000][0]
    assert got["cuda", 1 << 25][1][:2] == [1, 1]
    assert got["cuda", 5000][1][0] > 10
    assert cpu[1] == [0] * 5


@pytest.mark.parametrize("pB", [0.0, 0.29, 1.0])
@pytest.mark.parametrize("case", [{}, {"size": -5.0},
                                  {"p0": 0.5, "p1": 0.4, "p2": 0.3}])
def test_genotype_batch_cuda_bit_equal_native(cuda, pB, case):
    """The posterior fan-out on the card, bit-equal to the native batch on
    all three arrays (float64 as uint64 bits), counts 0 to 65,535, in
    several chunks; the best-only copy back too."""
    from genometester4_tpu_torch.models import fastgt_native as native
    from genometester4_tpu_torch.models.genotype import (
        genotype_batch_device, genotype_best_device)
    params = np.array([0.0547219, 4.2603e-05, 0.014934, 0.985023, 30.0,
                       65.48, -0.6792684], np.float32)
    for i, name in enumerate(("err", "p0", "p1", "p2", "lam", "size",
                              "size2")):
        if name in case:
            params[i] = case[name]
    rng = np.random.default_rng(len(case))
    counts = rng.integers(0, 200, 2 * 300_000).astype(np.uint16)
    counts[:2000] = rng.integers(0, 65536, 2000)
    counts[2000:2004] = [0, 0, 65535, 65535]
    a, s, b = native.genotype_batch(counts, pB, params)
    a2, s2, b2 = genotype_batch_device(counts, pB, params, "cuda",
                                       chunk=100_000)
    assert np.array_equal(a.view(np.uint64), a2.view(np.uint64))
    assert np.array_equal(s.view(np.uint64), s2.view(np.uint64))
    assert np.array_equal(b, b2)
    top, s3, b3 = genotype_best_device(counts, pB, params, "cuda")
    assert np.array_equal(top.view(np.uint64),
                          a[np.arange(len(b)), b].view(np.uint64))
    assert np.array_equal(s3.view(np.uint64), s.view(np.uint64))
    assert np.array_equal(b3, b)


def _sorted_runs(cuda, seed, n, L, card, sentinel_tails=False):
    """int64 keys in [-card, card) sorted within each length-L run; with
    ``sentinel_tails`` each run ends in INT64_MAX from a random point."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    keys = torch.randint(-card, card, (n // L, L), generator=gen,
                         device=cuda, dtype=torch.int64)
    if sentinel_tails:
        start = torch.randint(0, L + 1, (n // L, 1), generator=gen,
                              device=cuda)
        tail = torch.arange(L, device=cuda)[None, :] >= start
        keys = keys.masked_fill(tail, (1 << 63) - 1)
    return torch.sort(keys, dim=1).values.view(-1)


@pytest.mark.parametrize("L,n", [(1, 2), (1, 1 << 16), (3, 6000),
                                 (100, 2200), (1000, 8000), (1024, 2048),
                                 (1024, 1 << 20), (3000, 3 * (1 << 14)),
                                 (4096, 1 << 15), (1 << 20, 1 << 22),
                                 (1 << 25, 1 << 26)])
@pytest.mark.parametrize("card", [1, 5, 1 << 62])
def test_merge_runs_kernel_equals_plain(cuda, L, n, card):
    """Kernel E against merge_runs (a stable sort of each 2L span), keys and
    positions bit for bit: L = 1, 2L below the 2048-slot tile (a tile spans
    several pairs), L not a power of two (tiles cross spans), L up to 2^25,
    all-equal keys (card 1) and ties (card 5)."""
    keys = _sorted_runs(cuda, L + n + card, n, L, card)
    got = merge_runs_cuda(keys, L)
    want = merge_runs(keys, L)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("L,n", [(512, 1 << 14), (1 << 23, 1 << 26),
                                 (1 << 25, 1 << 27)])
def test_merge_runs_kernel_sentinel_tails_and_int32_positions(cuda, L, n):
    """INT64_MAX tails (the mesh merge's padding) and n up to 2^27."""
    keys = _sorted_runs(cuda, n, n, L, 1 << 40, sentinel_tails=True)
    got = merge_runs_cuda(keys, L)
    want = merge_runs(keys, L)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1].max()) == n - 1


MERGE_TILE = 3840   # output slots per tile of kernel E (csrc/merge_runs.cu)


@pytest.mark.parametrize("L,n", [
    (MERGE_TILE // 2 - 1, 4 * (MERGE_TILE // 2 - 1)),
    (MERGE_TILE // 2, 6 * MERGE_TILE), (MERGE_TILE, 4 * MERGE_TILE),
    (MERGE_TILE + 1, 6 * (MERGE_TILE + 1)), (3 * MERGE_TILE - 7,
                                             2 * (3 * MERGE_TILE - 7)),
    (1 << 16, 1 << 20), (99_999, 8 * 99_999)])
@pytest.mark.parametrize("card", [1, 5, 1 << 62])
@pytest.mark.parametrize("offset", [0, 1])
def test_merge_runs_kernel_tile_edges(cuda, L, n, card, offset):
    """Kernel E at L below, equal to and above its tile, odd L (tiles
    crossing spans), all-equal keys (card 1), ties (card 5), INT64_MAX
    tails, and keys 8 bytes past a 16-byte boundary (offset 1): keys,
    positions and a gathered payload equal merge_runs."""
    buf = torch.zeros(n + 1, dtype=torch.int64, device=cuda)
    keys = buf[offset:offset + n]
    keys.copy_(_sorted_runs(cuda, L + n + card, n, L, card,
                            sentinel_tails=card > 5))
    assert keys.is_contiguous() and keys.data_ptr() % 16 == 8 * offset
    got = merge_runs_cuda(keys, L)
    want = merge_runs(keys, L)
    payload = torch.arange(n, device=cuda) * 7 + 3
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(payload[got[1]], payload[want[1]])


def test_merge_sorted_runs_cuda_payloads_equal_cpu(cuda):
    rng = np.random.default_rng(5)
    n, L = 1 << 16, 1 << 12
    keys = np.sort(rng.integers(0, 50, (n // L, L)), axis=1).ravel()
    keys = torch.from_numpy(keys)
    p64 = torch.from_numpy(rng.integers(0, 1 << 62, n))
    p32 = torch.from_numpy(rng.integers(0, 1 << 31, n).astype(np.int32))
    before = trace.total("launch.merge_runs")
    got = merge_sorted_runs((keys.to(cuda), p64.to(cuda), p32.to(cuda)), L)
    want = merge_sorted_runs((keys, p64, p32), L)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    assert trace.total("launch.merge_runs") == before + 1


def test_merge_wrappers_reject_bad_tensors(cuda):
    keys = torch.arange(64, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        merge_runs_cuda(keys.cpu(), 4)
    with pytest.raises(ValueError, match="int64"):
        merge_runs_cuda(keys.to(torch.int32), 4)
    with pytest.raises(ValueError, match="contiguous"):
        merge_runs_cuda(keys.view(32, 2)[:, 0], 4)
    with pytest.raises(ValueError, match="multiple of 2L"):
        merge_runs_cuda(keys, 3)
    with pytest.raises(ValueError, match="not sorted"):
        merge_sorted_runs((keys.flip(0),), 4)
    with pytest.raises(ValueError, match="payloads"):
        merge_sorted_runs((keys, keys.cpu()), 4)


@pytest.mark.parametrize("mode", ["resort", "bitonic"])
def test_count_kmers_sharded_cuda_equals_cpu(cuda, monkeypatch, mode):
    """8 slots on one card equal 8 cpu slots; kernel E runs in bitonic mode
    only, kernels A and B in both."""
    from genometester4_tpu_torch.parallel.sharding import (
        count_kmers_sharded, make_mesh)
    monkeypatch.setenv("GT4_TPU_MESH_MERGE", mode)
    codes = _codes(17, 300_000).numpy()
    before = (trace.total("launch.extract"), trace.total("launch.run_encode"),
              trace.total("launch.merge_runs"))
    got = count_kmers_sharded(codes, 25, make_mesh(
        8, dp=2, devices=["cuda:0"] * 8), chunk_bases=1 << 15)
    after = (trace.total("launch.extract"), trace.total("launch.run_encode"),
             trace.total("launch.merge_runs"))
    want = count_kmers_sharded(codes, 25, make_mesh(
        8, dp=2, devices=["cpu"] * 8), chunk_bases=1 << 15)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert after[0] > before[0] and after[1] > before[1]
    assert (after[2] > before[2]) == (mode == "bitonic")


@pytest.fixture
def cards(cuda):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two or more CUDA cards, found {n}")
    return [f"cuda:{i}" for i in range(n)]


@pytest.mark.parametrize("mode", ["resort", "bitonic"])
def test_mesh_across_cards_equals_cpu(cards, monkeypatch, mode):
    """Slots on different cards: the exchange makes peer copies, each
    column merges on its own card; equal to 8 cpu slots."""
    from genometester4_tpu_torch.parallel.sharding import (
        count_kmers_sharded, make_mesh)
    monkeypatch.setenv("GT4_TPU_MESH_MERGE", mode)
    codes = _codes(23, 400_000).numpy()
    slots = (cards * 8)[:8]
    got = count_kmers_sharded(codes, 25, make_mesh(8, dp=2, devices=slots),
                              chunk_bases=1 << 15)
    want = count_kmers_sharded(codes, 25, make_mesh(
        8, dp=2, devices=["cpu"] * 8), chunk_bases=1 << 15)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_make_list_default_mesh_across_cards(cards, tmp_path, monkeypatch):
    """More than one card: make_list on CUDA takes the mesh by default (JAX's
    rule), GT4_TPU_MESH=0 opts out; both write the CPU route's bytes."""
    from genometester4_tpu_torch.parallel import sharding
    from genometester4_tpu_torch.pipelines.listmaker import make_list
    rng = np.random.default_rng(6)
    seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), 200_000,
                     p=[0.24, 0.25, 0.25, 0.25, 0.01])
    fa = tmp_path / "in.fa"
    fa.write_bytes(b">a\n" + seq.tobytes() + b"\n")
    make_list([str(fa)], 25, str(tmp_path / "cpu.list"), device="cpu")
    made = []
    real = sharding.make_mesh
    monkeypatch.setattr(sharding, "make_mesh",
                        lambda *a, **k: made.append(real(*a, **k)) or made[-1])
    make_list([str(fa)], 25, str(tmp_path / "mesh.list"), device="cuda")
    assert len(made) == 1
    assert {d for row in made[0].devices for d in row} == {
        torch.device(c) for c in cards}
    monkeypatch.setenv("GT4_TPU_MESH", "0")
    make_list([str(fa)], 25, str(tmp_path / "one.list"), device="cuda")
    assert len(made) == 1
    want = (tmp_path / "cpu.list").read_bytes()
    assert (tmp_path / "mesh.list").read_bytes() == want
    assert (tmp_path / "one.list").read_bytes() == want


def test_compare_default_mesh_across_cards(cards, tmp_path, monkeypatch):
    """More than one card: compare_pair and compare_multi on CUDA take the
    mesh of every card by default, their buckets dealt over the cards and
    run side by side; the files equal the CPU route's, and every card
    aligns or reduces some bucket."""
    from genometester4_tpu_torch.formats.list_format import write_list
    from genometester4_tpu_torch.ops import setops
    from genometester4_tpu_torch.pipelines import listcompare
    paths = []
    for i, (w, c) in enumerate(_word_lists(11, wrap=True)):
        paths.append(str(tmp_path / f"l{i}_25.list"))
        write_list(paths[-1], 25, w, c)
    seen = set()
    align, multi = setops.pair_align, setops.apply_multi_op
    monkeypatch.setattr(setops, "pair_align", lambda *a: seen.add(
        a[0].device) or align(*a))
    monkeypatch.setattr(setops, "apply_multi_op", lambda keys, *a, **kw:
                        seen.add(keys.device) or multi(keys, *a, **kw))
    ops = ["union", "intrsec", "diff1", "diff2"]
    files = {}
    for dev in ("cuda", "cpu"):
        d = tmp_path / dev
        d.mkdir()
        listcompare.compare_pair(paths[0], paths[1], ops, str(d / "p"),
                                 rule="add", bucket_target=4096, device=dev)
        for op in ("union", "intrsec"):
            listcompare.compare_multi(paths, op, str(d / f"m{op}"), cutoff=2,
                                      bucket_target=4096, device=dev)
        files[dev] = {p.name: p.read_bytes() for p in d.iterdir()}
    assert len(files["cpu"]) == 6 and files["cuda"] == files["cpu"]
    assert {torch.device(c) for c in cards} <= seen


@pytest.mark.parametrize("k", [25, 32])
def test_gmer_counter_default_mesh_across_cards(cards, tmp_path, monkeypatch,
                                                k):
    """More than one card: gmer_counter's count mode on CUDA deals its
    chunks over every card by default (kernel A once a chunk), and prints
    what the CPU route prints."""
    import contextlib
    import io

    from genometester4_tpu_torch.cli.gmer_counter import main
    from genometester4_tpu_torch.pipelines import gmercount

    class Small(gmercount.DBCounter):
        def __init__(self, db, **kw):
            super().__init__(db, chunk_bases=4096, **kw)
    seen = []
    count_step = gmercount.count_step
    monkeypatch.setattr(gmercount, "DBCounter", Small)
    monkeypatch.setattr(gmercount, "count_step", lambda codes, *a: seen.append(
        codes.device) or count_step(codes, *a))
    _gmer_inputs(tmp_path, k, seed=k + 1)
    monkeypatch.delenv("GT4_TPU_COUNT_IMPL", raising=False)
    monkeypatch.chdir(tmp_path)
    runs = {}
    for device in ("cuda", "cpu"):
        seen.clear()
        before = trace.total("launch.extract")
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(["-db", "db.txt", "--stats", "--total", "reads.fq"],
                      device=device)
        runs[device] = (rc, out.getvalue(), err.getvalue())
        if device == "cuda":
            assert trace.total("launch.extract") - before == len(seen) >= 8
            assert {d for d in seen} == {torch.device(c) for c in cards}
    assert runs["cuda"] == runs["cpu"] and runs["cpu"][0] == 0


def _group_inputs(path):
    """A 400 kbp FASTA, two 25-mer lists (counts that wrap under ADD) and
    gmer_counter's database and reads in ``path``; each CLI's argv."""
    from genometester4_tpu_torch.formats.list_format import write_list
    rng = np.random.default_rng(31)
    seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), 400_000,
                     p=[0.24, 0.25, 0.25, 0.25, 0.01])
    (path / "in.fa").write_bytes(b">a\n" + seq.tobytes() + b"\n")
    lists = []
    for i, (w, c) in enumerate(_word_lists(32, n_lists=2, wrap=True)):
        lists.append(str(path / f"l{i}_25.list"))
        write_list(lists[-1], 25, w, c)
    _gmer_inputs(path, 25, seed=33)
    return {"glistmaker": [str(path / "in.fa"), "-w", "25", "-o", "g"],
            "glistcompare": lists + ["-u", "-i", "-d", "-dd", "-o", "c"],
            "gmer_counter": ["-db", str(path / "db.txt"), "--stats",
                             str(path / "reads.fq")]}


@pytest.mark.parametrize("nprocs,across", [(2, False), (2, True),
                                           (4, True)],
                         ids=["one_card_2", "cards_2", "cards_4"])
def test_group_equals_one_process(cuda, tmp_path, monkeypatch, nprocs,
                                  across):
    """glistmaker, glistcompare and gmer_counter on a process group
    (``parallel.multihost``), each process on its own card
    (CUDA_VISIBLE_DEVICES; NCCL) or every process on card 0 (gloo, staged
    through pinned memory): process 0's files and stdout equal one
    process's on one card, the others print nothing, and kernels A and B
    launch in every process."""
    import contextlib
    import io

    from genometester4_tpu_torch.cli import (glistcompare, glistmaker,
                                             gmer_counter)
    from genometester4_tpu_torch.tools.group_run import launch
    if across and torch.cuda.device_count() < nprocs:
        pytest.skip(f"needs {nprocs} CUDA cards, found "
                    f"{torch.cuda.device_count()}")
    mains = {"glistmaker": glistmaker.main, "glistcompare": glistcompare.main,
             "gmer_counter": gmer_counter.main}
    monkeypatch.setenv("GT4_TPU_MESH", "0")
    for tool, argv in _group_inputs(tmp_path).items():
        one, grp = tmp_path / f"{tool}_one", tmp_path / f"{tool}_group"
        one.mkdir()
        grp.mkdir()
        monkeypatch.chdir(one)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert mains[tool](argv, device="cuda") == 0
        monkeypatch.chdir(tmp_path)
        spec = {"tool": tool, "argv": argv,
                "chunk_bases": 4096 if tool == "gmer_counter" else None}
        envs = [{"CUDA_VISIBLE_DEVICES": str(i if across else 0)}
                for i in range(nprocs)]
        res = launch([spec] * nprocs, [str(grp)] * nprocs, envs,
                     timeout=600)
        for rank, (rc, o, e, rep) in enumerate(res):
            assert rc == 0, f"{tool} process {rank}: {e[-3000:]}"
            assert rep["transport"] == ("nccl" if across else "gloo")
            if tool != "glistcompare":
                assert rep["launches"]["extract"] > 0, (tool, rank)
            if tool == "glistmaker":
                assert rep["launches"]["run_marks"] > 0, rank
            assert rank == 0 or o == b""
        assert res[0][1].decode() == out.getvalue(), tool
        want = {p.name: p.read_bytes() for p in one.iterdir()}
        assert {p.name: p.read_bytes() for p in grp.iterdir()} == want
        assert len(want) == {"glistmaker": 1, "glistcompare": 4,
                             "gmer_counter": 0}[tool]
