"""Port vs JAX: glistmaker ``--index`` (``make_index``). The port runs on the
CPU (kernel A's plain version, ``device="cpu"``) and on its native host
route (``GT4_TPU_COUNT_IMPL=host``); the JAX package runs both of its
routes (``GT4_TPU_COUNT_IMPL`` = device, host). 1,500-base chunks and
4,001-byte slabs cross chunk seams and slab boundaries. The .index files
must be byte-identical (tolerance 0)."""

import gzip

import numpy as np
import pytest
import torch

from tests.conftest import random_fastq
from genometester4_tpu.formats import index_format as jax_index_format
from genometester4_tpu.pipelines import listmaker as jax_listmaker
from genometester4_tpu_torch.formats import index_format
from genometester4_tpu_torch.pipelines import listmaker as port

torch.set_num_threads(1)

CHUNK, SLAB = 1500, 4001
KS = [1, 8, 16, 25, 31, 32]


@pytest.fixture(params=["device", "host"])
def jax_route(request, monkeypatch):
    """The JAX package's route; the port's device route runs beside it."""
    monkeypatch.setenv("GT4_TPU_MESH", "0")
    return request.param


def _ragged_fasta(rng, n_records=7):
    """Records of 3-5,000 bases (some shorter than any k past 3), N runs of
    5-40 bases, 60-column lines."""
    out = []
    for i in range(n_records):
        n = int(rng.choice([3, 20, 31, 700, 2600, 5000]))
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), n)
        for _ in range(n // 900):
            at = int(rng.integers(0, n))
            seq[at:at + int(rng.integers(5, 40))] = ord("N")
        s = seq.tobytes().decode()
        out.append(f">rec{i} desc\n"
                   + "".join(s[j:j + 60] + "\n" for j in range(0, n, 60)))
    return "".join(out)


def _both(tmp_path, monkeypatch, route, paths, k, **kw):
    """The JAX package on ``route`` and the port's device route on the CPU
    with the same arguments; both files' bytes."""
    paths = [str(p) for p in paths]
    jax_out, port_out = tmp_path / "jax.index", tmp_path / "port.index"
    monkeypatch.setenv("GT4_TPU_COUNT_IMPL", route)
    jax_listmaker.make_index(paths, k, str(jax_out), chunk_bases=CHUNK,
                             slab_bytes=SLAB, **kw)
    monkeypatch.delenv("GT4_TPU_COUNT_IMPL")
    port.make_index(paths, k, str(port_out), chunk_bases=CHUNK,
                    slab_bytes=SLAB, device="cpu", **kw)
    return jax_out.read_bytes(), port_out.read_bytes()


@pytest.mark.parametrize("k", KS)
def test_fasta_byte_identical(tmp_path, monkeypatch, jax_route, k):
    rng = np.random.default_rng(100 + k)
    fa = tmp_path / "in.fa"
    fa.write_text(_ragged_fasta(rng))
    a, b = _both(tmp_path, monkeypatch, jax_route, [fa], k)
    assert len(b) > 200 and a == b


def test_fastq_gz_and_two_files_byte_identical(tmp_path, monkeypatch,
                                               jax_route):
    """FASTQ, a gzipped FASTA (its registry records the on-disk size), and
    both as two files of one index."""
    rng = np.random.default_rng(7)
    fq = tmp_path / "in.fq"
    fq.write_text(random_fastq(rng, n_records=80, read_len=90, n_prob=0.02))
    gz = tmp_path / "in.fa.gz"
    gz.write_bytes(gzip.compress(_ragged_fasta(rng).encode()))
    for paths in ([fq], [gz], [gz, fq]):
        a, b = _both(tmp_path, monkeypatch, jax_route, paths, 21)
        assert len(b) > 200 and a == b


@pytest.mark.parametrize("min_count,max_count", [(2, 0xFFFFFFFF), (2, 5),
                                                 (1, 3)])
def test_cutoffs_byte_identical(tmp_path, monkeypatch, jax_route, min_count,
                                max_count):
    """-c/--max drop words from the k-mer block but keep every location
    (the reference's cutoff bug): repeats give counts above 1."""
    rng = np.random.default_rng(min_count * 10 + max_count % 7)
    seg = rng.choice(list("ACGT"), 300)
    fa = tmp_path / "in.fa"
    fa.write_text("".join(
        f">r{i}\n" + "".join(seg[rng.integers(0, 250):]) + "\n"
        for i in range(6)))
    a, b = _both(tmp_path, monkeypatch, jax_route, [fa], 12,
                 min_count=min_count, max_count=max_count)
    assert len(b) > 200 and a == b


@pytest.mark.parametrize("text", [">a\nACG\n>b\nNNNNNNNNNNNNNNN\n", ">a\n\n"])
def test_zero_words_header_only(tmp_path, monkeypatch, jax_route, text):
    fa = tmp_path / "in.fa"
    fa.write_text(text)
    a, b = _both(tmp_path, monkeypatch, jax_route, [fa], 5)
    assert len(b) == 72 and a == b
    im = index_format.read_index_map(str(tmp_path / "port.index"))
    assert len(im.words) == 0 and im.word_length == 5


@pytest.mark.parametrize("k", [8, 25, 32])
def test_port_host_route_byte_identical(tmp_path, monkeypatch, k):
    """The port's native host route against the JAX package's host route,
    over FASTA and FASTQ in one index."""
    rng = np.random.default_rng(k)
    fa = tmp_path / "in.fa"
    fa.write_text(_ragged_fasta(rng))
    fq = tmp_path / "in.fq"
    fq.write_text(random_fastq(rng, n_records=40, read_len=70, n_prob=0.02))
    monkeypatch.setenv("GT4_TPU_COUNT_IMPL", "host")
    paths = [str(fa), str(fq)]
    jax_listmaker.make_index(paths, k, str(tmp_path / "jax.index"),
                             slab_bytes=SLAB)
    port.make_index(paths, k, str(tmp_path / "port.index"),
                    slab_bytes=SLAB)
    a = (tmp_path / "jax.index").read_bytes()
    assert len(a) > 200 and (tmp_path / "port.index").read_bytes() == a


def test_forward_windows_match_jax_canonical_pair():
    """The chunk step's canonical words and directions against JAX's
    ``canonical_pair`` on the forward windows, palindromes included."""
    from genometester4_tpu.ops.encode import canonical_pair, join_u64
    from genometester4_tpu.ops.kmers import extract_kmers
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, 4096).astype(np.uint8)
    codes[100:108] = [0, 1, 2, 3, 0, 1, 2, 3]   # ACGTACGT: a palindrome
    codes[rng.random(4096) < 0.02] = 255
    for k in (4, 8, 32):
        fhi, flo, valid = extract_kmers(codes, k, canonical=False)
        chi, clo = canonical_pair(fhi, flo, k)
        want_rc = ~((np.asarray(chi) == np.asarray(fhi))
                    & (np.asarray(clo) == np.asarray(flo)))
        can, is_rc, pvalid = port.forward_windows(torch.from_numpy(codes), k)
        v = np.asarray(valid)
        n = len(v)
        assert np.array_equal(pvalid.numpy()[:n], v)
        assert not pvalid.numpy()[n:].any()
        assert np.array_equal(can.numpy().view(np.uint64)[:n][v],
                              join_u64(chi, clo)[v])
        assert np.array_equal(is_rc.numpy()[:n][v], want_rc[v])
    assert not is_rc.numpy()[100]   # the palindrome reads forward


def test_read_index_map_round_trip(tmp_path, monkeypatch):
    """The port's reader on the port's file against the JAX package's
    reader: header fields, files block, k-mer block, locations, counts."""
    rng = np.random.default_rng(9)
    fa = tmp_path / "in.fa"
    fa.write_text(_ragged_fasta(rng))
    fq = tmp_path / "in.fq"
    fq.write_text(random_fastq(rng, n_records=30, read_len=60))
    path = str(tmp_path / "port.index")
    port.make_index([str(fa), str(fq)], 13, path, chunk_bases=CHUNK,
                    slab_bytes=SLAB, device="cpu", min_count=2)
    a = index_format.read_index_map(path)
    b = jax_index_format.read_index_map(path)
    for f in ("word_length", "n_file_bits", "n_subseq_bits", "n_pos_bits",
              "num_locations", "version_major", "version_minor"):
        assert getattr(a, f) == getattr(b, f)
    for f in ("words", "loc_start", "counts", "locations", "kmer_recs"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    assert len(a.files) == 2
    for fa_, fb_ in zip(a.files, b.files):
        assert (fa_.name, fa_.size) == (fb_.name, fb_.size)
        assert np.array_equal(fa_.subseqs, fb_.subseqs)
    fil, seq, pos, dirs = a.decode_locations(a.locations)
    assert set(np.unique(fil)) <= {0, 1} and dirs.max() <= 1
    # writing the map back gives the same bytes
    index_format.write_index_file(
        str(tmp_path / "again.index"), a.word_length, a.files, a.words,
        a.loc_start, a.num_locations, a.locations, a.n_file_bits,
        a.n_subseq_bits, a.n_pos_bits)
    assert (tmp_path / "again.index").read_bytes() == open(path, "rb").read()
    assert index_format.get_bitsize(0) == 1
    assert index_format.get_bitsize(255) == 8
