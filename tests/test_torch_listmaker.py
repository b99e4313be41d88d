"""Port vs JAX: glistmaker's device counting route end to end. The port
runs on the CPU (its kernels' plain versions); the JAX package runs its
device route (``GT4_TPU_COUNT_IMPL=device``) without the mesh
(``GT4_TPU_MESH=0``). The .list files must be byte-identical."""

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.conftest import random_fasta, random_fastq
from genometester4_tpu.pipelines import listmaker as jax_listmaker
from genometester4_tpu_torch.formats.list_format import (RECORD_DTYPE,
                                                         pack_records,
                                                         raw_record_view,
                                                         read_list,
                                                         write_list)
from genometester4_tpu_torch.ops.encode import keys_from_u64
from genometester4_tpu_torch.pipelines import listmaker as port
from genometester4_tpu_torch.utils import trace

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SMALL_CHUNK = 1 << 12   # several chunks, so the weighted merge runs


@pytest.fixture
def jax_device_route(monkeypatch):
    monkeypatch.setenv("GT4_TPU_COUNT_IMPL", "device")
    monkeypatch.setenv("GT4_TPU_MESH", "0")


def _both(tmp_path, paths, k, **kw):
    """Run both packages with the same arguments; return both files' bytes.
    Every record of the port's file reaches its writer as a slice of the
    records copied back (the counter "list.records_whole")."""
    paths = [str(p) for p in paths]
    jax_listmaker.make_list(paths, k, str(tmp_path / "jax.list"), **kw)
    whole = trace.total("list.records_whole")
    hdr = port.make_list(paths, k, str(tmp_path / "port.list"), device="cpu",
                         **kw)
    assert trace.total("list.records_whole") - whole == hdr.n_words
    return ((tmp_path / "jax.list").read_bytes(),
            (tmp_path / "port.list").read_bytes())


def _repeat_fasta(rng, n_records=4, length=3000):
    """Records assembled from a few shared segments: counts well above 1."""
    segs = [rng.choice(list("ACGT"), 120) for _ in range(6)]
    out = []
    for i in range(n_records):
        parts = [segs[j] for j in rng.integers(0, len(segs), length // 120)]
        seq = "".join("".join(p) for p in parts)
        out.append(f">r{i}\n" + "\n".join(
            seq[j:j + 70] for j in range(0, len(seq), 70)) + "\n")
    return "".join(out)


@pytest.mark.parametrize("k", [4, 16, 17, 25, 32])
def test_multi_chunk_fasta_byte_identical(tmp_path, jax_device_route, k):
    rng = np.random.default_rng(k)
    fa = tmp_path / "in.fa"
    fa.write_text(random_fasta(rng, n_records=5, min_len=200, max_len=6000,
                               n_prob=0.01))
    a, b = _both(tmp_path, [fa], k, chunk_bases=SMALL_CHUNK)
    assert len(b) > 48 and a == b


@pytest.mark.parametrize("k", [16, 25])
def test_one_chunk_byte_identical(tmp_path, jax_device_route, k):
    """One chunk a file: its shard is written as it came back, whole."""
    rng = np.random.default_rng(40 + k)
    fa = tmp_path / "in.fa"
    fa.write_text(random_fasta(rng, n_records=3, min_len=500, max_len=4000,
                               n_prob=0.01))
    a, b = _both(tmp_path, [fa], k)
    assert len(b) > 48 and a == b


def test_multi_file_and_fastq_byte_identical(tmp_path, jax_device_route):
    rng = np.random.default_rng(11)
    fq = tmp_path / "in.fq"
    fq.write_text(random_fastq(rng, n_records=150, read_len=100,
                               n_prob=0.02))
    fa = tmp_path / "in.fa"
    fa.write_text(random_fasta(rng, n_records=3, min_len=500, max_len=3000))
    a, b = _both(tmp_path, [fq], 25, chunk_bases=SMALL_CHUNK)
    assert len(b) > 48 and a == b
    a, b = _both(tmp_path, [fa, fq], 25, chunk_bases=SMALL_CHUNK)
    assert a == b


def test_spill_path_byte_identical(tmp_path, jax_device_route, monkeypatch,
                                   capfd):
    """A tiny spill budget sends counted shards through tmp .list files;
    the env knob GT4_SPILL_BYTES does the same. Debug phase lines report
    the same words and uniques as the JAX package's."""
    rng = np.random.default_rng(5)
    fa = tmp_path / "in.fa"
    fa.write_text(random_fasta(rng, n_records=3, min_len=8000,
                               max_len=12000, n_prob=0.005))
    a, b = _both(tmp_path, [fa], 16, chunk_bases=SMALL_CHUNK,
                 spill_bytes=1 << 14, debug=1)
    assert a == b
    err = capfd.readouterr().err.splitlines()
    words_lines = [ln for ln in err if ln.startswith("Words ")]
    assert len(words_lines) == 2 and words_lines[0] == words_lines[1]
    monkeypatch.setenv("GT4_SPILL_BYTES", str(1 << 14))
    port.make_list([str(fa)], 16, str(tmp_path / "env.list"),
                   chunk_bases=SMALL_CHUNK, device="cpu")
    assert (tmp_path / "env.list").read_bytes() == a


@pytest.mark.parametrize("min_count,max_count", [(2, 0xFFFFFFFF), (2, 5),
                                                 (1, 3)])
def test_cutoffs_byte_identical(tmp_path, jax_device_route, min_count,
                                max_count):
    rng = np.random.default_rng(min_count * 10 + max_count % 7)
    fa = tmp_path / "in.fa"
    fa.write_text(_repeat_fasta(rng))
    a, b = _both(tmp_path, [fa], 12, chunk_bases=SMALL_CHUNK,
                 min_count=min_count, max_count=max_count)
    assert len(b) > 48 and a == b


def test_non_canonical_byte_identical(tmp_path, jax_device_route):
    rng = np.random.default_rng(21)
    fa = tmp_path / "in.fa"
    fa.write_text(random_fasta(rng, n_records=2, min_len=2000, max_len=5000,
                               n_prob=0.01))
    a, b = _both(tmp_path, [fa], 21, chunk_bases=SMALL_CHUNK,
                 canonical=False)
    assert len(b) > 48 and a == b


def test_device_resolution():
    from genometester4_tpu_torch.utils.device import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)


def test_port_never_imports_jax(tmp_path):
    rng = np.random.default_rng(3)
    fa = tmp_path / "in.fa"
    fa.write_text(random_fasta(rng, n_records=2, min_len=300, max_len=900))
    out = tmp_path / "o.list"
    code = (
        "import sys\n"
        "from genometester4_tpu_torch.pipelines.listmaker import make_list\n"
        "import genometester4_tpu_torch.ops.extract_cuda\n"
        "import genometester4_tpu_torch.ops.runmarks_cuda\n"
        "import genometester4_tpu_torch.ops.merge_runs_cuda\n"
        "from genometester4_tpu_torch.parallel.sharding import make_mesh\n"
        f"h = make_list([{str(fa)!r}], 16, {str(out)!r}, device='cpu')\n"
        "assert h.n_words > 0\n"
        f"m = make_list([{str(fa)!r}], 16, {str(out)!r}, device='cpu',\n"
        "              mesh=make_mesh(4, devices=['cpu'] * 4))\n"
        "assert m == h\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert r.returncode == 0, r.stderr
    assert out.stat().st_size > 48


def _records(rng, n):
    recs = np.empty(n, RECORD_DTYPE)
    recs["word"] = np.sort(rng.integers(0, 1 << 62, n, dtype=np.uint64))
    recs["count"] = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    return recs


# words, counts -> None, or the record slice (start, stop) they are
RECORD_VIEWS = {
    "whole": (lambda r: (r["word"], r["count"]), (0, 50)),
    "prefix": (lambda r: (r["word"][:20], r["count"][:20]), (0, 20)),
    "part_way": (lambda r: (r["word"][7:31], r["count"][7:31]), (7, 31)),
    "words_alone": (lambda r: (r["word"][7:31], None), (7, 31)),
    "empty": (lambda r: (r["word"][9:9], r["count"][9:9]), (9, 9)),
    "separate": (lambda r: (r["word"].copy(), r["count"].copy()), None),
    "counts_elsewhere": (lambda r: (r["word"][7:31], r["count"][8:32]),
                         None),
    "other_records": (lambda r: (r["word"], r[::-1].copy()["count"]), None),
    "strided": (lambda r: (r["word"][::2], r["count"][::2]), None),
    "bytes_as_words": (lambda r: (r.view(np.uint8)[:400].view(np.uint64),
                                  None), None),
}


@pytest.mark.parametrize("case", sorted(RECORD_VIEWS))
def test_raw_record_view(case):
    """A word (and count) view of one record array gives exactly its
    records' bytes, wherever it starts in the buffer; separate arrays, a
    count field that is not 8 bytes after the word and a slice that is not
    contiguous records give None."""
    recs = _records(np.random.default_rng(9), 50)
    fields, want = RECORD_VIEWS[case]
    words, counts = fields(recs)
    raw = raw_record_view(words, counts)
    if want is None:
        assert raw is None
        return
    lo, hi = want
    assert raw is not None and raw.dtype == np.uint8
    assert raw.tobytes() == recs[lo:hi].tobytes()
    assert raw.tobytes() == pack_records(words, recs["count"][lo:hi]).tobytes()


def test_record_view_of_a_list_mmap(tmp_path):
    """A spilled shard read back as an mmap is a record view too: a slice
    of it part-way in gives its bytes as they lie in the file."""
    recs = _records(np.random.default_rng(10), 300)
    path = tmp_path / "s.list"
    write_list(path, 31, recs["word"], recs["count"])
    hdr, w, c = read_list(path, mmap=True)
    raw = raw_record_view(w[100:250], c[100:250])
    assert raw.tobytes() == path.read_bytes()[48 + 1200: 48 + 3000]
    assert hdr.total_count == int(recs["count"].sum(dtype=np.uint64))


def test_to_host_packs_records_and_their_total():
    """The pack step: bit 63 flipped back, counts mod 2^32 (0xFFFFFFFF and
    2^31 kept, 2^32 + 5 wrapped to 5), the fields of one record array, and
    the total of the u32 counts."""
    rng = np.random.default_rng(12)
    words = np.sort(rng.integers(0, 1 << 63, 1000, dtype=np.uint64))
    counts = rng.integers(1, 1 << 32, 1000, dtype=np.int64)
    counts[[0, 1, 2, 3]] = [0xFFFFFFFF, 1 << 31, (1 << 32) + 5, 0]
    shard = port.to_host(keys_from_u64(words), torch.from_numpy(counts))
    w, c = shard
    u32 = (counts & 0xFFFFFFFF).astype(np.uint32)
    np.testing.assert_array_equal(w, words)
    np.testing.assert_array_equal(c, u32)
    assert raw_record_view(w, c).tobytes() == pack_records(words,
                                                           u32).tobytes()
    assert shard.total == int(u32.sum(dtype=np.uint64))


def test_bucket_totals_equal_the_host_sum(tmp_path, monkeypatch):
    """Merged buckets carry the total taken where they were packed, slices
    of one shard are summed over their count field, a lone shard goes
    uncut: either way the total is the u32 sum of what was written, counts
    of 0xFFFFFFFF and their wrap in the merge included."""
    rng = np.random.default_rng(13)
    shards = []
    for lo in (0, 1 << 40):   # the second shard's upper half stands alone
        words = np.unique(rng.integers(lo, lo + (1 << 41), 3000,
                                       dtype=np.uint64))
        counts = rng.integers(1, 1 << 32, len(words), dtype=np.int64)
        counts[::97] = 0xFFFFFFFF
        shards.append(port.to_host(keys_from_u64(words),
                                   torch.from_numpy(counts)))
    monkeypatch.setattr(port, "merge_sorted_shards", functools.partial(
        port.merge_sorted_shards, target_bucket=1000))
    lone, = port.merge_sorted_shards(shards[1:], device="cpu")
    assert lone is shards[1]   # a lone shard goes uncut, with its total
    parts = list(port.merge_sorted_shards(shards, device="cpu"))
    merged = [p for p in parts if getattr(p, "total", None) is not None]
    assert merged and len(merged) < len(parts)
    for p in merged:
        assert p.total == int(p[1].sum(dtype=np.uint64))
    whole = trace.total("list.records_whole")
    hdr = port._merge_and_write(shards, str(tmp_path / "b.list"), 25, 1,
                                0xFFFFFFFF, "cpu")
    counts = np.concatenate([c for _, c in parts])
    assert hdr.n_words == len(counts)
    assert hdr.total_count == int(counts.sum(dtype=np.uint64))
    assert trace.total("list.records_whole") - whole == hdr.n_words
    _, w, c = read_list(tmp_path / "b.list")
    np.testing.assert_array_equal(c, counts)


@pytest.mark.parametrize("cutoffs", [(1, 0xFFFFFFFF), (2, 0xFFFFFFFF),
                                     (1, 3)])
def test_merge_and_write_packs_separate_arrays(tmp_path, monkeypatch,
                                              cutoffs):
    """Shards that are separate word and count arrays, not one record
    array, are packed for the writer: the same bytes as write_list of the
    cut pairs, and none counted as records whole (the shards' words do
    not overlap, so each bucket of 1000 is a slice of one shard and none
    is merged into records on the device)."""
    monkeypatch.setattr(port, "merge_sorted_shards", functools.partial(
        port.merge_sorted_shards, target_bucket=1000))
    rng = np.random.default_rng(14)
    shards, pairs = [], []
    for lo in (0, 1 << 42):
        words = np.unique(rng.integers(lo, lo + (1 << 41), 2000,
                                       dtype=np.uint64))
        counts = rng.integers(1, 6, len(words)).astype(np.uint32)
        shards.append((words.copy(), counts.copy()))
        pairs.append((words, counts))
    words = np.concatenate([w for w, _ in pairs])
    counts = np.concatenate([c for _, c in pairs])
    order = np.argsort(words, kind="stable")
    uw, first = np.unique(words[order], return_index=True)
    uc = np.add.reduceat(counts[order], first).astype(np.uint32)
    lo, hi = cutoffs
    keep = (uc >= lo) & (uc <= hi)
    write_list(tmp_path / "want.list", 25, uw[keep], uc[keep])
    whole = trace.total("list.records_whole")
    hdr = port._merge_and_write(shards, str(tmp_path / "got.list"), 25, lo,
                                hi, "cpu")
    assert trace.total("list.records_whole") == whole
    assert hdr.n_words == int(keep.sum()) > 0
    assert ((tmp_path / "got.list").read_bytes()
            == (tmp_path / "want.list").read_bytes())
