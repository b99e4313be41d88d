"""Port vs JAX: glistquery (``pipelines.listquery`` and the CLI) on the CPU.

The port runs with ``device="cpu"``: its bulk lookups (4,096 queries or
more) and ``-s`` take the torch route (kernel A's plain version, the
canonical words and ``torch.searchsorted`` on the CPU), and with
``GT4_TPU_LINK=slow`` its host route (the native batched search or
zipper, the native forward extractor). The JAX package runs in-process
under ``JAX_PLATFORMS=cpu``, which is its host route. stdout, stderr and
the exit code must be equal (tolerance 0), and so must the counts of
``lookup_device`` on both packages. The inputs (random genomes with N
runs, FASTQ reads drawn from them) come from a numpy seed; the lists and
the ``.index`` are made by the JAX package's host route."""

import contextlib
import io
import os
import struct

import numpy as np
import pytest
import torch

from tests.conftest import random_fasta
from tests.test_cli_chrome import CASES as CHROME_CASES
from genometester4_tpu.cli import glistquery as jax_cli
from genometester4_tpu.pipelines import listmaker as jax_listmaker
from genometester4_tpu.pipelines import listquery as jax_lq
from genometester4_tpu_torch.cli import glistquery as port_cli
from genometester4_tpu_torch.formats.list_format import write_list
from genometester4_tpu_torch.pipelines import listquery as port_lq

torch.set_num_threads(1)

KS = (12, 25, 32)


def _run(main, args, cwd, **kw):
    """A CLI ``main`` in ``cwd``: (rc, stdout, stderr, the exception's
    type and text if it raised)."""
    out, err = io.StringIO(), io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    exc = None
    rc = None
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                rc = main(list(args), **kw)
            except SystemExit as e:
                rc = e.code if isinstance(e.code, int) else 1
            except Exception as e:   # noqa: BLE001 - compared below
                exc = (type(e).__name__, str(e))
    finally:
        os.chdir(old)
    return rc or 0, out.getvalue(), err.getvalue(), exc


def _both(args, cwd):
    """The same argv through the JAX CLI and the port's on the CPU."""
    return (_run(jax_cli.main, args, cwd),
            _run(port_cli.main, args, cwd, device="cpu"))


def _with_host_list_env(fn):
    old = os.environ.get("GT4_TPU_COUNT_IMPL")
    os.environ["GT4_TPU_COUNT_IMPL"] = "host"
    try:
        return fn()
    finally:
        os.environ.pop("GT4_TPU_COUNT_IMPL")
        if old is not None:
            os.environ["GT4_TPU_COUNT_IMPL"] = old


def _reads(rng, genome: bytes, n: int, length: int, fastq: bool,
           n_run: bool) -> str:
    """Reads drawn from ``genome`` (half reverse complemented), a few with
    runs of N."""
    comp = bytes.maketrans(b"ACGTN", b"TGCAN")
    out = []
    for i in range(n):
        at = int(rng.integers(0, len(genome) - length))
        r = genome[at:at + length]
        if rng.random() < 0.5:
            r = r.translate(comp)[::-1]
        if n_run and i % 7 == 3:
            j = int(rng.integers(0, length - 6))
            r = r[:j] + b"NNNNN" + r[j + 5:]
        r = r.decode()
        out.append(f"@r{i}\n{r}\n+\n{'I' * length}\n" if fastq
                   else f">r{i}\n{r}\n")
    return "".join(out)


@pytest.fixture(scope="module", params=KS, ids=[f"k{k}" for k in KS])
def inputs(request, tmp_path_factory):
    """Per k: a genome's .list and .index, a second genome's .list sharing
    half of it, the reads' .list, FASTA/FASTQ reads with N runs, a short
    FASTA, query files and an empty list."""
    k = request.param
    d = tmp_path_factory.mktemp(f"lq{k}")
    rng = np.random.default_rng(100 + k)
    g = random_fasta(rng, 3, 4000, 7000, n_prob=0.002)
    (d / "g.fa").write_text(g)
    (d / "h.fa").write_text(g[:len(g) // 2] + random_fasta(rng, 2, 3000,
                                                           4000))
    genome = "".join(line for line in g.splitlines()
                     if not line.startswith(">")).encode()
    (d / "reads.fq").write_text(_reads(rng, genome, 150, 100, True, True))
    (d / "reads.fa").write_text(_reads(rng, genome, 40, 90, False, True))
    (d / "few.fa").write_text(_reads(rng, genome, 3, 60, False, True))
    (d / "short.fa").write_text(">s\n" + "ACGTTGCA"[:max(1, k - 5)] + "\n")

    def make():
        for name in ("g", "h"):
            jax_listmaker.make_list([str(d / f"{name}.fa")], k,
                                    str(d / f"{name}.list"))
        jax_listmaker.make_list([str(d / "reads.fq")], k,
                                str(d / "reads.list"))
        jax_listmaker.make_index([str(d / "g.fa")], k, str(d / "g.index"))
    _with_host_list_env(make)
    write_list(str(d / "empty.list"), k, np.empty(0, np.uint64),
               np.empty(0, np.uint32))
    # a clean query file of 6,000 k-mers (the batched path, >= 4,096 ->
    # the torch route), a third of them from the genome
    words = ["".join(rng.choice(list("ACGT"), k)) for _ in range(4000)]
    for _ in range(2000):
        at = int(rng.integers(0, len(genome) - k))
        words.append(genome[at:at + k].decode())
    (d / "q.txt").write_text("\n".join(words) + "\n")
    (d / "q_small.txt").write_text("\n".join(words[3990:4010]) + "\n")
    # a dirty query file: the byte tokenizer, with --3p for long tokens
    (d / "q_dirty.txt").write_text(
        "\n".join(w + "AC" if i % 3 else w for i, w in
                  enumerate(words[3995:4005])) + "\n\n")
    (d / "word").write_text(words[4001])
    return k, d


def _args(template, d):
    word = (d / "word").read_text()
    return [a.format(d=d, w=word, wlong=word + "ACGT") for a in template]


CASES = {
    "dump": ["{d}/g.list"],
    "stat": ["{d}/g.list", "--stat"],
    "median": ["{d}/g.list", "--median"],
    "median_debug": ["{d}/g.list", "--median", "-D"],
    "distribution": ["{d}/g.list", "--distribution", "5"],
    "distribution_debug": ["{d}/g.list", "--distribution", "3", "-D"],
    "gc": ["{d}/g.list", "--gc"],
    "gc_debug": ["{d}/g.list", "--gc", "-D"],
    "empty_dump": ["{d}/empty.list"],
    "empty_stat": ["{d}/empty.list", "--stat"],
    "empty_median": ["{d}/empty.list", "--median", "-D"],
    "empty_gc": ["{d}/empty.list", "--gc", "-D"],
    "empty_query_list": ["{d}/empty.list", "-l", "{d}/reads.list"],
    "q": ["{d}/g.list", "-q", "{w}"],
    "q_absent_min": ["{d}/g.list", "-q", "{w}", "-min", "1"],
    "q_mm1_p": ["{d}/g.list", "-q", "{w}", "-mm", "1", "-p", "3"],
    "q_mm2_all": ["{d}/g.list", "-q", "{w}", "-mm", "2", "--all"],
    "q_3p": ["{d}/g.list", "-q", "{wlong}", "--3p"],
    "q_5p": ["{d}/g.list", "-q", "{wlong}", "--5p"],
    "f": ["{d}/g.list", "-f", "{d}/q.txt"],
    "f_min_max": ["{d}/g.list", "-f", "{d}/q.txt", "-min", "1", "-max",
                  "1"],
    "f_mm1": ["{d}/g.list", "-f", "{d}/q_small.txt", "-mm", "1"],
    "f_dirty_3p": ["{d}/g.list", "-f", "{d}/q_dirty.txt", "--3p"],
    "s_fastq": ["{d}/g.list", "-s", "{d}/reads.fq"],
    "s_fasta": ["{d}/g.list", "-s", "{d}/reads.fa"],
    "s_min": ["{d}/g.list", "-s", "{d}/reads.fq", "-min", "1"],
    "s_min_max": ["{d}/g.list", "-s", "{d}/reads.fa", "-min", "1", "-max",
                  "1"],
    "s_max": ["{d}/g.list", "-s", "{d}/reads.fq", "-max", "1"],
    "s_mm1": ["{d}/g.list", "-s", "{d}/few.fa", "-mm", "1"],
    "s_mm2_p_all": ["{d}/g.list", "-s", "{d}/few.fa", "-mm", "2", "-p",
                    "4", "--all"],
    "s_all": ["{d}/g.list", "-s", "{d}/reads.fa", "--all"],
    "s_short": ["{d}/g.list", "-s", "{d}/short.fa"],
    "l": ["{d}/g.list", "-l", "{d}/reads.list"],
    "l_mm1": ["{d}/h.list", "-l", "{d}/g.list", "-mm", "1", "-min", "1"],
    "l_two_lists": ["{d}/g.list", "{d}/h.list", "-l", "{d}/reads.list"],
    "l_three_lists": ["{d}/g.list", "{d}/h.list", "{d}/reads.list", "-l",
                      "{d}/g.list"],
    "union_dump": ["{d}/g.list", "{d}/h.list"],
    "union_dump_header": ["{d}/g.list", "{d}/reads.list", "{d}/h.list",
                          "--header"],
    "is_union": ["{d}/g.list", "{d}/h.list", "--is_union"],
    "index_dump": ["{d}/g.index"],
    "index_locations": ["{d}/g.index", "--locations"],
    "index_files": ["{d}/g.index", "--files"],
    "index_sequences": ["{d}/g.index", "--sequences"],
    "index_stat": ["{d}/g.index", "--stat"],
    "index_median": ["{d}/g.index", "--median"],
    "index_gc": ["{d}/g.index", "--gc"],
    "index_q_locations": ["{d}/g.index", "-q", "{w}", "--locations"],
    "index_s_locations": ["{d}/g.index", "-s", "{d}/few.fa",
                          "--locations"],
    "index_l_locations": ["{d}/g.index", "-l", "{d}/reads.list",
                          "--locations"],
    "index_l": ["{d}/g.index", "-l", "{d}/reads.list"],
    "index_f": ["{d}/g.index", "-f", "{d}/q.txt"],
}

# the cases whose lookups or extraction have a device route: also run
# with GT4_TPU_LINK=slow, the host route of both packages
ROUTED = ("f", "f_min_max", "s_fastq", "s_fasta", "s_min", "s_min_max",
          "s_mm1", "s_all", "l", "l_two_lists", "union_dump", "is_union",
          "index_l", "index_f", "index_s_locations")


@pytest.mark.parametrize("case", list(CASES))
def test_cli_equal(inputs, case):
    k, d = inputs
    rj, rp = _both(_args(CASES[case], d), d)
    assert rj == rp
    assert rj[0] == 0 and rj[3] is None
    if case in ROUTED:
        assert rj[1].count("\n") > 20


@pytest.mark.parametrize("case", ROUTED)
def test_cli_equal_host_route(inputs, case, monkeypatch):
    """GT4_TPU_LINK=slow: the port's host routes (native search, zipper
    and forward extractor) against JAX's."""
    monkeypatch.setenv("GT4_TPU_LINK", "slow")
    k, d = inputs
    rj, rp = _both(_args(CASES[case], d), d)
    assert rj == rp and rj[1]


ERROR_CASES = {
    "missing_list": ["{d}/nofile.list", "-q", "{w}"],
    "missing_seqfile": ["{d}/g.list", "-s", "{d}/nofile.fa"],
    "seqfile_is_dir": ["{d}/g.list", "-s", "{d}"],
    "missing_queryfile": ["{d}/g.list", "-f", "{d}/nofile.txt"],
    "missing_query_list": ["{d}/g.list", "-l", "{d}/nofile.list"],
    "query_list_not_a_list": ["{d}/g.list", "-l", "{d}/g.fa"],
    "query_too_short": ["{d}/g.list", "-q", "ACGT"],
    "query_too_long": ["{d}/g.list", "-q", "{wlong}"],
    "mismatches_past_k": ["{d}/g.list", "-mm", "16", "-p", "32", "-q",
                          "{w}"],
    "query_with_two_lists": ["{d}/g.list", "{d}/h.list", "-q", "{w}"],
    "mm_with_two_lists": ["{d}/g.list", "{d}/h.list", "-l",
                          "{d}/reads.list", "-mm", "1"],
    "files_of_a_list": ["{d}/g.list", "--files"],
    "sequences_of_two": ["{d}/g.index", "{d}/g.index", "--sequences"],
    "not_a_list": ["{d}/g.fa", "--stat"],
    "not_a_list_dump": ["{d}/g.fa"],
    "index_with_list_files": ["{d}/g.index", "{d}/g.list", "--files"],
}


@pytest.mark.parametrize("case", list(ERROR_CASES))
def test_cli_errors_equal(inputs, case):
    k, d = inputs
    rj, rp = _both(_args(ERROR_CASES[case], d), d)
    assert rj == rp and rj[0] != 0


def test_cli_wrong_word_length(inputs, tmp_path):
    """Two lists of different word lengths, as searched lists and as the
    query list."""
    k, d = inputs
    other = tmp_path / "o.list"
    write_list(str(other), 11 if k != 11 else 13,
               np.arange(5000, dtype=np.uint64) * 7,
               np.ones(5000, np.uint32))
    for args in ([str(d / "g.list"), str(other)],
                 [str(d / "g.list"), str(other), "--stat"],
                 [str(d / "g.list"), "-l", str(other)],
                 [str(other), "-s", str(d / "reads.fq")]):
        rj, rp = _both(args, tmp_path)
        assert rj == rp


CORRUPT = {
    "empty": b"",
    "magic4": struct.pack("<I", 0x47543443),
    "badmagic": b"not a list at all\n",
    "sane_trunc": struct.pack("<IIIIQQQII", 0x47543443, 4, 4, 16, 100, 500,
                              48, 8, 4) + b"A" * 50,
    "t32": struct.pack("<IIIIQQ", 0x47543443, 4, 4, 16, 1000, 5000),
    "major5": struct.pack("<IIIIQQQII", 0x47543443, 5, 0, 16, 0, 0, 48, 8,
                          4),
    "index_major3": struct.pack("<IIIIQQIIIIQQQ", 0x47543449, 3, 0, 16, 0,
                                0, 1, 1, 1, 0, 72, 72, 72),
}


@pytest.mark.parametrize("flag", ["--stat", "--median", "-D"])
@pytest.mark.parametrize("name", list(CORRUPT))
def test_cli_corrupt_header_equal(tmp_path, name, flag):
    p = tmp_path / f"{name}.list"
    p.write_bytes(CORRUPT[name])
    rj, rp = _both([str(p), flag, "-q", "ACGTACGTACGTACGT"]
                   if flag == "-D" else [str(p), flag], tmp_path)
    assert rj == rp


@pytest.mark.parametrize("tool,args", [c for c in CHROME_CASES
                                       if c[0] == "glistquery"],
                         ids=lambda v: " ".join(v) if isinstance(v, list)
                         else v)
def test_cli_chrome_equal(tool, args, tmp_path):
    rj, rp = _both(args, tmp_path)
    assert rj == rp


# ----------------------------------------------------------- lookup_device

def _lookup_both(path, queries):
    """lookup_device of both packages on the CPU (chunk 1,000, so several
    chunks), and the port's lookup_host."""
    jq = jax_lq.ListQuery(str(path))
    pq = port_lq.ListQuery(str(path), device="cpu")
    want = np.asarray(jq.lookup_device(queries, chunk=1000))
    got = pq.lookup_device(queries, chunk=1000)
    assert got.dtype == np.uint32
    return want, got, pq.lookup_host(queries)


@pytest.mark.parametrize("k", [12, 31, 32])
def test_lookup_device_equal(tmp_path, k):
    """Word 0, the largest word, k = 32 words with bit 63 set, absent
    queries, counts up to 2^32 - 1, in random order."""
    rng = np.random.default_rng(k)
    top = (1 << (2 * k)) - 1
    w = rng.integers(0, top, 6000, dtype=np.uint64, endpoint=True)
    w = np.unique(np.concatenate([w, np.array([0, top], np.uint64)]))
    if k == 32:
        assert (w >> np.uint64(63)).sum() > 1000
    c = rng.integers(1, 1000, len(w)).astype(np.uint32)
    c[::97] = 0xFFFFFFFF
    path = tmp_path / "t.list"
    write_list(str(path), k, w, c)
    absent = rng.integers(0, top, 3000, dtype=np.uint64, endpoint=True)
    q = np.concatenate([w[rng.permutation(len(w))[:4000]], absent,
                        np.array([0, top, top, 0], np.uint64)])
    want, got, host = _lookup_both(path, q)
    assert np.array_equal(got, want) and np.array_equal(got, host)
    assert got[-4:].tolist() == [c[0], c[-1], c[-1], c[0]]
    assert (got > 0).sum() >= 4000


def test_lookup_device_empty_list_and_no_queries(tmp_path):
    path = tmp_path / "e.list"
    write_list(str(path), 25, np.empty(0, np.uint64), np.empty(0, np.uint32))
    q = np.array([0, 5, (1 << 50) - 1], np.uint64)
    want, got, host = _lookup_both(path, q)
    assert np.array_equal(got, want) and not got.any() and not host.any()
    path = tmp_path / "one.list"
    write_list(str(path), 25, np.array([7], np.uint64),
               np.array([3], np.uint32))
    want, got, _ = _lookup_both(path, np.empty(0, np.uint64))
    assert len(got) == len(want) == 0


def test_lookup_routes(tmp_path, monkeypatch):
    """lookup: 4,096 queries or more take the device table, fewer (or
    GT4_TPU_LINK=slow) the host; the answers are the same."""
    rng = np.random.default_rng(5)
    w = np.unique(rng.integers(0, 1 << 40, 9000).astype(np.uint64))
    path = tmp_path / "r.list"
    write_list(str(path), 20, w, np.arange(1, len(w) + 1, dtype=np.uint32))
    pq = port_lq.ListQuery(str(path), device="cpu")
    q = np.concatenate([w[::2], w[:50] + np.uint64(1)])
    got_dev = pq.lookup(q)
    assert pq._dev is not None
    small = port_lq.ListQuery(str(path), device="cpu")
    assert np.array_equal(small.lookup(q[:4095]), got_dev[:4095])
    assert small._dev is None
    monkeypatch.setenv("GT4_TPU_LINK", "slow")
    slow = port_lq.ListQuery(str(path), device="cpu")
    assert np.array_equal(slow.lookup(q), got_dev) and slow._dev is None


def test_search_chunks_overlap(inputs, monkeypatch):
    """-s in device chunks of a few hundred codes (k - 1 codes of overlap)
    prints what one chunk prints."""
    k, d = inputs
    args = [str(d / "g.list"), "-s", str(d / "reads.fq")]
    rj = _run(jax_cli.main, args, d)
    monkeypatch.setattr(port_lq, "SEARCH_CHUNK", 300)
    rp = _run(port_cli.main, args, d, device="cpu")
    assert rj == rp and rj[1].count("\n") > 1000
