"""Port vs JAX: gmer_counter end to end. The port's CLI
(``genometester4_tpu_torch.cli.gmer_counter``) counts on the CPU
(``device="cpu"``: kernel A's plain version, ``torch.sort`` and
``torch.searchsorted``) and on its native host route
(``GT4_TPU_COUNT_IMPL=host``). Its stdout, stderr and written files must be
byte-identical to the JAX package's CLI run in-process on its host route
and, where cheap, on its device route (the jnp program on the CPU). The
contract is integer: tolerance 0.

The port runs with 1,500-base chunks and 4,001-byte slabs, so chunk and
slab seams fall inside reads and records; the JAX host route runs whole
slabs, so the seams must not show.
"""

import contextlib
import gzip
import io
import os
import sys

import numpy as np
import pytest
import torch

from chip_smoke import same_file
from genometester4_tpu.cli import gmer_counter as jax_cli
from genometester4_tpu.formats import gmerdb as jax_gmerdb
from genometester4_tpu.formats import gmerdb_binary as jax_binary
from genometester4_tpu_torch.cli import gmer_counter as port_cli
from genometester4_tpu_torch.formats import gmerdb as port_gmerdb
from genometester4_tpu_torch.formats import gmerdb_binary as port_binary
from genometester4_tpu_torch.io import fasta as port_fasta
from genometester4_tpu_torch.pipelines import gmercount as port_gc
from genometester4_tpu_torch.utils import trace


torch.set_num_threads(1)

KS = (11, 25, 31, 32)
CHUNK = 1500          # the port's chunk: seams inside 100 bp reads
SLAB = 4001           # the port's slab: records span slabs
BASES = np.frombuffer(b"ACGT", np.uint8)
COMP = np.zeros(256, np.uint8)
COMP[BASES] = np.frombuffer(b"TGCA", np.uint8)
ITER_CODE_SLABS = port_fasta.iter_code_slabs
ITER_SLABS_INDEXED = port_fasta.iter_slabs_indexed


def _genome(rng, n=30_000):
    """Random bases with a poly-A and a poly-T run (the word 0 at every k,
    forward and reverse) and a run of N."""
    g = rng.choice(BASES, n)
    g[1000:1070] = ord("A")
    g[5000:5050] = ord("T")
    g[9000:9040] = ord("N")
    return g


def _db_text(rng, g, k, messy=False):
    """Nodes of two k-mers: one from the genome and its alt allele (the
    middle base changed), one node of three (an odd node for
    --double_median), the word 0 and a word repeated in two nodes (their
    codes sum). ``messy``: lines the native parser refuses (lower case,
    a bad base, a double tab, a short word, a count below its k-mers)."""
    lines = []
    for i in range(60):
        p = int(rng.integers(0, len(g) - k))
        if 9000 - k < p < 9040:
            p = 100
        w = g[p:p + k].tobytes().decode()
        alt = list(w)
        alt[k // 2] = "ACGT"[("ACGT".index(alt[k // 2]) + 1) % 4]
        lines.append(f"S{i}\t2\t{w}\t{''.join(alt)}")
    third = g[2000:2000 + k].tobytes().decode()
    lines.append(f"ODD\t3\t{'A' * k}\t{third}\t{g[7000:7000 + k].tobytes().decode()}")
    lines.append(f"DUP\t2\t{third}\t{g[8000:8000 + k].tobytes().decode()}")
    if messy:
        w = g[3000:3000 + k].tobytes().decode()
        lines += [f"low\t2\t{w.lower()}\t{'T' * k}",
                  f"bad\t2\t{w[:-1]}X\t{w}",
                  f"tabs\t2\t\t{w}\t{w[::-1]}",
                  f"short\t1\t{w[:-3]}",
                  f"few\t1\t{w}\t{'C' * k}"]
    return "\n".join(lines) + "\n"


def _reads(rng, g, n=300, length=100):
    """FASTQ reads from the genome: a third reverse complemented, every
    seventh with an N, some over the poly-A/T runs."""
    recs = []
    for r in range(n):
        p = int(rng.integers(0, len(g) - length)) if r % 10 else 990 + r % 50
        s = g[p:p + length].copy()
        if r % 3 == 0:
            s = COMP[s][::-1]
        if r % 7 == 0:
            s[int(rng.integers(0, length))] = ord("N")
        recs.append(b"@r%d x\n%s\n+\n%s\n" % (r, s.tobytes(), b"I" * length))
    return b"".join(recs)


def _fasta(g):
    """Three records cut from the genome, 60 bases a line, one lower case."""
    out = []
    for i, (a, b) in enumerate(((0, 7001), (4000, 12_345), (20_000, 30_000))):
        s = g[a:b].tobytes()
        if i == 1:
            s = s.lower()
        out.append(b">c%d desc\n" % i
                   + b"\n".join(s[j:j + 60] for j in range(0, len(s), 60))
                   + b"\n")
    return b"".join(out)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_gmercounter")
    rng = np.random.default_rng(2024)
    g = _genome(rng)
    for k in KS:
        (tmp / f"db{k}.txt").write_text(_db_text(rng, g, k))
    (tmp / "messy25.txt").write_text(_db_text(rng, g, 25, messy=True))
    fq = _reads(rng, g)
    (tmp / "reads.fq").write_bytes(fq)
    (tmp / "reads.fq.gz").write_bytes(gzip.compress(fq))
    (tmp / "reads.fa").write_bytes(_fasta(g))
    (tmp / "truncated.fq").write_bytes(b"@cut\nACGTNNACGT\n")
    return tmp


@contextlib.contextmanager
def _in_dir(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def _run(main, tmp, args, stdin=None, **kw):
    out, err = io.StringIO(), io.StringIO()
    old_stdin = sys.stdin
    if stdin is not None:
        sys.stdin = io.TextIOWrapper(io.BytesIO(stdin))
    try:
        with _in_dir(tmp), contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = main(args, **kw)
    finally:
        sys.stdin = old_stdin
    return rc, out.getvalue(), err.getvalue()


def run_jax(monkeypatch, tmp, args, impl="host", stdin=None):
    monkeypatch.setenv("GT4_TPU_COUNT_IMPL", impl)
    try:
        return _run(jax_cli.main, tmp, args, stdin=stdin)
    finally:
        monkeypatch.delenv("GT4_TPU_COUNT_IMPL")


@pytest.fixture
def small_port(monkeypatch):
    """The port with CHUNK-base chunks and SLAB-byte slabs."""
    class Small(port_gc.DBCounter):
        def __init__(self, db, **kw):
            super().__init__(db, chunk_bases=CHUNK, **kw)

    monkeypatch.setattr(port_gc, "DBCounter", Small)
    monkeypatch.setattr(port_fasta, "iter_code_slabs",
                        lambda path, k, slab_bytes=0: ITER_CODE_SLABS(
                            path, k, SLAB))
    monkeypatch.setattr(port_fasta, "iter_slabs_indexed",
                        lambda path, k, slab_bytes=0: ITER_SLABS_INDEXED(
                            path, k, SLAB))


def run_port(monkeypatch, tmp, args, route="device", stdin=None):
    """The port's CLI on the CPU: its device route's plain versions, or its
    native host route."""
    if route == "host":
        monkeypatch.setenv("GT4_TPU_COUNT_IMPL", "host")
    else:
        monkeypatch.delenv("GT4_TPU_COUNT_IMPL", raising=False)
    try:
        return _run(port_cli.main, tmp, args, stdin=stdin, device="cpu")
    finally:
        monkeypatch.delenv("GT4_TPU_COUNT_IMPL", raising=False)


COUNT_CASES = {
    "fastq": ["reads.fq"],
    "flags_fasta": ["--total", "--unique", "--header", "--distribution", "5",
                    "--stats", "reads.fa"],
    "median_32bit_gz_two_files": ["--double_median", "-32", "--unique",
                                  "--stats", "--kmers", "reads.fq.gz",
                                  "reads.fa"],
    "max_kmers": ["--max_kmers", "1", "--total", "--kmers", "--stats",
                  "reads.fa", "reads.fq"],
}


@pytest.mark.parametrize("route", ["device", "host"])
@pytest.mark.parametrize("case", sorted(COUNT_CASES))
@pytest.mark.parametrize("k", KS)
def test_count_equals_jax(data, monkeypatch, small_port, k, case, route):
    """Count mode: the port's stdout and stderr equal the JAX host route's,
    on its device route (plain versions on the CPU) and its host route."""
    args = ["-db", f"db{k}.txt", *COUNT_CASES[case]]
    want = run_jax(monkeypatch, data, args)
    got = run_port(monkeypatch, data, args, route)
    assert want[0] == 0
    assert got == want


@pytest.mark.parametrize("k", [11, 32])
def test_count_equals_jax_device_route(data, monkeypatch, small_port, k):
    """The JAX package's device route (its jnp program on the CPU) counts
    what the port counts, --stats included."""
    args = ["-db", f"db{k}.txt", "--stats", "reads.fa", "reads.fq"]
    want = run_jax(monkeypatch, data, args, impl="device")
    assert want[0] == 0
    assert run_port(monkeypatch, data, args) == want


def test_index_equals_jax_device_route(data, monkeypatch, small_port):
    """The JAX package's device route in index mode (XLA extraction, L - k +
    1 windows a chunk) builds the port's index, with the same verbose
    dump."""
    args = ["-db", "db11.txt", "--compile_index", "p.idx", "--verbose",
            "reads.fq"]
    got = run_port(monkeypatch, data, args)
    want = run_jax(monkeypatch, data, args[:3] + ["j.idx"] + args[4:],
                   impl="device")
    try:
        assert got == want and want[0] == 0
        assert same_file(data / "p.idx", data / "j.idx")
    finally:
        for f in ("p.idx", "j.idx"):
            (data / f).unlink(missing_ok=True)


def test_messy_db_and_stdin(data, monkeypatch, small_port):
    """A text database the native parser refuses (the bug-compatible
    Python parser takes it), and reads from stdin (``-``)."""
    args = ["-db", "messy25.txt", "--total", "--stats", "-"]
    stdin = (data / "reads.fq").read_bytes()
    want = run_jax(monkeypatch, data, args, stdin=stdin)
    assert want[0] == 0 and want[2]   # the parser's warnings
    assert run_port(monkeypatch, data, args, stdin=stdin) == want


@pytest.mark.parametrize("k", [11, 32])
def test_write_binary_db_and_count_from_it(data, monkeypatch, small_port, k):
    """``-w`` writes the same binary database as JAX (the 2 GiB root table
    compared block by block), with the same -D chatter apart from the
    times, and ``-dbb`` counts from it as JAX does."""
    got = run_port(monkeypatch, data, ["-db", f"db{k}.txt", "-w", "p.gmdb"])
    want = run_jax(monkeypatch, data, ["-db", f"db{k}.txt", "-w", "j.gmdb"])
    try:
        assert got == want == (0, "", "")
        assert same_file(data / "p.gmdb", data / "j.gmdb")
        (data / "j.gmdb").unlink()
        args = ["-dbb", "p.gmdb", "--total", "--header", "reads.fq"]
        got = run_port(monkeypatch, data, args)
        assert got[0] == 0
        assert got == run_jax(monkeypatch, data, args)
    finally:
        for f in ("p.gmdb", "j.gmdb"):
            (data / f).unlink(missing_ok=True)


INDEX_CASES = {
    # (database, input, extra flags, slab bytes of the port's FASTA stream)
    "fastq_k25_dump": ("db25.txt", ["reads.fq"], [], None),
    "fasta_tiny_slabs_k32": ("db32.txt", ["reads.fa"], ["--stats"], 257),
    "verbose_two_files_k11": ("db11.txt", ["reads.fq", "reads.fa"],
                              ["--verbose", "-D"], None),
    "fastq_then_truncated_stats_k25": ("db25.txt",
                                       ["reads.fq", "truncated.fq"],
                                       ["--stats"], None),
}


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_compile_index_equals_jax(data, monkeypatch, small_port, case):
    """--compile_index: the port's index file equals JAX's byte for byte,
    and so do stdout and stderr (apart from -D's times); the FASTQ case
    also dumps the port's index with --dump_index, as JAX dumps its own."""
    db, inputs, flags, slab = INDEX_CASES[case]
    if slab is not None:
        monkeypatch.setattr(port_fasta, "iter_slabs_indexed",
                            lambda path, k, slab_bytes=0: ITER_SLABS_INDEXED(
                                path, k, slab))
    got = run_port(monkeypatch, data, ["-db", db, "--compile_index", "p.idx",
                                       *flags, *inputs])
    want = run_jax(monkeypatch, data, ["-db", db, "--compile_index", "j.idx",
                                       *flags, *inputs])
    try:
        assert want[0] == 0
        assert got[:2] == want[:2]
        assert _untimed(got[2]) == _untimed(want[2]).replace("j.idx", "p.idx")
        assert same_file(data / "p.idx", data / "j.idx")
        (data / "j.idx").unlink()
        if case == "fastq_k25_dump":
            args = ["-dbb", "p.idx", "--dump_index", "reads.fq"]
            dump = run_port(monkeypatch, data, args)
            assert dump[0] == 0 and "Node 0 " in dump[1]
            assert dump == run_jax(monkeypatch, data, args)
    finally:
        for f in ("p.idx", "j.idx"):
            (data / f).unlink(missing_ok=True)


def _untimed(stderr: str) -> str:
    """-D chatter with its measured times blanked."""
    import re
    return re.sub(r"time( \([a-z]+\))?: [0-9.]+s", "time: Xs", stderr)


@pytest.mark.parametrize("args", [
    [],
    ["-db", "db25.txt", "-dbb", "x.gmdb", "reads.fq"],
    ["-dbb", "x.gmdb", "-w", "y.gmdb"],
    ["-db", "db25.txt", "no_such_file.fq"],
    ["-db", "no_such_db.txt", "reads.fq"],
    ["-db", "db25.txt"],
    ["--distribution"],
    ["-v"],
])
def test_messages_equal_jax(data, monkeypatch, args):
    """Errors (nothing to do, both databases, a database read and written,
    a missing input or database file, a flag without its value) and the
    version line: same exit code, stdout and stderr."""
    want = run_jax(monkeypatch, data, args)
    assert run_port(monkeypatch, data, args) == want


@pytest.mark.parametrize("k", KS)
def test_gmerdb_tables_equal_jax(data, k):
    """The state carried across: the port's GmerDB tables equal JAX's for
    the same text file, and for the binary file JAX writes from it, read
    back by each package (tolerance 0)."""
    names = [f"db{k}.txt"] + (["messy25.txt"] if k == 25 else [])
    for name in names:
        path = str(data / name)
        for bits in (16, 32):
            want = jax_gmerdb.load_text_db(path, 1000000000, bits)
            got = port_gmerdb.load_text_db(path, 1000000000, bits)
            _assert_db_equal(got, want)
    want = jax_gmerdb.load_text_db(str(data / f"db{k}.txt"))
    path = data / f"t{k}.gmdb"
    try:
        # the port's writer (its bytes are JAX's: see -w above) leaves the
        # root table's zero pages as holes
        with open(path, "wb") as f:
            port_binary.write_binary_db(port_gmerdb.load_text_db(
                str(data / f"db{k}.txt")), f)
        # the file keeps one entry of a repeated word: its slots differ
        # from the text's, the same way in both packages
        binary = jax_binary.load_binary_db(str(path))
        _assert_db_equal(port_binary.load_binary_db(str(path)), binary)
        lazy = port_binary.load_binary_db(str(path), lazy=True)
        assert lazy.sorted_words is None and lazy.trie_blob is not None
        w = int(want.sorted_words[3])
        assert lazy.lookup_code(w) == int(want.sorted_codes[3])
        lazy.ensure_lookup()
        _assert_db_equal(lazy, binary)
    finally:
        path.unlink(missing_ok=True)


def _assert_db_equal(got, want):
    for f in ("wordsize", "node_bits", "kmer_bits", "count_bits", "names"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("node_kmers_start", "node_nkmers", "kmer_words", "kmer_dirs",
              "sorted_words", "sorted_codes"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert got.n_kmers == want.n_kmers


def test_cli_imports_torch_only_to_count(data, monkeypatch):
    """Help, a flag without its value and the argument errors import no
    torch; a count on the CPU does; a count on the default device needs
    CUDA and raises without it (no silent CPU)."""
    import subprocess
    code = ("import sys, io, contextlib\n"
            "from genometester4_tpu_torch.cli.gmer_counter import main\n"
            "rcs = []\n"
            "with contextlib.redirect_stdout(io.StringIO()), \\\n"
            "        contextlib.redirect_stderr(io.StringIO()):\n"
            "    for args in (['-h'], ['--max_kmers'], [],\n"
            "                 ['-db', 'a', '-dbb', 'b', 'reads.fq']):\n"
            "        rcs.append(main(args))\n"
            "    before = 'torch' in sys.modules\n"
            "    rcs.append(main(['-db', 'db11.txt', 'reads.fq'],\n"
            "                    device='cpu'))\n"
            "print(rcs, before, 'torch' in sys.modules)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo}
    env.pop("GT4_TPU_COUNT_IMPL", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=data,
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[0, 1, 1, 1, 0] False True"
    if not torch.cuda.is_available():
        monkeypatch.delenv("GT4_TPU_COUNT_IMPL", raising=False)
        with _in_dir(data), pytest.raises(RuntimeError, match="CUDA"):
            port_cli.main(["-db", "db11.txt", "reads.fq"])


def test_count_step_chunk_seams_and_launches(data, monkeypatch):
    """DBCounter on the CPU at several chunk sizes: the counts and
    #TOTAL_KMERS do not depend on where the seams fall, and the CPU route
    never calls kernel A's wrapper."""
    db = port_gmerdb.load_text_db(str(data / "db32.txt"))
    before = trace.total("launch.extract")
    results = []
    for chunk in (64, 1000, 1 << 25):
        c = port_gc.DBCounter(db, chunk_bases=chunk, collect_stats=True,
                              device="cpu")
        c.add_file(str(data / "reads.fa"))
        c.finalize()
        results.append((c.result.counts.tolist(),
                        c.result.stats.n_kmers_total))
    assert results[0] == results[1] == results[2]
    assert results[0][1] > 0 and sum(results[0][0]) > 0
    assert trace.total("launch.extract") == before


def test_refuses_a_process_group(monkeypatch, data):
    """GT4_DIST_NPROCS=2 without GT4_DIST_COORD is no group, as in JAX
    (``multihost.distributed_env``): the CLI counts as one process and
    prints what JAX's CLI prints."""
    monkeypatch.setenv("GT4_DIST_NPROCS", "2")
    monkeypatch.delenv("GT4_DIST_COORD", raising=False)
    args = ["-db", "db25.txt", "--stats", "reads.fq"]
    want = run_jax(monkeypatch, data, args)
    got = run_port(monkeypatch, data, args)
    assert got == want and want[0] == 0 and want[1].count("\n") > 60
    assert not torch.distributed.is_initialized()
