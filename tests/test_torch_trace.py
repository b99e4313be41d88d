"""The port's recorder (``utils.trace``) and the spans and counters that
glistmaker's ``make_list`` and FastGT's ``DBCounter`` record on the CPU
route: nesting, jobs, self time, the off switch, counters, the row cap,
what each program records under ``torch.profiler`` and how much of each
job its spans cover, the ``-D`` lines, and the restructured slab parser
against the JAX package's."""

import functools
import gzip
import re
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import profile

from genometester4_tpu.io import fasta as jax_fasta
from genometester4_tpu_torch.formats import gmerdb as port_gmerdb
from genometester4_tpu_torch.formats.list_format import read_list_header
from genometester4_tpu_torch.io import fasta as port_fasta
from genometester4_tpu_torch.parallel import multihost
from genometester4_tpu_torch.pipelines import gmercount as port_gc
from genometester4_tpu_torch.pipelines import listmaker as port_lm
from genometester4_tpu_torch.utils import trace

torch.set_num_threads(1)

K = 25
CHUNK = 8192          # several count chunks a slab
SLAB = 1 << 14        # several slabs a file
BUCKET = 4096         # several merge buckets

LIST_SPANS = {"list", "parse", "read", "frame", "decode", "count", "pad",
              "upload", "launch", "sync", "copyback", "merge", "cuts",
              "gather", "write"}
# the mesh route: "step" for a step of its slots, no "launch"
MESH_SPANS = LIST_SPANS - {"launch"} | {"step"}
# the CPU route has no pinned buffer to wait on ("upload_wait")
COUNT_SPANS = {"count_file", "parse", "read", "frame", "decode", "count",
               "upload", "launch", "finalize", "copyback", "fold"}


def _bases(rng, n):
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]


def _fasta(path, rng, n=30000, width=60):
    seq = _bases(rng, n)
    seq[rng.integers(0, n, 30)] = ord("N")
    lines = [b">g generated"] + [seq[i:i + width].tobytes()
                                 for i in range(0, n, width)]
    path.write_bytes(b"\n".join(lines) + b"\n")
    return seq


def _fastq(path, rng, genome, n_reads=300, length=150):
    starts = rng.integers(0, len(genome) - length, n_reads)
    recs = [b"@r%d\n%s\n+\n%s\n" % (i, genome[s:s + length].tobytes(),
                                     b"I" * length)
            for i, s in enumerate(starts)]
    path.write_bytes(b"".join(recs))


def _db(path, rng, genome, n=200):
    """REF a word of ``genome``, ALT a random word, for each of ``n``
    markers."""
    pos = rng.integers(0, len(genome) - K, n)
    lines = [b"n%07d\t2\t%s\t%s" % (i, genome[p:p + K].tobytes(),
                                    _bases(rng, K).tobytes())
             for i, p in enumerate(pos)]
    path.write_bytes(b"\n".join(lines) + b"\n")
    return port_gmerdb.load_text_db(str(path))


def _coverage(rows, root):
    """The share of ``root``'s time that the spans under it cover: the
    self time of every span below it, over its length."""
    below = sum(r.t1 - r.t0 for r in rows if r.parent == root.id)
    return below / (root.t1 - root.t0)


def _own_excess(rows, root):
    """How far ``root``'s own time passes 5% of it, or 0.1 ms: the
    recorder's own cost in a job as short as finalize is here."""
    own = (1 - _coverage(rows, root)) * (root.t1 - root.t0)
    return own - max(0.05 * (root.t1 - root.t0), 1e-4)


def _expected_padding(path, chunk_bases, mesh_slots=0):
    """(codes sent, padding among them) of ``count_chunks`` over every
    slab, from ``pow2_cap``; with ``mesh_slots``, of the mesh's steps of
    that many slots."""
    slots = pad = 0
    for codes, _ in port_fasta.iter_code_slabs(str(path), K, SLAB):
        n = len(codes)
        if mesh_slots:
            width = max(1 << 14, n // mesh_slots + K)
            width = 1 << (width - 1).bit_length()
            starts = range(0, max(n - (K - 1), 1), width - (K - 1))
            sent = -(-len(starts) // mesh_slots) * mesh_slots * width
            slots += sent
            pad += sent - sum(min(width, n - s) for s in starts)
            continue
        if n <= K - 1:
            continue
        for start in range(0, max(n - (K - 1), 1), chunk_bases - (K - 1)):
            m = min(chunk_bases, n - start)
            cap = port_lm.pow2_cap(m, chunk_bases)
            slots += cap
            pad += cap - m
    return slots, pad


@pytest.fixture(autouse=True)
def _fresh():
    trace.reset()
    yield
    trace.reset()


def test_spans_nest_with_parents_and_jobs():
    with trace.recording():
        with trace.span("list") as a:
            with trace.span("count") as b:
                with trace.span("upload", wait=True) as c:
                    pass
            with trace.span("write") as d:
                pass
        with trace.span("list") as e:
            pass
        other = []
        t = threading.Thread(target=lambda: other.append(
            trace.span("merge").__enter__()))
        t.start()
        t.join()
    rows = {r.id: r for r in trace.rows()}
    assert [rows[s.id].parent for s in (a, b, c, d, e)] == \
        [None, a.id, b.id, a.id, None]
    assert [rows[s.id].job for s in (a, b, c, d, e)] == \
        [a.id, a.id, a.id, a.id, e.id]
    assert [rows[s.id].wait for s in (a, b, c)] == [False, False, True]
    assert all(rows[s.id].t0 <= rows[s.id].t1 for s in (a, b, c, d, e))
    # another thread has a stack of its own: its span is a root
    assert other[0].parent is None and other[0].job == other[0].id
    # rows are kept as the spans close: children first
    order = [r.id for r in trace.rows()]
    assert order.index(c.id) < order.index(b.id) < order.index(a.id)


def test_self_time():
    with trace.recording():
        with trace.span("list") as root:
            time.sleep(0.02)
            with trace.span("count"):
                time.sleep(0.05)
    rows = trace.rows()
    job = next(r for r in rows if r.id == root.id)
    own = (job.t1 - job.t0) - sum(r.t1 - r.t0 for r in rows
                                  if r.parent == root.id)
    assert 0.02 <= own < 0.05
    assert 0.05 / 0.07 * 0.5 < _coverage(rows, job) < 1


def test_off_records_nothing_and_returns_the_shared_no_op():
    assert trace.span("parse") is trace.span("count", wait=True)
    with trace.span("parse") as s:
        trace.count("count.pad", 3)
    assert s is None and trace.rows() == []
    with trace.recording(False):
        assert trace.span("parse") is trace.span("merge")
    with profile():
        assert trace.span("parse") is not trace.span("merge")
    with trace.recording():
        assert trace.span("parse") is not trace.span("merge")
    assert trace.span("parse") is trace.span("merge")


@pytest.mark.parametrize("on", [False, True])
def test_counters_add_to_totals_always_and_to_rows_while_on(on):
    with trace.recording(on):
        trace.count("count.slots", 5)
        with trace.span("count") as outer:
            trace.count("count.slots", 2)
            with trace.span("pad") as inner:
                trace.count("count.pad", 7)
                trace.count("count.pad")
    assert trace.totals() == {"count.slots": 7, "count.pad": 8}
    rows = {r.name: r for r in trace.rows()}
    if not on:
        assert rows == {} and outer is None and inner is None
        return
    assert rows["count"].counts == {"count.slots": 2}
    assert rows["pad"].counts == {"count.pad": 8}


def test_threads_keep_their_own_stacks_and_every_count():
    """More threads than cores, switching often: no count is lost and
    every span's parent is its own thread's."""
    n_threads, n_spans = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_spans):
                with trace.span("count"):
                    with trace.span("pad"):
                        trace.count("count.pad")
        with trace.recording():
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    rows = trace.rows()
    assert trace.totals() == {"count.pad": n_threads * n_spans}
    by_id = {r.id: r for r in rows}
    pads = [r for r in rows if r.name == "pad"]
    assert len(pads) == n_threads * n_spans
    for r in pads:
        parent = by_id[r.parent]
        assert parent.name == "count" and parent.job == r.job == parent.id
        assert parent.t0 <= r.t0 <= r.t1 <= parent.t1
        assert r.counts == {"count.pad": 1}


def test_row_cap_counts_dropped(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 3)
    with trace.recording():
        for _ in range(5):
            with trace.span("read"):
                pass
    assert len(trace.rows()) == 3 and trace.dropped == 2
    trace.reset()
    assert trace.rows() == [] and trace.dropped == 0
    assert trace.totals() == {}


def _run_list(tmp_path, rng):
    fa = tmp_path / "g.fa"
    _fasta(fa, rng)
    out = tmp_path / "g.list"
    port_lm.make_list([str(fa)], K, str(out), chunk_bases=CHUNK,
                      slab_bytes=SLAB, device="cpu")
    assert out.stat().st_size > 48
    return "list", fa, 1, 0


def _run_mesh(tmp_path, rng):
    from genometester4_tpu_torch.parallel.sharding import make_mesh
    fa = tmp_path / "g.fa"
    _fasta(fa, rng)
    out = tmp_path / "g.list"
    port_lm.make_list([str(fa)], K, str(out), slab_bytes=SLAB,
                      device="cpu", mesh=make_mesh(devices=["cpu"] * 4))
    assert out.stat().st_size > 48
    return "list", fa, 1, 4


def _run_count(tmp_path, rng):
    genome = _bases(rng, 20000)
    fq = tmp_path / "r.fq"
    _fastq(fq, rng, genome)
    db = _db(tmp_path / "db.txt", rng, genome)
    c = port_gc.DBCounter(db, chunk_bases=CHUNK, device="cpu")
    c.add_file(str(fq), SLAB)
    c.add_file(str(fq), SLAB)
    c.finalize()
    assert c.result.counts.sum() > 0
    return "count_file", fq, 2, 0


@pytest.mark.parametrize("program,spans", [(_run_list, LIST_SPANS),
                                           (_run_mesh, MESH_SPANS),
                                           (_run_count, COUNT_SPANS)],
                         ids=["make_list", "make_list_mesh", "DBCounter"])
def test_program_spans_under_the_profiler(tmp_path, monkeypatch, program,
                                          spans):
    """Every span of the program's route is recorded under
    ``torch.profiler``, the spans below each job's root cover at least
    95% of it, the padding counters equal ``pow2_cap``'s, and no profiler
    event is named by the program (no ``record_function``)."""
    monkeypatch.setattr(port_lm, "merge_sorted_shards", functools.partial(
        port_lm.merge_sorted_shards, target_bucket=BUCKET))
    # the roots' own time is wall-clock: under several test workers a job
    # can be descheduled between its spans, so the job runs up to three
    # times and the run whose roots keep the least own time is judged
    best = None
    for attempt in range(3):
        trace.reset()
        rng = np.random.default_rng(17)
        work = tmp_path / str(attempt)
        work.mkdir()
        with profile() as prof:
            root_name, path, passes, mesh_slots = program(work, rng)
        rows = trace.rows()
        excess = max(_own_excess(rows, r) for r in rows if r.parent is None)
        if best is None or excess < best[0]:
            best = (excess, rows, prof, root_name, path, passes, mesh_slots)
        if excess <= 0:
            break
    excess, rows, prof, root_name, path, passes, mesh_slots = best
    slots, pad = (passes * n for n in _expected_padding(path, CHUNK,
                                                          mesh_slots))
    assert {r.name for r in rows} == spans
    roots = [r for r in rows if r.parent is None]
    assert {r.name for r in roots} == {root_name} | (
        {"finalize"} if root_name == "count_file" else set())
    assert {r.job for r in rows} == {r.id for r in roots}
    for root in roots:
        assert _own_excess(rows, root) <= 0, root
    counted = {}
    for r in rows:
        for name, n in (r.counts or {}).items():
            counted[name] = counted.get(name, 0) + n
    assert (counted["count.slots"], counted["count.pad"]) == (slots, pad)
    assert pad > 0
    assert counted.get("mesh.steps", 0) == sum(r.name == "step"
                                               for r in rows)
    assert (counted.get("mesh.steps", 0) > 0) == bool(mesh_slots)
    assert "copy.d2h_bytes" not in counted   # no card: nothing copied back
    if root_name == "list":   # every record handed to the writer whole
        hdr = read_list_header(path.parent / "g.list")
        assert counted["list.records_whole"] == hdr.n_words > 0
    else:
        assert "list.records_whole" not in counted
    assert sum(r.name == "parse" for r in rows) >= 2
    assert sum(r.name == "count" for r in rows) >= 2
    if root_name == "list":
        assert sum(r.name == "merge" and any(
            c.parent == r.id and c.name == "gather" for c in rows)
            for r in rows) >= 2
    names = {e.name for e in prof.events()}
    assert not names & (LIST_SPANS | COUNT_SPANS | {"upload_wait"})


INDEX_SPANS = {"count_file", "parse", "read", "frame", "decode",
               "index_lookup", "upload", "sync", "copyback", "index_hits",
               "index_write", "build", "write"}
# the CPU route's fill copies nothing back ("sw_wait")
GASSEMBLE_SPANS = {"gassemble", "load", "gather", "sw", "align", "group",
                   "call", "print"}


def test_katk_spans_under_the_profiler(tmp_path, monkeypatch):
    """gmer_counter --compile_index and gassembler on a small KATK
    fixture under ``torch.profiler``: every span of the index compile, the
    index write and the assembly is recorded, the spans below each job's
    root cover at least 95% of it, ``katk.regions`` counts the region
    file's regions and ``sw.cells`` the cells of every fill, and no
    profiler event is named by the program."""
    import contextlib
    import io

    from genometester4_tpu_torch.cli import gassembler, gmer_counter
    from genometester4_tpu_torch.ops import swalign_cuda
    from genometester4_tpu_torch.tools import katk_fixture

    cells = []
    fill = swalign_cuda.sw_fill

    def counted_fill(refs, reads, nvec):
        cells.append(refs.shape[0] * (refs.shape[1] + 1)
                     * (reads.shape[1] + 1))
        return fill(refs, reads, nvec)

    monkeypatch.setattr(swalign_cuda, "sw_fill", counted_fill)
    monkeypatch.chdir(tmp_path)
    katk_fixture.write_katk_fixture(str(tmp_path), 5, n_regions=6)
    n_regions = len((tmp_path / "regions.txt").read_text().splitlines())
    try:
        with profile() as prof, contextlib.redirect_stdout(io.StringIO()):
            assert gmer_counter.main(katk_fixture.INDEX_ARGS,
                                     device="cpu") == 0
            assert gassembler.main(katk_fixture.ARGS, device="cpu") == 0
    finally:
        (tmp_path / "db.idx").unlink(missing_ok=True)
    rows = trace.rows()
    assert {r.name for r in rows} == INDEX_SPANS | GASSEMBLE_SPANS
    roots = [r for r in rows if r.parent is None]
    assert [r.name for r in roots] == ["count_file", "index_write",
                                       "gassemble"]
    for root in roots:
        assert _coverage(rows, root) >= 0.95, root
    by_id = {r.id: r for r in rows}
    for r in rows:
        if r.name in GASSEMBLE_SPANS - {"gassemble", "sw"}:
            assert by_id[r.parent].name == "gassemble", r
    counted = {}
    for r in rows:
        for name, n in (r.counts or {}).items():
            counted[name] = counted.get(name, 0) + n
    assert counted["katk.regions"] == n_regions
    assert cells and counted["sw.cells"] == sum(cells)
    assert 0 < counted["katk.aligned"] <= counted["katk.reads"]
    names = {e.name for e in prof.events()}
    assert not names & (INDEX_SPANS | GASSEMBLE_SPANS | {"sw_wait"})


def test_debug_lines_keep_their_format(tmp_path, capfd):
    fa = tmp_path / "g.fa"
    _fasta(fa, np.random.default_rng(3))
    port_lm.make_list([str(fa)], K, str(tmp_path / "g.list"),
                      chunk_bases=CHUNK, slab_bytes=SLAB, device="cpu",
                      debug=1)
    err = capfd.readouterr().err.splitlines()
    assert re.fullmatch(r"Words \d+, unique \d+", err[0])
    for line, phase in zip(err[1:], ("Read", "Sort", "Write tmp")):
        m = re.fullmatch(phase + r" (\d+) words at (\d+\.\d\d) "
                         r"\((\d+) words/s\)", line)
        assert m, line
        assert int(m.group(1)) > 0 and int(m.group(3)) > 0
    assert len(err) == 4
    # -D switched recording on for the job only
    assert trace.span("list") is trace.span("parse")
    assert {r.name for r in trace.rows() if r.parent is None} == {"list"}


def _slab_inputs(tmp_path, rng):
    """Files that take every branch of the slab parser."""
    seq = _bases(rng, 3000).tobytes()
    long_line = _bases(rng, 5000).tobytes()
    fq = b"".join(b"@r%d\n%s\n+\n%s\n" % (i, seq[i:i + 90], b"I" * 90)
                  for i in range(40))
    files = {
        "fasta": b">a\n" + b"\n".join(seq[i:i + 70]
                                      for i in range(0, 3000, 70)) + b"\n"
                 + b">b x\n" + seq[:500] + b"\n",
        "crlf": b">a\r\n" + seq[:900] + b"\r\n>b\r\n" + seq[900:1900],
        "long_line": b"\n>a\n" + long_line + b"\n>b\n" + seq[:100],
        "fastq": fq,
        "fastq_tail": fq + b"@t\nACGT\n+\nIIII",
    }
    out = {}
    for name, data in files.items():
        p = tmp_path / f"{name}.txt"
        p.write_bytes(data)
        out[name] = p
        gz = tmp_path / f"{name}.gz"
        gz.write_bytes(gzip.compress(data))
        out[name + ".gz"] = gz
    return out


@pytest.mark.parametrize("slab", [64, 1000, 1 << 20])
def test_slab_parser_equals_the_jax_package(tmp_path, slab):
    """``iter_code_slabs``, split into read, frame and decode, yields the
    JAX package's slabs and metas on every branch, plain and gzip."""
    for name, path in _slab_inputs(tmp_path, np.random.default_rng(5)
                                   ).items():
        want = list(jax_fasta.iter_code_slabs(str(path), 11, slab))
        trace.reset()
        with trace.recording():
            got = list(port_fasta.iter_code_slabs(str(path), 11, slab))
        assert len(got) == len(want), name
        for (gc, gm), (wc, wm) in zip(got, want):
            assert np.array_equal(gc, wc), name
            for f in ("n_records", "total_bases", "count_n", "prefix_len"):
                assert getattr(gm, f) == getattr(wm, f), (name, f)
            for f in ("rec_starts", "name_pos"):
                assert np.array_equal(getattr(gm, f), getattr(wm, f)) \
                    if getattr(wm, f) is not None \
                    else getattr(gm, f) is None, (name, f)
        rows = trace.rows()
        parses = [r for r in rows if r.name == "parse"]
        assert len(parses) >= len(got)
        by_id = {r.id: r for r in rows}
        for r in rows:
            if r.name in ("read", "frame", "decode"):
                assert by_id[r.parent].name == "parse", (name, r)


def test_indexed_reader_records_the_slab_loops_spans(tmp_path):
    """``iter_slabs_indexed`` over a regular FASTQ file records the slab
    loop's spans, read, frame and decode under parse, and reads every slab
    in place."""
    path = _slab_inputs(tmp_path, np.random.default_rng(5))["fastq"]
    trace.reset()
    with trace.recording():
        got = list(port_fasta.iter_slabs_indexed(str(path), 11, 1000))
    assert len(got) > 2 and got[-1][0] is None
    rows = trace.rows()
    by_id = {r.id: r for r in rows}
    names = {r.name for r in rows}
    assert {"parse", "read", "frame", "decode"} <= names
    for r in rows:
        if r.name in ("read", "frame", "decode"):
            assert by_id[r.parent].name == "parse", r
    assert trace.total("parse.slabs") > 2
    assert trace.total("parse.inplace") == trace.total("parse.slabs")


def test_exchange_is_a_wait_span_with_its_bytes():
    def send(n):
        trace.count("exchange.bytes", n)
        return n

    timed = multihost._exchange(send)
    assert timed.__name__ == "send"
    with trace.recording():
        assert timed(96) == 96
    (row,) = trace.rows()
    assert (row.name, row.wait, row.counts) == ("exchange", True,
                                                {"exchange.bytes": 96})
