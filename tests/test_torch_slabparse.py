"""The in-place host parse behind ``io.fasta.iter_code_slabs`` and
``iter_slabs_indexed``: the one-call FASTQ frame and decode
(``csrc/slabparse.c``) against the JAX package's native
``fgx_parse_fastq_slab`` and ``parse_fastq`` and against the JAX
package's slab streams, with the pieces' seams on every byte, and the
reader's pooled buffer: its read calls, its ownership and the stream
inputs it leaves to the old reader."""

import ctypes
import gzip
import io
import sys

import numpy as np
import pytest

from genometester4_tpu.io import fasta as jax_fasta
from genometester4_tpu_torch.io import fasta as port_fasta
from genometester4_tpu_torch.utils import trace
from genometester4_tpu_torch.utils.native import get_lib

SLABS = (7, 64, 4096, 1 << 20)
# bytes per piece: 1 puts a seam on every byte offset of the input
PIECES = (0, 1, 2, 3, 5, 16, 61)
MESSY = np.frombuffer(b"ACGTACGTACGTNacgtnUuRY.", np.uint8)


def _fastq(rng, n, lo=0, hi=120, eol=b"\n"):
    recs = []
    for i in range(n):
        seq = rng.choice(MESSY, int(rng.integers(lo, hi + 1))).tobytes()
        recs.append(b"@r%d x%s%s%s+%s%s%s" % (i, eol, seq, eol, eol,
                                             b"I" * len(seq), eol))
    return b"".join(recs)


def _exact(rng, size):
    """A FASTQ file of exactly ``size`` bytes: reads, then one record whose
    name fills the rest."""
    if size < 16:
        return b"@\nA\n+\nI"[:size]
    body = _fastq(rng, 0)
    while size - len(body) > 400:
        body += _fastq(rng, 1, 50, 150)
    pad = size - len(body) - len(b"@\nACGT\n+\nIIII\n")
    return body + b"@" + b"n" * pad + b"\nACGT\n+\nIIII\n"


def _inputs(slab):
    rng = np.random.default_rng(11)
    fq = _fastq(rng, 40)
    return {
        "plain": fq,
        "crlf": _fastq(rng, 30, eol=b"\r\n"),
        "empty_lines": (b"@e\n\n+\n\n" + fq[:300] + b"\n\n" + fq[300:]
                        + b"@f\r\n\r\n+\r\n\r\n"),
        "no_trailing_newline": fq.rstrip(b"\n"),
        "truncated_two_lines": fq + b"@t\nACG",
        "truncated_three_lines": fq + b"@t\nACGT\n+\n",
        "leading_blank": b" \n\r\n\t" + fq,
        "long_group": (fq[:2000] + b"@long\n" + b"ACGTN" * 1000 + b"\n+\n"
                       + b"I" * 5000 + b"\n" + fq[2000:]),
        "exact_slab": _exact(rng, min(slab, 1 << 14)),
    }


def _fgx(data: bytes):
    """The JAX package's native FASTQ slab parse of ``data``."""
    raw = np.frombuffer(data, np.uint8)
    codes = np.empty(len(raw) + 1, np.uint8)
    cap = len(raw) // 4 + 2
    rs, npos = np.empty(cap, np.int64), np.empty(cap, np.int64)
    m, tb, cn = ctypes.c_long(), ctypes.c_long(), ctypes.c_long()
    nrec = get_lib().fgx_parse_fastq_slab(
        raw, len(raw), codes, ctypes.byref(m), rs, npos, ctypes.byref(tb),
        ctypes.byref(cn))
    return codes[:m.value], rs[:nrec], npos[:nrec], tb.value, cn.value


def _whole_groups(data: bytes, at_eof: bool) -> int:
    """The end of the last whole 4-line group: lines end at '\\n', and at
    EOF a last segment that is not empty is a line too."""
    lines = data.split(b"\n")
    ends = [len(x) + 1 for x in lines[:-1]]
    if at_eof and lines[-1]:
        ends.append(len(lines[-1]))
    return sum(ends[:len(ends) // 4 * 4])


def _collect(fn, path, slab):
    """The slabs of ``fn`` and the error that ended them, if any."""
    out, err = [], None
    try:
        for codes, meta in fn(str(path), 11, slab):
            out.append((codes, meta))
    except ValueError as e:
        err = str(e)
    return out, err


def _assert_same_slabs(got, want, what):
    assert len(got) == len(want), what
    for (gc, gm), (wc, wm) in zip(got, want):
        assert np.array_equal(gc, wc), what
        for f in ("n_records", "total_bases", "count_n", "prefix_len"):
            assert getattr(gm, f) == getattr(wm, f), (what, f)
        for f in ("rec_starts", "name_pos"):
            if getattr(wm, f) is None:
                assert getattr(gm, f) is None, (what, f)
            else:
                assert np.array_equal(getattr(gm, f), getattr(wm, f)), \
                    (what, f)


@pytest.mark.parametrize("slab", SLABS)
@pytest.mark.parametrize("name", list(_inputs(64)))
def test_fastq_frame_decode_equals_the_jax_package(tmp_path, name, slab):
    """The one native call, at every piece seam, gives
    ``fgx_parse_fastq_slab``'s codes, records and names over the whole
    groups it consumes; ``iter_code_slabs`` over the file gives the JAX
    package's slabs, metas and errors."""
    data = _inputs(slab)[name]
    for at_eof in (False, True):
        cut = _whole_groups(data, at_eof)
        codes, rs, npos, tb, cn = _fgx(data if at_eof else data[:cut])
        if len(rs):
            parsed = jax_fasta.parse_fastq(data if at_eof else data[:cut])
            name_end = parsed._name_spans[:, 1]
            seq_len = parsed._seq_raw_lengths
        else:
            name_end = seq_len = np.zeros(0, np.int64)
        for piece in PIECES:
            used, gc, meta = port_fasta._fastq_frame_decode(
                data, at_eof, 1000, piece)
            what = (name, at_eof, piece)
            assert used == cut, what
            assert np.array_equal(gc, codes), what
            assert np.array_equal(meta.rec_starts, rs), what
            assert np.array_equal(meta.name_pos, npos + 1000), what
            assert np.array_equal(meta.name_end, name_end + 1000), what
            assert np.array_equal(meta.seq_len, seq_len), what
            assert (meta.n_records, meta.total_bases, meta.count_n) == \
                (len(rs), tb, cn), what
    path = tmp_path / f"{name}.fq"
    path.write_bytes(data)
    got, got_err = _collect(port_fasta.iter_code_slabs, path, slab)
    want, want_err = _collect(jax_fasta.iter_code_slabs, path, slab)
    assert got_err == want_err, name
    _assert_same_slabs(got, want, name)


def test_fastq_frame_decode_threads_equal_one_piece():
    """A slab large enough to split across threads decodes as one piece
    does and as ``fgx_parse_fastq_slab`` does, at EOF and before it."""
    rng = np.random.default_rng(3)
    data = _fastq(rng, 40_000, 0, 300) + _fastq(rng, 10_000, 0, 300,
                                                 eol=b"\r\n") + b"@t\nAC"
    assert len(data) >= 1 << 23
    for at_eof in (False, True):
        cut = _whole_groups(data, at_eof)
        codes, rs, npos, tb, cn = _fgx(data if at_eof else data[:cut])
        for piece in (0, len(data), 1_000_003):
            used, gc, meta = port_fasta._fastq_frame_decode(
                data, at_eof, 0, piece)
            assert used == cut
            assert np.array_equal(gc, codes)
            assert np.array_equal(meta.rec_starts, rs)
            assert np.array_equal(meta.name_pos, npos)
            assert (meta.total_bases, meta.count_n) == (tb, cn)


def test_short_records_size_the_record_arrays_again():
    """Records shorter than the first bound's 32 bytes take a second call
    with arrays of the exact count."""
    data = b"@\nA\n+\nI\n" * 1000
    used, codes, meta = port_fasta._fastq_frame_decode(data, False, 0)
    assert used == len(data) and meta.n_records == 1000
    assert np.array_equal(meta.rec_starts, np.arange(1000) * 2)
    assert np.array_equal(codes, np.tile(np.array([0, 255], np.uint8), 1000))


def _fasta(rng, n_bytes):
    seq = rng.choice(MESSY[:13], n_bytes).tobytes()
    lines = [seq[i:i + 70] for i in range(0, len(seq), 70)]
    return b">a one\n" + b"\n".join(lines[:len(lines) // 2]) + b"\n>b\n" \
        + b"\n".join(lines[len(lines) // 2:]) + b"\n"


def _fasta_inputs(slab):
    """FASTA files for the indexed reader; "seam" puts a record's end on
    the first seam and a slab of two bases (fewer than k - 1) behind it."""
    rng = np.random.default_rng(19)
    s = min(slab, 1 << 14)
    seq = rng.choice(MESSY[:13], 6000).tobytes()
    wrapped = b"".join(b">r%d desc\n" % i + b"\n".join(
        seq[j:j + 60] for j in range(i * 500, i * 500 + 80 * i + 30, 60))
        + b"\n" for i in range(8))
    return {
        "wrapped": wrapped,
        "seam": (b">a\n" + seq[:s - 4] + b"\n" + b">" + b"n" * (s - 5)
                 + b"\nAC\n>c\n" + seq[:200] + b"\n>d\n" + seq[200:300]),
        "crlf_empty_blank": (b" \n\r\n\t" + wrapped.replace(b"\n", b"\r\n")
                             + b">e\r\n>f\r\n" + seq[:90] + b"\r\n>g\r\n"),
        "long_line": b">a\n" + seq + seq + b"\n>b\n" + seq[:100],
    }


def _collect_indexed(fn, path, slab):
    out, err = [], None
    try:
        for codes, meta in fn(str(path), 11, slab):
            out.append((codes, meta))
    except ValueError as e:
        err = str(e)
    return out, err


@pytest.mark.parametrize("slab", SLABS)
@pytest.mark.parametrize("name", list(_fasta_inputs(64)) + list(_inputs(64)))
def test_indexed_reader_equals_the_jax_package(tmp_path, name, slab):
    """``iter_slabs_indexed`` over the slab loop gives the JAX package's
    codes, every ``IdxSlabMeta`` field, its ``IdxStreamEnd`` and its
    errors (a FASTA line longer than a slab), plain and gzip."""
    inputs = {**_fasta_inputs(slab), **_inputs(slab)}
    data = inputs[name]
    for path, raw in ((tmp_path / name, data),
                      (tmp_path / f"{name}.gz", gzip.compress(data))):
        path.write_bytes(raw)
        got, got_err = _collect_indexed(port_fasta.iter_slabs_indexed,
                                        path, slab)
        want, want_err = _collect_indexed(jax_fasta.iter_slabs_indexed,
                                          path, slab)
        what = (path.name, slab)
        assert got_err == want_err, what
        if name == "long_line" and slab <= 4096 and raw is data:
            assert want_err == "iter_slabs_indexed: line longer than a slab"
        assert len(got) == len(want), what
        for (gc, gm), (wc, wm) in zip(got, want):
            assert type(gm).__name__ == type(wm).__name__, what
            if wc is None:
                assert gc is None, what
            else:
                assert np.array_equal(gc, wc), what
            for f, w in vars(wm).items():
                g = getattr(gm, f)
                if isinstance(w, np.ndarray):
                    assert isinstance(g, np.ndarray) and g.dtype == w.dtype \
                        and np.array_equal(g, w), (what, f)
                else:
                    assert g == w, (what, f)


class _CountingFile(io.FileIO):
    reads = 0

    def readinto(self, b):
        _CountingFile.reads += 1
        return super().readinto(b)


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
def test_three_slabs_take_three_reads(tmp_path, monkeypatch, fmt):
    """A file of three slabs is read by three ``readinto`` calls, all in
    place, and none at EOF."""
    slab = 4096
    rng = np.random.default_rng(7)
    data = _fasta(rng, 3 * slab) if fmt == "fasta" else _exact(rng, 10_000)
    data = data[:3 * slab - 10]
    assert 2 * slab < len(data) <= 3 * slab
    path = tmp_path / "three"
    path.write_bytes(data)
    monkeypatch.setattr(port_fasta, "open",
                        lambda p, mode, buffering: _CountingFile(p, mode),
                        raising=False)
    _CountingFile.reads = 0
    trace.reset()
    got, got_err = _collect(port_fasta.iter_code_slabs, path, slab)
    want, want_err = _collect(jax_fasta.iter_code_slabs, path, slab)
    assert got_err == want_err
    _assert_same_slabs(got, want, fmt)
    assert _CountingFile.reads == 3
    assert trace.total("parse.slabs") == 3
    assert trace.total("parse.inplace") == 3


class _RecordingPool(port_fasta._BufferPool):
    def __init__(self):
        super().__init__()
        self.taken = []

    def take(self, n):
        buf = super().take(n)
        self.taken.append(buf)
        return buf


def test_live_readers_never_share_a_buffer(tmp_path, monkeypatch):
    """Two live readers hold two buffers; when they end both go back to the
    pool, and the next reader reuses one."""
    pool = _RecordingPool()
    monkeypatch.setattr(port_fasta, "_BUFFERS", pool)
    rng = np.random.default_rng(9)
    a, b = tmp_path / "a.fq", tmp_path / "b.fa"
    a.write_bytes(_fastq(rng, 200))
    b.write_bytes(_fasta(rng, 20_000))
    ga = port_fasta.iter_code_slabs(str(a), 11, 1000)
    gb = port_fasta.iter_code_slabs(str(b), 11, 1000)
    next(ga)
    next(gb)
    assert len(pool.taken) == 2 and pool.taken[0] is not pool.taken[1]
    list(ga)
    list(gb)
    assert len(pool._free) == 2
    held = {id(x) for x in pool.taken}
    list(port_fasta.iter_code_slabs(str(a), 11, 1000))
    assert id(pool.taken[-1]) in held


def test_collected_slabs_stay_the_callers(tmp_path):
    """Slabs kept with ``list(...)`` share nothing with the reused buffer:
    they equal the JAX package's after other files were read through
    it."""
    rng = np.random.default_rng(13)
    files = []
    for name, data in (("a.fq", _fastq(rng, 150)), ("b.fa", _fasta(rng,
                                                                  30_000)),
                       ("c.fq", _fastq(rng, 150, eol=b"\r\n"))):
        path = tmp_path / name
        path.write_bytes(data)
        files.append(path)
    kept = [list(port_fasta.iter_code_slabs(str(p), 11, 2000))
            for p in files + files]
    for p, got in zip(files + files, kept):
        want = list(jax_fasta.iter_code_slabs(str(p), 11, 2000))
        _assert_same_slabs(got, want, p.name)


@pytest.mark.parametrize("source", ["stdin", "gzip"])
def test_streams_keep_the_old_reader(tmp_path, monkeypatch, source):
    """stdin and gzip yield the JAX package's slabs through the stream
    reader: every slab counted, none in place."""
    rng = np.random.default_rng(17)
    for name, data in (("fq", _fastq(rng, 120) + b"@t\nACGT\n+\nIIII"),
                       ("fa", _fasta(rng, 12_000))):
        plain = tmp_path / f"x.{name}"
        plain.write_bytes(data)
        if source == "stdin":
            # stdin's slabs are the plain file's: read(1500) each
            want = list(jax_fasta.iter_code_slabs(str(plain), 11, 1500))
            monkeypatch.setattr(sys, "stdin",
                                type("In", (), {"buffer": io.BytesIO(data)}))
            path = "-"
        else:
            path = str(tmp_path / f"x.{name}.gz")
            with open(path, "wb") as f:
                f.write(gzip.compress(data))
            want = list(jax_fasta.iter_code_slabs(path, 11, 1500))
        trace.reset()
        got = list(port_fasta.iter_code_slabs(path, 11, 1500))
        _assert_same_slabs(got, want, (source, name))
        assert trace.total("parse.slabs") > 0
        assert trace.total("parse.inplace") == 0
