"""Port vs JAX: the sorted-table lookups of gmer_counter (``ops.lookup``),
the stream compaction of its index mode (``ops.sortcount.sort_compact``),
and KATK end to end from the port alone: its gassembler on the read index
its own gmer_counter built. The contract is integer: tolerance 0.

JAX's lookups are XLA binary searches over ``(hi, lo)`` uint32 pairs in a
padded table whose first ``n_words`` entries are valid; the port searches
the int64 keys of the valid entries with ``torch.searchsorted``.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from chip_smoke import same_file
from genometester4_tpu.cli import gassembler as jax_gas_cli
from genometester4_tpu.cli import gmer_counter as jax_gc_cli
from genometester4_tpu.ops import lookup as jax_lookup
from genometester4_tpu.ops import sortcount as jax_sortcount
from genometester4_tpu_torch.cli import gassembler as port_gas_cli
from genometester4_tpu_torch.cli import gmer_counter as port_gc_cli
from genometester4_tpu_torch.ops.encode import keys_from_u64, split_u64
from genometester4_tpu_torch.ops.lookup import batched_bounds, batched_lookup
from genometester4_tpu_torch.ops.sortcount import sort_compact
from genometester4_tpu_torch.tools import katk_fixture as kf

torch.set_num_threads(1)

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def _words(rng, n):
    """u64 words over the whole range, 0 and 2^64-1 among them."""
    w = rng.integers(0, 1 << 64, n, dtype=np.uint64, endpoint=False)
    if n >= 2:
        w[0], w[1] = 0, U64_MAX
    return w


def _queries(rng, table):
    """Every table word, its neighbours, random words, 0 and 2^64-1 (past
    either end when the table holds neither)."""
    q = [table, table + np.uint64(1), table - np.uint64(1),
         _words(rng, 64), np.array([0, U64_MAX], np.uint64)]
    return np.concatenate(q).astype(np.uint64)


def _padded(words, pad_to):
    out = np.zeros(pad_to, np.uint64)
    out[:len(words)] = words
    return out


TABLES = {
    "random": lambda rng: np.unique(_words(rng, 300)),
    "inner": lambda rng: np.unique(_words(rng, 300))[1:-1],   # no 0, no max
    "one": lambda rng: np.array([12345], np.uint64),
    "empty": lambda rng: np.zeros(0, np.uint64),
}


@pytest.mark.parametrize("table", sorted(TABLES))
def test_batched_lookup_equals_jax(table):
    rng = np.random.default_rng(5)
    words = TABLES[table](rng)
    codes = rng.integers(1, 1 << 32, len(words), dtype=np.uint64).astype(
        np.uint32)
    q = _queries(rng, words)
    cap = 1024
    thi, tlo = split_u64(_padded(words, cap))
    qhi, qlo = split_u64(q)
    jf, jc, ji = jax_lookup.batched_lookup_pair(
        thi, tlo, _padded(codes, cap).astype(np.uint32), np.int32(len(words)),
        qhi, qlo, steps=jax_lookup.lookup_steps(cap))
    found, code, idx = batched_lookup(
        keys_from_u64(words), torch.from_numpy(codes.view(np.int32)),
        keys_from_u64(q))
    assert np.array_equal(found.numpy(), np.asarray(jf))
    assert np.array_equal(code.numpy().view(np.uint32), np.asarray(jc))
    assert np.array_equal(idx.numpy(), np.asarray(ji))
    if len(words):
        assert found.any() and not found.all()


@pytest.mark.parametrize("table", ["duplicates", "all_equal", "ends",
                                   "empty"])
def test_batched_bounds_equals_jax(table):
    """Lower and upper bounds in a sorted table with repeats: upper - lower
    is each query's number of occurrences."""
    rng = np.random.default_rng(6)
    if table == "duplicates":
        words = np.sort(rng.choice(_words(rng, 50), 400))
    elif table == "all_equal":
        words = np.full(77, 99, np.uint64)
    elif table == "ends":
        words = np.sort(np.concatenate([np.zeros(5, np.uint64),
                                        np.full(7, U64_MAX, np.uint64),
                                        _words(rng, 30)[2:]]))
    else:
        words = np.zeros(0, np.uint64)
    q = _queries(rng, np.unique(words))
    cap = 1024
    thi, tlo = split_u64(_padded(words, cap))
    qhi, qlo = split_u64(q)
    jl, ju = jax_lookup.batched_bounds_pair(
        thi, tlo, np.int32(len(words)), qhi, qlo,
        steps=jax_lookup.lookup_steps(cap))
    lower, upper = batched_bounds(keys_from_u64(words), keys_from_u64(q))
    assert np.array_equal(lower.numpy(), np.asarray(jl))
    assert np.array_equal(upper.numpy(), np.asarray(ju))
    occ = (upper - lower).numpy()
    want = np.array([(words == w).sum() for w in q])
    assert np.array_equal(occ, want)


@pytest.mark.parametrize("n,p", [(1000, 0.3), (257, 0.0), (64, 1.0),
                                 (1, 1.0)])
def test_sort_compact_equals_jax(n, p):
    """The kept entries, in stream order, and their count: JAX's first
    n_kept slots (its tail holds the entries it did not keep)."""
    rng = np.random.default_rng(7)
    mask = rng.random(n) < p
    codes = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    pos = np.arange(n, dtype=np.int32)
    dirs = rng.integers(0, 2, n).astype(np.uint8)
    jn, jc, jp, jd = jax_sortcount.sort_compact(mask, codes, pos, dirs)
    m = int(jn)
    got = sort_compact(torch.from_numpy(mask),
                       torch.from_numpy(codes.view(np.int32)),
                       torch.from_numpy(pos.astype(np.int64)),
                       torch.from_numpy(dirs.astype(bool)))
    assert got[0] == m == mask.sum()
    assert np.array_equal(got[1].numpy().view(np.uint32), np.asarray(jc)[:m])
    assert np.array_equal(got[2].numpy(), np.asarray(jp)[:m])
    assert np.array_equal(got[3].numpy(), np.asarray(jd)[:m].astype(bool))


@contextlib.contextmanager
def _in_dir(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def _run(main, path, args, **kw):
    out, err = io.StringIO(), io.StringIO()
    with _in_dir(path), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        rc = main(args, **kw)
    return rc, out.getvalue(), err.getvalue()


def test_katk_from_the_port_alone(tmp_path, monkeypatch):
    """KATK's chain on the CPU from the port alone (its gmer_counter
    --compile_index, then its gassembler on that index) prints what the
    JAX package's chain (both on their host routes) prints, and the two
    indexes are the same bytes."""
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    for d in (jax_dir, port_dir):
        d.mkdir()
        kf.write_katk_fixture(str(d), seed=21, n_regions=12)
    monkeypatch.setenv("GT4_TPU_DEVICE_SW", "0")
    monkeypatch.setenv("GT4_TPU_COUNT_IMPL", "host")
    try:
        want_idx = _run(jax_gc_cli.main, jax_dir, kf.INDEX_ARGS)
        want = _run(jax_gas_cli.main, jax_dir, kf.ARGS)
        monkeypatch.delenv("GT4_TPU_DEVICE_SW")
        monkeypatch.delenv("GT4_TPU_COUNT_IMPL")
        got_idx = _run(port_gc_cli.main, port_dir, kf.INDEX_ARGS,
                       device="cpu")
        got = _run(port_gas_cli.main, port_dir, kf.ARGS, device="cpu")
        assert want_idx == got_idx and want_idx[0] == 0
        assert want[0] == 0 and want[1].count("\n") > 12
        assert got == want
        assert same_file(jax_dir / "db.idx", port_dir / "db.idx")
    finally:
        for d in (jax_dir, port_dir):
            (d / "db.idx").unlink(missing_ok=True)
