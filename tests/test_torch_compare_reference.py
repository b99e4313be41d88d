"""The benchmark's plain set-operation reference
(``gt4bench/reference/setops.py``) against the port's CPU route of
``compare_pair``: every op under every rule, the u32 wrap of ADD, empty
and disjoint lists, cutoffs, and inputs cut into several buckets; and the
reference's sample list against the port's glistmaker of the same reads."""

import numpy as np
import pytest
import torch

from genometester4_tpu_torch.formats.list_format import read_list, write_list
from genometester4_tpu_torch.pipelines import listcompare as lc
from gt4bench.reference import setops as ref

torch.set_num_threads(1)

K = 25
OPS = ["union", "intrsec", "diff1", "diff2"]
RULES = ["default", "add", "subtract", "min", "max", "first", "second",
         "number"]
U32_MAX = 0xFFFFFFFF


def _draw(rng, n, shared=0.5, high=50):
    """Two sorted unique lists of about ``n`` words sharing about
    ``shared`` of them, counts in [1, high)."""
    pool = np.unique(rng.integers(0, 1 << 50, 3 * n, dtype=np.uint64))
    both = rng.choice(pool, int(shared * n), replace=False)
    rest = np.setdiff1d(pool, both)
    rng.shuffle(rest)
    m = (n - len(both))
    lists = []
    for part in (rest[:m], rest[m:2 * m]):
        w = np.sort(np.concatenate([both, part]))
        lists.append((w, rng.integers(1, high, len(w)).astype(np.uint32)))
    return lists


def _files(tmp_path, lists):
    paths = []
    for i, (w, c) in enumerate(lists):
        p = tmp_path / f"in{i}_{K}.list"
        write_list(str(p), K, np.asarray(w, np.uint64),
                   np.asarray(c, np.uint32))
        paths.append(str(p))
    return paths


def _port(tmp_path, lists, bucket_target=lc.DEFAULT_BUCKET, **kw):
    paths = _files(tmp_path, lists)
    out = tmp_path / "out"
    lc.compare_pair(paths[0], paths[1], OPS, str(out), device="cpu",
                    bucket_target=bucket_target, **kw)
    got = {}
    for op in OPS:
        _, w, c = read_list(lc._op_filename(str(out), K, op))
        got[op] = (np.asarray(w, np.uint64), np.asarray(c, np.uint32))
    return got


def _ref(lists, **kw):
    t = [torch.from_numpy(np.asarray(a).astype(np.int64)) for w, c in lists
         for a in (w, c)]
    out = ref.set_ops(*t, **kw)
    return {op: (w.numpy().astype(np.uint64), c.numpy().astype(np.uint32))
            for op, (w, c) in out.items()}


def _same(got, want):
    for op in OPS:
        assert np.array_equal(got[op][0], want[op][0]), op
        assert np.array_equal(got[op][1], want[op][1]), op


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("seed", [1, (1 << 31) + 7])
def test_every_op_and_rule(tmp_path, rule, seed):
    lists = _draw(np.random.default_rng(seed), 3000)
    got = _port(tmp_path, lists, rule=rule, count_override=7)
    want = _ref(lists, rule=rule, number=7)
    _same(got, want)
    if rule == "default":
        assert all(len(want[op][0]) for op in OPS)


@pytest.mark.parametrize("cutoff", [2, 10])
def test_cutoffs(tmp_path, cutoff):
    lists = _draw(np.random.default_rng(5), 3000, high=20)
    _same(_port(tmp_path, lists, cutoff=cutoff), _ref(lists, cutoff=cutoff))


def test_add_wraps_as_a_u32(tmp_path):
    w = np.arange(10, 70, 3, dtype=np.uint64)
    c1 = np.full(len(w), U32_MAX, np.uint32)
    c2 = np.arange(1, len(w) + 1, dtype=np.uint32)
    lists = [(w, c1), (w, c2)]
    got, want = _port(tmp_path, lists), _ref(lists)
    _same(got, want)
    # 2^32 - 1 + 1 wraps to 0, which leaves the word out of the union
    assert len(want["union"][0]) == len(w) - 1
    assert int(want["union"][1][0]) == 1


@pytest.mark.parametrize("which", ["first", "second", "both"])
def test_empty_lists(tmp_path, which):
    (w1, c1), (w2, c2) = _draw(np.random.default_rng(3), 500)
    empty = (np.zeros(0, np.uint64), np.zeros(0, np.uint32))
    lists = {"first": [empty, (w2, c2)], "second": [(w1, c1), empty],
             "both": [empty, empty]}[which]
    _same(_port(tmp_path, lists), _ref(lists))


def test_disjoint_lists(tmp_path):
    lists = _draw(np.random.default_rng(4), 2000, shared=0.0)
    want = _ref(lists)
    _same(_port(tmp_path, lists), want)
    assert len(want["intrsec"][0]) == 0
    assert len(want["union"][0]) == len(lists[0][0]) + len(lists[1][0])


@pytest.mark.parametrize("target", [64, 500])
def test_several_buckets(tmp_path, monkeypatch, target):
    lists = _draw(np.random.default_rng(6), 4000)
    parts = []
    run_parts = lc._run_parts
    monkeypatch.setattr(lc, "_run_parts", lambda run, n, *a: parts.append(n)
                        or run_parts(run, n, *a))
    _same(_port(tmp_path, lists, bucket_target=target), _ref(lists))
    assert parts[0] >= 8000 // target


def test_reads_list_is_glistmaker_of_the_reads(tmp_path):
    """The reference's list of a few reads equals the port's glistmaker of
    their FASTQ, canonical; the forward-strand list differs."""
    from genometester4_tpu_torch.pipelines.listmaker import make_list
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 4, (40, 150)).astype(np.uint8)
    fq = tmp_path / "r.fq"
    bases = np.frombuffer(b"ACGT", np.uint8)[codes]
    fq.write_bytes(b"".join(b"@r%d\n%s\n+\n%s\n" % (i, row.tobytes(),
                                                      b"I" * 150)
                            for i, row in enumerate(bases)))
    out = tmp_path / "r.list"
    make_list([str(fq)], K, str(out), device="cpu")
    _, w, c = read_list(str(out))
    rw, rc = ref.reads_list(codes, K, "cpu", block_rows=7)
    assert np.array_equal(np.asarray(w, np.uint64),
                          rw.numpy().astype(np.uint64))
    assert np.array_equal(np.asarray(c, np.uint32),
                          rc.numpy().astype(np.uint32))
    fw, _ = ref.reads_list(codes, K, "cpu", canonical=False)
    assert not torch.equal(fw, rw)
