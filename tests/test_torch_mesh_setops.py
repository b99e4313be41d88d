"""Port vs JAX: glistcompare's and gmer_counter's mesh routes on CPU slot
meshes (``make_mesh(devices=["cpu"] * n)``, n in 1, 2, 4).

The port's ``sharded_pair_ops``/``sharded_multi_op``, the mesh branches
of ``compare_pair``/``compare_multi`` and ``DBCounter``'s mesh count must
write what the JAX package writes on one device: its host route for the
set operations (the bytes its device route also writes,
``tests/test_torch_listcompare.py``) and its host route for gmer_counter.
The contract is integer: tolerance 0."""

import numpy as np
import pytest
import torch

from tests.test_torch_gmercounter import CHUNK, data, run_jax, _run  # noqa
from genometester4_tpu.pipelines import listcompare as jax_lc
from genometester4_tpu_torch.cli import gmer_counter as port_cli
from genometester4_tpu_torch.formats.list_format import read_list, write_list
from genometester4_tpu_torch.parallel import sharding
from genometester4_tpu_torch.pipelines import gmercount as port_gc
from genometester4_tpu_torch.pipelines import listcompare as port_lc
from genometester4_tpu_torch.pipelines import listmaker as port_lm

torch.set_num_threads(1)

ALL_OPS = ["union", "intrsec", "diff1", "diff2"]
SLOTS = [1, 2, 4]


def _mesh(n):
    return sharding.make_mesh(devices=["cpu"] * n)


def _write(path, rng, words, big=False):
    c = rng.integers(1, 7, len(words)).astype(np.uint32)
    if big:   # ADD wraps
        c[rng.random(len(words)) < 0.2] = 0xFFFFFFF8
    write_list(str(path), 12, words, c)
    return str(path)


@pytest.fixture(scope="module")
def lists(tmp_path_factory):
    """Four .lists of 12-mers sharing words (counts that wrap under ADD),
    an empty one and a list of three words."""
    d = tmp_path_factory.mktemp("mesh_lists")
    rng = np.random.default_rng(7)
    base = np.unique(rng.integers(0, 1 << 24, 5000).astype(np.uint64))
    paths = [_write(d / f"l{i}_12.list", rng,
                    base[rng.random(len(base)) < 0.6], big=True)
             for i in range(4)]
    empty = _write(d / "empty_12.list", rng, np.empty(0, np.uint64))
    three = _write(d / "three_12.list", rng, base[[5, 900, 4000]])
    return paths, empty, three


def _files(d):
    return {p.name: p.read_bytes() for p in d.iterdir()
            if p.suffix == ".list"}


def _jax_host(monkeypatch, fn, *a, **kw):
    """A JAX listcompare function on its host route (no jax, one device)."""
    monkeypatch.setenv("GT4_TPU_SETOPS_IMPL", "host")
    try:
        return fn(*a, **kw)
    finally:
        monkeypatch.delenv("GT4_TPU_SETOPS_IMPL")


def _pair_both(tmp_path, monkeypatch, a, b, n_slots, **kw):
    jd, pd = tmp_path / "jax", tmp_path / "port"
    jd.mkdir(parents=True)
    pd.mkdir(parents=True)
    rj = _jax_host(monkeypatch, jax_lc.compare_pair, a, b, ALL_OPS,
                   str(jd / "o"), **kw)
    rp = port_lc.compare_pair(a, b, ALL_OPS, str(pd / "o"), device="cpu",
                              mesh=_mesh(n_slots), **kw)
    return rj, rp, _files(jd), _files(pd)


@pytest.mark.parametrize("n_slots", SLOTS)
@pytest.mark.parametrize("rule,subtract,cutoff", [
    ("default", False, 1), ("default", True, 2), ("add", False, 1),
    ("max", False, 3), ("min", False, 1), ("first", False, 2),
    ("second", False, 1), ("number", False, 1)])
def test_compare_pair_mesh_equals_jax(tmp_path, monkeypatch, lists, n_slots,
                                      rule, subtract, cutoff):
    paths, _, _ = lists
    rj, rp, fj, fp = _pair_both(tmp_path, monkeypatch, paths[0], paths[1],
                                n_slots, rule=rule, subtract=subtract,
                                cutoff=cutoff, count_override=4)
    assert rj == rp and len(fj) == 4 and fj == fp


@pytest.mark.parametrize("n_slots", [2, 4])
@pytest.mark.parametrize("which", ["one empty", "both empty", "three words"])
def test_compare_pair_mesh_empty_and_idle_slots(tmp_path, monkeypatch,
                                                lists, n_slots, which):
    """Empty inputs, and three words against an empty list, so that some
    slots get nothing."""
    paths, empty, three = lists
    a, b = {"one empty": (paths[2], empty), "both empty": (empty, empty),
            "three words": (three, empty)}[which]
    for i, (x, y) in enumerate(((a, b), (b, a))):
        rj, rp, fj, fp = _pair_both(tmp_path / str(i), monkeypatch, x, y,
                                    n_slots)
        assert rj == rp and len(fj) == 4 and fj == fp


@pytest.mark.parametrize("n_slots", SLOTS)
def test_sharded_pair_ops_equals_jax(tmp_path, monkeypatch, lists, n_slots):
    """sharded_pair_ops and sharded_pair_op return the words and counts
    JAX's single-device compare_pair writes, one aligned table per slot
    for every op."""
    paths, _, _ = lists
    _jax_host(monkeypatch, jax_lc.compare_pair, paths[1], paths[3], ALL_OPS,
              str(tmp_path / "o"), rule="add")
    _, w1, c1 = read_list(paths[1])
    _, w2, c2 = read_list(paths[3])
    got = sharding.sharded_pair_ops(w1, c1, w2, c2, _mesh(n_slots), ALL_OPS,
                                    rule="add")
    for op in ALL_OPS:
        name = port_lc._op_filename(str(tmp_path / "o"), 12, op)
        _, ww, wc = read_list(name)
        np.testing.assert_array_equal(got[op][0], ww)
        np.testing.assert_array_equal(got[op][1], wc)
        assert got[op][0].dtype == np.uint64 and got[op][1].dtype == np.uint32
    one = sharding.sharded_pair_op(w1, c1, w2, c2, _mesh(n_slots), "diff2",
                                   rule="add")
    np.testing.assert_array_equal(one[0], got["diff2"][0])
    none = sharding.sharded_pair_ops(w1[:0], c1[:0], w2[:0], c2[:0],
                                     _mesh(n_slots), ALL_OPS)
    assert all(len(w) == len(c) == 0 and w.dtype == np.uint64
               for w, c in none.values())


@pytest.mark.parametrize("n_slots", SLOTS)
@pytest.mark.parametrize("op,rule,cutoff", [
    ("union", "default", 1), ("union", "max", 2), ("union", "number", 1),
    ("intrsec", "default", 1), ("intrsec", "add", 3), ("intrsec", "max", 1),
    ("intrsec", "min", 2)])
def test_compare_multi_mesh_equals_jax(tmp_path, monkeypatch, lists, n_slots,
                                       op, rule, cutoff):
    paths, empty, three = lists
    cases = (paths, paths[:3] + [three], [paths[0], empty, paths[1]])
    for i, srcs in enumerate(cases):
        jd, pd = tmp_path / f"jax{i}", tmp_path / f"port{i}"
        jd.mkdir()
        pd.mkdir()
        rj = _jax_host(monkeypatch, jax_lc.compare_multi, srcs, op,
                       str(jd / "o"), cutoff, rule, 3)
        rp = port_lc.compare_multi(srcs, op, str(pd / "o"), cutoff, rule, 3,
                                   device="cpu", mesh=_mesh(n_slots))
        assert rj == rp and _files(jd) == _files(pd)


@pytest.mark.parametrize("n_slots", [2, 4])
def test_sharded_multi_op_equals_jax(tmp_path, monkeypatch, lists, n_slots):
    paths, empty, _ = lists
    _jax_host(monkeypatch, jax_lc.compare_multi, paths, "union",
              str(tmp_path / "o"))
    cols = [read_list(p)[1:] for p in paths]
    w, c = sharding.sharded_multi_op([w for w, _ in cols],
                                     [c for _, c in cols], _mesh(n_slots),
                                     "union")
    _, ww, wc = read_list(str(tmp_path / "o_12_union.list"))
    np.testing.assert_array_equal(w, ww)
    np.testing.assert_array_equal(c, wc)
    _, ew, ec = read_list(empty)
    w, c = sharding.sharded_multi_op([ew, ew], [ec, ec], _mesh(n_slots),
                                     "intrsec")
    assert len(w) == len(c) == 0 and w.dtype == np.uint64


def test_default_mesh_rule(monkeypatch):
    """JAX's rule for compare_pair, compare_multi and DBCounter's count
    mode: the mesh of every card with more than one CUDA card, unless
    GT4_TPU_MESH=0; an explicit mesh= wins. Either way the buckets follow
    the target, at least one a slot."""
    words = [np.arange(0, 4000, 2, dtype=np.uint64),
             np.arange(1, 3000, 3, dtype=np.uint64)]
    two, four = _mesh(2), _mesh(4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(sharding, "make_mesh", lambda: two)
    cuts, slots = port_lc._placement(words, None, None, 500)
    assert slots == two.slots and len(cuts[0]) == 9
    cuts, slots = port_lc._placement(words, "cuda", four, 500)
    assert slots == four.slots and len(cuts[0]) == 9
    cuts, slots = port_lc._placement(words, "cuda", four, 5000)
    assert slots == four.slots and len(cuts[0]) == 5
    cuts, slots = port_lc._placement(words, "cpu", None, 500)
    assert slots == [torch.device("cpu")] and len(cuts[0]) == 9
    monkeypatch.setenv("GT4_TPU_MESH", "0")
    cuts, slots = port_lc._placement(words, "cuda", None, 500)
    assert slots == [torch.device("cuda")] and len(cuts[0]) == 9
    monkeypatch.delenv("GT4_TPU_MESH")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cuts, slots = port_lc._placement(words, "cuda", None, 5000)
    assert slots == [torch.device("cuda")] and len(cuts[0]) == 2


def test_compare_pair_takes_the_default_mesh(tmp_path, monkeypatch, lists):
    """With the default rule's mesh, compare_pair and compare_multi cut
    buckets of the target, at least one a slot, and deal them over the
    slots in turn."""
    paths, _, _ = lists
    calls, parts = [], []
    monkeypatch.setattr(port_lm, "_default_mesh",
                        lambda dev, canonical: _mesh(2))
    bucket_cuts = port_lc.bucket_cuts
    monkeypatch.setattr(port_lc, "bucket_cuts",
                        lambda w, t, n=1: calls.append((t, n))
                        or bucket_cuts(w, t, n))
    run_parts = port_lc._run_parts
    monkeypatch.setattr(port_lc, "_run_parts",
                        lambda run, n, slots, *a: parts.append(
                            (n, len(slots))) or run_parts(run, n, slots, *a))
    port_lc.compare_pair(paths[0], paths[1], ["union"], str(tmp_path / "a"),
                         device="cpu", bucket_target=100)
    port_lc.compare_multi(paths, "union", str(tmp_path / "b"), device="cpu",
                          bucket_target=100)
    assert calls == [(100, 2), (100, 2)]
    assert all(n >= 2 * slots and n % slots == 0 for n, slots in parts)
    assert len(parts) == 2


class _Pass:
    """Records the entries of every device pass of the set operations."""

    def __init__(self, monkeypatch):
        from genometester4_tpu_torch.ops import setops
        self.sizes = []
        align, multi = setops.pair_align, setops.apply_multi_op

        def pair_align(k1, c1, k2, c2):
            self.sizes.append(k1.numel() + k2.numel())
            return align(k1, c1, k2, c2)

        def apply_multi_op(keys, counts, **kw):
            self.sizes.append(keys.numel())
            return multi(keys, counts, **kw)
        monkeypatch.setattr(setops, "pair_align", pair_align)
        monkeypatch.setattr(setops, "apply_multi_op", apply_multi_op)


@pytest.mark.parametrize("n_slots", [2, 4])
@pytest.mark.parametrize("target", [64, 300])
def test_mesh_passes_within_target(tmp_path, monkeypatch, lists, n_slots,
                                   target):
    """A slot's share of the input (total / n_slots) is many times the
    target: every device pass still holds at most target + N entries, and
    the files equal JAX's."""
    paths, _, _ = lists
    total = sum(len(read_list(p)[1]) for p in paths)
    assert total / n_slots > 4 * target
    seen = _Pass(monkeypatch)
    rj, rp, fj, fp = _pair_both(tmp_path / "pair", monkeypatch, paths[0],
                                paths[1], n_slots, bucket_target=target)
    assert rj == rp and fj == fp
    assert len(seen.sizes) > n_slots and max(seen.sizes) <= target + 2
    pair = len(seen.sizes)
    jd, pd = tmp_path / "jax", tmp_path / "port"
    jd.mkdir()
    pd.mkdir()
    rj = _jax_host(monkeypatch, jax_lc.compare_multi, paths, "union",
                   str(jd / "o"))
    rp = port_lc.compare_multi(paths, "union", str(pd / "o"), device="cpu",
                               mesh=_mesh(n_slots), bucket_target=target)
    assert rj == rp and _files(jd) == _files(pd)
    multi = seen.sizes[pair:]
    assert len(multi) > n_slots and max(multi) <= target + len(paths)


def test_run_parts_order_and_overlap():
    """Parts of distinct devices run side by side, a thread a device;
    those of one device one after another, in order; results come back
    in part order."""
    import threading
    slots = ["a", "b", "c"]
    seen = []
    barrier = threading.Barrier(3, timeout=10)

    def run(p, dev):
        assert dev == slots[p % 3]
        if p < 3:   # the first window: all three devices at once
            barrier.wait()
        seen.append((p, dev, threading.get_ident()))
        return p
    assert list(port_lc._run_parts(run, 8, slots)) == list(range(8))
    assert len({t for _, _, t in seen}) > 1
    for dev in slots:
        ps = [p for p, d, _ in seen if d == dev]
        assert ps == sorted(ps)
    one = list(port_lc._run_parts(lambda p, d: (p, d), 5, ["x"] * 4))
    assert one == [(p, "x") for p in range(5)]


@pytest.fixture
def small_chunks(monkeypatch):
    """The port's DBCounter with CHUNK-base chunks; its count_step calls."""
    calls = []
    count_step = port_gc.count_step

    class Small(port_gc.DBCounter):
        def __init__(self, db, **kw):
            super().__init__(db, chunk_bases=CHUNK, **kw)

    def counted(codes, k, db_keys, acc, zero_word):
        calls.append(codes.numel())
        return count_step(codes, k, db_keys, acc, zero_word)
    monkeypatch.setattr(port_gc, "DBCounter", Small)
    monkeypatch.setattr(port_gc, "count_step", counted)
    monkeypatch.delenv("GT4_TPU_COUNT_IMPL", raising=False)
    return calls


@pytest.mark.parametrize("n_slots", SLOTS)
@pytest.mark.parametrize("args", [
    ["--stats", "reads.fq"],
    ["--total", "--unique", "--header", "--distribution", "5", "--stats",
     "reads.fa", "reads.fq.gz"]], ids=["fastq", "flags"])
@pytest.mark.parametrize("k", [11, 25, 32])
def test_gmer_counter_mesh_equals_jax(data, monkeypatch, small_chunks,  # noqa
                                      n_slots, args, k):
    """Count mode on a slot mesh, chunks dealt round-robin (every slot
    gets several): stdout and stderr equal the JAX host route's."""
    argv = ["-db", f"db{k}.txt", *args]
    want = run_jax(monkeypatch, data, argv)
    got = _run(port_cli.main, data, argv, device="cpu", mesh=_mesh(n_slots))
    assert want[0] == 0 and got == want
    assert len(small_chunks) >= 3 * n_slots


def test_gmer_counter_index_mode_ignores_the_mesh(data, monkeypatch,  # noqa
                                                  small_chunks):
    """--compile_index stays on one device with a mesh, as in JAX: the
    same output and index as the JAX host route."""
    from chip_smoke import same_file
    argv = ["-db", "db11.txt", "--compile_index", "p.idx", "reads.fq"]
    got = _run(port_cli.main, data, argv, device="cpu", mesh=_mesh(4))
    want = run_jax(monkeypatch, data, argv[:3] + ["j.idx"] + argv[4:])
    try:
        assert got == want and want[0] == 0 and not small_chunks
        assert same_file(data / "p.idx", data / "j.idx")
    finally:
        for f in ("p.idx", "j.idx"):
            (data / f).unlink(missing_ok=True)


def test_db_counter_default_mesh(data, monkeypatch):  # noqa
    """DBCounter takes the default rule's mesh in count mode only."""
    from genometester4_tpu_torch.formats.gmerdb import load_text_db
    db = load_text_db(str(data / "db11.txt"))
    monkeypatch.setattr(port_lm, "_default_mesh",
                        lambda dev, canonical: _mesh(2))
    monkeypatch.delenv("GT4_TPU_COUNT_IMPL", raising=False)
    assert port_gc.DBCounter(db, device="cpu")._slots == _mesh(2).slots
    assert port_gc.DBCounter(db, device="cpu",
                             build_index=True)._slots == [torch.device("cpu")]
