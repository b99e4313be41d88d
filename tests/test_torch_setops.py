"""Port vs JAX: the set operations of glistcompare (``ops.setops``) on the
CPU. The same sorted unique lists, made from a numpy seed, go through
JAX's jitted ``pair_align``/``apply_pair_op``/``apply_multi_op``, the
port's, and the port's numpy twins (``pipelines.listcompare._host_*``);
the kept words and counts must be equal (integers, tolerance 0)."""

import itertools

import numpy as np
import pytest
import torch

from genometester4_tpu.ops import setops as jax_setops
from genometester4_tpu.ops.encode import join_u64, split_u64
from genometester4_tpu_torch.ops import setops
from genometester4_tpu_torch.ops.encode import keys_from_u64, u64_from_keys
from genometester4_tpu_torch.pipelines import listcompare as port_lc

torch.set_num_threads(1)

OPS = ["union", "intrsec", "diff1", "diff2"]
RULES = ["default", "add", "subtract", "min", "max", "first", "second",
         "number"]
MULTI_RULES = ["default", "add", "min", "max", "number"]
CAP = 1024


def _list(rng, n, space=1 << 14, big=False):
    """A sorted unique list of n words with counts 1-5; ``big``: a third
    of the counts near 2^32, so ADD and the per-run sums wrap."""
    w = np.unique(rng.integers(0, space, n).astype(np.uint64)
                  * np.uint64(0x9E3779B97F4A7C15))
    c = rng.integers(1, 6, len(w)).astype(np.uint32)
    if big:
        hot = rng.random(len(w)) < 0.33
        c[hot] = (0xFFFFFFFF - rng.integers(0, 4, hot.sum())).astype(
            np.uint32)
    return w, c


def _case_lists(case, rng):
    if case == "random":
        return _list(rng, 700), _list(rng, 500)
    if case == "empty_first":
        return _list(rng, 0), _list(rng, 300)
    if case == "empty_both":
        return _list(rng, 0), _list(rng, 0)
    if case == "one_sided":      # disjoint word ranges
        (w1, c1), (w2, c2) = _list(rng, 300), _list(rng, 300)
        return (np.sort(w1 >> np.uint64(1)), c1), \
            (np.sort((w2 >> np.uint64(1)) | np.uint64(1 << 63)), c2)
    if case == "wrap":
        w, c = _list(rng, 600, big=True)
        keep = rng.random(len(w)) < 0.6
        c2 = c.copy()
        c2[rng.random(len(w)) < 0.5] = 0xFFFFFFF0
        return (w[keep], c[keep]), (w, c2)
    raise ValueError(case)


def _jax_pad(w, c):
    hi, lo = split_u64(np.concatenate([w, np.zeros(CAP - len(w), np.uint64)]))
    cc = np.concatenate([c, np.zeros(CAP - len(c), np.uint32)])
    return hi, lo, cc, np.arange(CAP) < len(w)


def _port(w, c):
    return keys_from_u64(w), torch.from_numpy(c.astype(np.int64))


@pytest.fixture(scope="module", params=["random", "empty_first",
                                        "empty_both", "one_sided", "wrap"])
def aligned(request):
    rng = np.random.default_rng(abs(hash(request.param)) % 1000)
    (w1, c1), (w2, c2) = _case_lists(request.param, rng)
    ja = jax_setops.pair_align(*_jax_pad(w1, c1), *_jax_pad(w2, c2))
    pa = setops.pair_align(*_port(w1, c1), *_port(w2, c2))
    return ja, pa, port_lc._host_pair_align(w1, c1, w2, c2)


def test_pair_align_equal(aligned):
    (uhi, ulo, f1, f2, n), (ukeys, pf1, pf2), twin = aligned
    n = int(n)
    assert n == ukeys.numel()
    assert np.array_equal(join_u64(uhi[:n], ulo[:n]), u64_from_keys(ukeys))
    assert np.array_equal(np.asarray(f1[:n], np.int64), pf1.numpy())
    assert np.array_equal(np.asarray(f2[:n], np.int64), pf2.numpy())
    for a, b in zip(twin, (u64_from_keys(ukeys), pf1.numpy(), pf2.numpy())):
        assert np.array_equal(a.astype(np.uint64), b.astype(np.uint64))


@pytest.mark.parametrize("op,rule", list(itertools.product(OPS, RULES)))
def test_apply_pair_op_equal(aligned, op, rule):
    """Every op x rule, at cutoffs 1 and 3 and with -du's subtract; the
    number rule with override 5 and 0 (0 suppresses every word)."""
    ja, (ukeys, f1, f2), (uw, tf1, tf2) = aligned
    for cutoff, subtract, override in ((1, False, 5), (3, False, 5),
                                       (1, True, 0), (3, True, 5),
                                       (1, False, 0)):
        if override == 0 and rule != "number":
            continue
        kw = dict(op=op, rule=rule, cutoff=cutoff, count_override=override,
                  subtract=subtract)
        n, ohi, olo, oc = jax_setops.apply_pair_op(*ja, **kw)
        keys, counts = setops.apply_pair_op(ukeys, f1, f2, **kw)
        n = int(n)
        assert n == keys.numel(), kw
        assert np.array_equal(join_u64(ohi[:n], olo[:n]),
                              u64_from_keys(keys)), kw
        assert np.array_equal(np.asarray(oc[:n], np.int64),
                              counts.numpy()), kw
        tw, tc = port_lc._host_apply_pair_op(uw, tf1, tf2, op, rule, cutoff,
                                             override, subtract)
        assert np.array_equal(tw, u64_from_keys(keys)), kw
        assert np.array_equal(tc.astype(np.int64), counts.numpy()), kw


@pytest.mark.parametrize("n_lists", [3, 4])
@pytest.mark.parametrize("big", [False, True])
def test_apply_multi_op_equal(n_lists, big):
    """N-list union and intersection over every multi rule (the invalid
    ones raise on both sides), cutoffs 1 and 2, overrides 5 and 0; with
    ``big``, sums of counts near 2^32 wrap."""
    rng = np.random.default_rng(n_lists * 2 + big)
    base = _list(rng, 500, space=1 << 10, big=big)
    lists = []
    for _ in range(n_lists):
        keep = rng.random(len(base[0])) < 0.7
        c = base[1][keep].copy()
        c[rng.random(len(c)) < 0.3] = rng.integers(1, 9)
        lists.append((base[0][keep], c))
    w = np.concatenate([x[0] for x in lists])
    c = np.concatenate([x[1] for x in lists])
    src = np.concatenate([np.full(len(x[0]), i, np.uint32)
                          for i, x in enumerate(lists)])
    cap = 1 << int(np.ceil(np.log2(len(w))))
    hi, lo, cc, valid = (np.concatenate([a, np.zeros(cap - len(a), a.dtype)])
                         for a in (*split_u64(w), c, np.ones(len(w), bool)))
    s = np.concatenate([src, np.zeros(cap - len(src), np.uint32)])
    pk, pc = _port(w, c)
    for op, rule, cutoff, override in itertools.product(
            ("union", "intrsec"), MULTI_RULES, (1, 2), (5, 0)):
        if override == 0 and rule != "number":
            continue
        kw = dict(n_lists=n_lists, op=op, rule=rule, cutoff=cutoff,
                  count_override=override)
        n, ohi, olo, oc = jax_setops.apply_multi_op(hi, lo, cc, s, valid, **kw)
        keys, counts = setops.apply_multi_op(pk, pc, **kw)
        n = int(n)
        assert n == keys.numel(), kw
        assert np.array_equal(join_u64(ohi[:n], olo[:n]),
                              u64_from_keys(keys)), kw
        assert np.array_equal(np.asarray(oc[:n], np.int64),
                              counts.numpy()), kw
        tw, tc = port_lc._host_apply_multi_op(w, c, src, n_lists, op, rule,
                                              cutoff, override)
        assert np.array_equal(tw, u64_from_keys(keys)), kw
        assert np.array_equal(tc.astype(np.int64), counts.numpy()), kw
        if big and op == "union" and rule in ("default", "add"):
            # some sums really wrapped
            assert (counts.numpy() < 0xFFFFFFF0).any()
    for rule in ("subtract", "first", "second"):   # no N-list rule
        kw = dict(n_lists=n_lists, op="union", rule=rule)
        with pytest.raises(ValueError):
            jax_setops.apply_multi_op(hi, lo, cc, s, valid, **kw)
        with pytest.raises(ValueError):
            setops.apply_multi_op(pk, pc, **kw)
