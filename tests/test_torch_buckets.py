"""The merge and set-operation buckets of the port are cut at the quantiles
of the inputs' combined rank, so each bucket holds at most its target plus
one entry per input, whatever range the words span (a k-mer word of
k < 32 lies below 2^(2k): cut at multiples of 2^64 / n, every word fell
into the first bucket). Checked on the CPU: the number of buckets, each
bucket's entries (the device calls are recorded), the merged words
against numpy, and the ``.list`` bytes against the JAX package's."""

import numpy as np
import pytest
import torch

from tests.conftest import random_fasta
from genometester4_tpu.pipelines import listcompare as jax_lc
from genometester4_tpu.pipelines import listmaker as jax_listmaker
from genometester4_tpu_torch.formats.list_format import write_list
from genometester4_tpu_torch.ops import setops
from genometester4_tpu_torch.pipelines import listcompare as port_lc
from genometester4_tpu_torch.pipelines import listmaker as port_lm

torch.set_num_threads(1)

U64_MAX = (1 << 64) - 1


def _shards(rng, n_shards, size, lo, hi):
    """Sorted unique words in [lo, hi) with counts, one array per shard;
    some words in several shards, and counts near 2^32 (their sums
    wrap). With hi past 2^63 the first shard's ends become the words 0
    and 2^64 - 1, so the words span the whole u64 range."""
    common = rng.integers(lo, hi, size // 2, dtype=np.uint64,
                          endpoint=False)
    out = []
    for _ in range(n_shards):
        w = np.unique(np.concatenate([
            rng.choice(common, size // 4),
            rng.integers(lo, hi, size, dtype=np.uint64, endpoint=False)]))
        c = rng.integers(1, 9, len(w)).astype(np.uint32)
        c[rng.random(len(w)) < 0.05] = 0xFFFFFFF0
        out.append((w, c))
    if hi > 1 << 63:
        out[0][0][[0, -1]] = [0, U64_MAX]
    return out


def _oracle(shards):
    w = np.concatenate([w for w, _ in shards])
    c = np.concatenate([c for _, c in shards]).astype(np.uint64)
    uw, inv = np.unique(w, return_inverse=True)
    sums = np.zeros(len(uw), np.uint64)
    np.add.at(sums, inv, c)
    return uw, (sums & np.uint64(0xFFFFFFFF)).astype(np.uint32)


@pytest.fixture
def bucket_sizes(monkeypatch):
    """The entries of each weighted count_unique call: the merge's (a
    chunk's count has no weights)."""
    sizes = []
    count_unique = port_lm.count_unique

    def recorded(keys, weights=None, **kw):
        if weights is not None:
            sizes.append(keys.numel())
        return count_unique(keys, weights, **kw)
    monkeypatch.setattr(port_lm, "count_unique", recorded)
    return sizes


# (name, word range): k = 25 and k = 31 words, every word in a range of
# 2^20 (skew), and k = 32 words that span the whole u64 range but lie,
# but for its two ends, in a range of 2^30
CASES = {"k25": (0, 1 << 50), "k31": (0, 1 << 62),
         "skew": ((1 << 49) + 12345, (1 << 49) + 12345 + (1 << 20)),
         "k32": ((1 << 63) + 999, (1 << 63) + 999 + (1 << 30))}


@pytest.mark.parametrize("n_shards", [2, 5])
@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_buckets_bounded(rng, bucket_sizes, case, n_shards):
    lo, hi = CASES[case]
    shards = _shards(rng, n_shards, 3000, lo, hi)
    target = 700
    out = list(port_lm.merge_sorted_shards(shards, target_bucket=target,
                                           device="cpu"))
    total = sum(len(w) for w, _ in shards)
    assert len(out) >= total // target
    assert bucket_sizes and max(bucket_sizes) <= target + n_shards
    want = _oracle(shards)
    np.testing.assert_array_equal(np.concatenate([w for w, _ in out]),
                                  want[0])
    np.testing.assert_array_equal(np.concatenate([c for _, c in out]),
                                  want[1])


def test_merge_bucket_rule_keeps_power_of_two(rng, bucket_sizes):
    """n = 2^ceil(log2(total / target)) buckets: 4 shards of 1,000 words
    with a target of 256 make 16 buckets of 250 entries."""
    shards = [(np.unique(rng.integers(0, 1 << 50, 1200).astype(np.uint64))
               [:1000], np.ones(1000, np.uint32)) for _ in range(4)]
    out = list(port_lm.merge_sorted_shards(shards, target_bucket=256,
                                           device="cpu"))
    assert len(out) == len(bucket_sizes) == 16
    assert max(bucket_sizes) <= 256 + 4


@pytest.mark.parametrize("k", [25, 31, 32])
def test_make_list_buckets_byte_identical(tmp_path, monkeypatch,
                                          bucket_sizes, k):
    """make_list with 4,096-base chunks and a merge target of 2,000: many
    buckets, each bounded, and the JAX package's .list bytes."""
    monkeypatch.setenv("GT4_TPU_COUNT_IMPL", "device")
    monkeypatch.setenv("GT4_TPU_MESH", "0")
    rng = np.random.default_rng(k)
    fa = tmp_path / "in.fa"
    fa.write_text(random_fasta(rng, n_records=5, min_len=3000,
                               max_len=9000, n_prob=0.01))
    target, n_shards = 2000, []
    merge = port_lm.merge_sorted_shards

    def small(shards, device=None):
        n_shards.append(len(shards))
        return merge(shards, target_bucket=target, device=device)
    monkeypatch.setattr(port_lm, "merge_sorted_shards", small)
    jax_listmaker.make_list([str(fa)], k, str(tmp_path / "jax.list"),
                            chunk_bases=4096)
    port_lm.make_list([str(fa)], k, str(tmp_path / "port.list"),
                      chunk_bases=4096, device="cpu")
    assert len(bucket_sizes) >= 4
    assert max(bucket_sizes) <= target + n_shards[0]
    assert ((tmp_path / "port.list").read_bytes()
            == (tmp_path / "jax.list").read_bytes())


def _lists(tmp_path, rng, k, n_lists, lo, hi):
    paths = []
    for i, (w, c) in enumerate(_shards(rng, n_lists, 1500, lo, hi)):
        paths.append(str(tmp_path / f"l{i}_{k}.list"))
        write_list(paths[-1], k, w, c)
    return paths


@pytest.fixture
def device_calls(monkeypatch):
    """The words each device pass of the set operations takes."""
    sizes = []
    pair_align, apply_multi_op = setops.pair_align, setops.apply_multi_op

    def align(k1, c1, k2, c2):
        sizes.append(k1.numel() + k2.numel())
        return pair_align(k1, c1, k2, c2)

    def multi(keys, *a, **kw):
        sizes.append(keys.numel())
        return apply_multi_op(keys, *a, **kw)
    monkeypatch.setattr(setops, "pair_align", align)
    monkeypatch.setattr(setops, "apply_multi_op", multi)
    monkeypatch.setenv("GT4_TPU_MESH", "0")
    monkeypatch.delenv("GT4_TPU_SETOPS_IMPL", raising=False)
    return sizes


def _files(d):
    return {p.name: p.read_bytes() for p in d.iterdir()
            if p.suffix == ".list"}


@pytest.mark.parametrize("case", ["k25", "skew", "k32"])
def test_compare_pair_buckets_bounded(tmp_path, rng, device_calls, case):
    a, b = _lists(tmp_path, rng, 25, 2, *CASES[case])
    ops = ["union", "intrsec", "diff1", "diff2"]
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    rj = jax_lc.compare_pair(a, b, ops, str(tmp_path / "j" / "o"),
                             rule="add", bucket_target=400)
    rp = port_lc.compare_pair(a, b, ops, str(tmp_path / "p" / "o"),
                              rule="add", bucket_target=400, device="cpu")
    assert len(device_calls) >= 4 and max(device_calls) <= 400 + 2
    assert rp == rj
    assert _files(tmp_path / "p") == _files(tmp_path / "j")


@pytest.mark.parametrize("op,rule", [("union", "default"),
                                     ("intrsec", "max")])
@pytest.mark.parametrize("case", ["k25", "skew", "k32"])
def test_compare_multi_buckets_bounded(tmp_path, rng, device_calls, case,
                                       op, rule):
    paths = _lists(tmp_path, rng, 25, 4, *CASES[case])
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    rj = jax_lc.compare_multi(paths, op, str(tmp_path / "j" / "o"), 1, rule,
                              bucket_target=900)
    rp = port_lc.compare_multi(paths, op, str(tmp_path / "p" / "o"), 1,
                               rule, bucket_target=900, device="cpu")
    assert len(device_calls) >= 4 and max(device_calls) <= 900 + 4
    assert rp == rj
    assert _files(tmp_path / "p") == _files(tmp_path / "j")


def test_word_rank_on_a_list_mmap(tmp_path, rng):
    """word_rank searches the strided, unaligned word column of a .list
    mmap in place and agrees with np.searchsorted."""
    from genometester4_tpu_torch.formats.list_format import read_list
    w = np.unique(rng.integers(0, U64_MAX, 5000, dtype=np.uint64))
    write_list(str(tmp_path / "x.list"), 32, w, np.ones(len(w), np.uint32))
    _, mw, _ = read_list(str(tmp_path / "x.list"))
    assert not mw.flags.c_contiguous
    q = np.concatenate([w[::7], w[::11] + np.uint64(1),
                        np.array([0, U64_MAX], np.uint64)])
    np.testing.assert_array_equal(port_lc.word_rank(mw, q),
                                  np.searchsorted(w, q))
    np.testing.assert_array_equal(
        port_lc.word_rank(np.empty(0, np.uint64)[::1], q[:3]), [0, 0, 0])


@pytest.mark.parametrize("n_values", [1, 64, 128, 129])
def test_word_rank_bounds_on_a_list_mmap(tmp_path, rng, n_values):
    """Both searches of a strided word column, on either side of 128
    values (bisections below, the vectorized search above), agree with
    np.searchsorted, the bounds 0 and 2^64 - 1 included."""
    from genometester4_tpu_torch.formats.list_format import read_list
    w = np.unique(rng.integers(0, U64_MAX, 20_000, dtype=np.uint64))
    write_list(str(tmp_path / "x.list"), 32, w, np.ones(len(w), np.uint32))
    _, mw, _ = read_list(str(tmp_path / "x.list"))
    q = np.sort(rng.integers(0, U64_MAX, n_values, dtype=np.uint64))
    q[0] = 0
    q[-1] = U64_MAX if n_values > 1 else w[17]
    np.testing.assert_array_equal(port_lc.word_rank(mw, q),
                                  np.searchsorted(w, q))
