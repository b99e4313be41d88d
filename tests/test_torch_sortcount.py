"""Port vs JAX: the run marks, kernel B's plain version ``run_encode`` and
``count_unique`` against JAX's count_unique(compact=True), in both weight
modes. Exact comparisons."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genometester4_tpu.ops.encode import join_u64
from genometester4_tpu_torch.ops import encode as tenc
from genometester4_tpu_torch.ops.sortcount import (count_unique, run_encode,
                                                   run_marks)

torch.set_num_threads(1)


def _sorted_stream(seed, n, n_valid, word_bits):
    """Sorted words with ~30% duplicates in the valid prefix."""
    rng = np.random.default_rng(seed)
    words = np.sort(rng.integers(0, 2 ** word_bits - 1, size=n_valid,
                                 dtype=np.uint64, endpoint=True))
    dup = rng.random(n_valid) < 0.3
    words[dup] = words[np.maximum(np.flatnonzero(dup) - 1, 0)]
    return np.sort(words)


@pytest.mark.parametrize("word_bits,valid_frac", [(50, 0.9), (62, 1.0)])
def test_run_marks_matches_pallas(word_bits, valid_frac):
    """Masks, n_unique, total and checksum equal the Pallas kernel's
    (interpret mode) across its block seams, with and without an invalid
    tail. (The Pallas kernel cannot be built for 64-bit words, k = 32:
    the count_unique test covers that case against JAX.)"""
    from genometester4_tpu.ops.runmarks_pallas import make_run_marks

    n = 1024 * 128 * 2
    n_valid = int(n * valid_frac)
    words = _sorted_stream(word_bits, n, n_valid, word_bits)
    hb = word_bits - 32
    packed = np.full(n, 0xFFFFFFFF, np.uint32)   # invalid: flag bits set
    lo = np.full(n, 0xFFFFFFFF, np.uint32)
    packed[:n_valid] = (words >> np.uint64(32)).astype(np.uint32)
    lo[:n_valid] = words.astype(np.uint32)
    run = make_run_marks(n, hb, rows=512, interpret=True)
    head_p, tail_p, nuni_p, tot_p, chk_p = (np.asarray(x) for x in run(
        jnp.asarray(packed), jnp.asarray(lo)))

    keys = tenc.keys_from_pair(packed, lo)
    head, tail, stats = run_marks(keys, n_valid)
    np.testing.assert_array_equal(head.numpy(), head_p)
    np.testing.assert_array_equal(tail.numpy(), tail_p)
    n_unique, total, checksum = (int(s) for s in stats)
    assert n_unique == int(nuni_p)
    assert total == int(tot_p) == n_valid
    assert checksum & 0xFFFFFFFF == int(np.uint32(chk_p))


def test_run_marks_edges():
    keys = tenc.keys_from_u64(np.array([5, 5, 7, 7, 7, 9], np.uint64))
    for n_valid, heads, tails in (
            (6, [1, 0, 1, 0, 0, 1], [0, 1, 0, 0, 1, 1]),
            (4, [1, 0, 1, 0, 0, 0], [0, 1, 0, 1, 0, 0]),   # run cut at 4
            (0, [0] * 6, [0] * 6)):
        head, tail, stats = run_marks(keys, n_valid)
        assert head.tolist() == [bool(x) for x in heads]
        assert tail.tolist() == [bool(x) for x in tails]
        assert int(stats[0]) == sum(heads) and int(stats[1]) == n_valid
    head, tail, stats = run_marks(keys[:0], 0)
    assert head.numel() == 0 and stats.tolist() == [0, 0, 0]
    with pytest.raises(ValueError):
        run_marks(keys, 7)


def _stream(kind, k, weighted):
    """(words u64, valid bool, weights u32) of one test stream: "random"
    (~50% repeated words, 10% invalid), "empty", "all_invalid" or
    "one_run" (one word over the whole stream). Large weights make the
    u32 count sums wrap."""
    rng = np.random.default_rng(k * 2 + weighted)
    n = {"random": 5000, "empty": 0}.get(kind, 3000)
    words = rng.integers(0, 2 ** (2 * k) - 1, size=n, dtype=np.uint64,
                         endpoint=True)
    if kind == "one_run":
        words[:] = words[0]
    dup = rng.random(n) < 0.5
    words[dup] = words[rng.integers(0, n, int(dup.sum()))]
    valid = {"random": rng.random(n) < 0.9,
             "all_invalid": np.zeros(n, bool)}.get(kind, np.ones(n, bool))
    weights = (rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
               if weighted else np.ones(n, np.uint32))
    return words, valid, weights


@functools.lru_cache(maxsize=None)
def _jax_compact(kind, k, weighted):
    """JAX's count_unique(compact=True) on a stream: (unique words u64,
    counts u32, n_unique)."""
    from genometester4_tpu.ops.sortcount import count_unique as jax_cu

    words, valid, weights = _stream(kind, k, weighted)
    uhi, ulo, counts, n_unique = (np.asarray(x) for x in jax_cu(
        jnp.asarray((words >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray(words.astype(np.uint32)), jnp.asarray(weights),
        jnp.asarray(valid), hi_bits=max(0, 2 * k - 32),
        unit_weights=not weighted, compact=True))
    m = int(n_unique)
    assert not counts[m:].any()
    return join_u64(uhi, ulo)[:m], counts[:m], m


def _port_inputs(kind, k, weighted):
    """The stream as the port's (keys, weights or None, word_bits): for
    k <= 31 invalid entries carry the flag key; k = 32 has no flag bit, so
    they are dropped first, as ``count_chunk`` does."""
    words, valid, weights = _stream(kind, k, weighted)
    keys = tenc.keys_from_u64(words)
    w = torch.from_numpy(weights.astype(np.int64)) if weighted else None
    if k == 32:
        mask = torch.from_numpy(valid)
        return keys[mask], (None if w is None else w[mask]), 64
    return (torch.where(torch.from_numpy(valid), keys,
                        tenc.flag_key(2 * k)), w, 2 * k)


def _assert_equal_jax(kind, k, weighted, ukeys, counts, n_unique):
    words, want_c, want_n = _jax_compact(kind, k, weighted)
    assert n_unique == want_n == len(ukeys) == len(counts)
    np.testing.assert_array_equal(tenc.u64_from_keys(ukeys), words)
    np.testing.assert_array_equal(counts.numpy(), want_c.astype(np.int64))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("k", [5, 16, 25, 32])
def test_count_unique_matches_jax(k, weighted):
    """count_unique equals JAX's count_unique(compact=True) exactly: unique
    words, u32-wrapped counts, n_unique."""
    _assert_equal_jax("random", k, weighted,
                      *count_unique(*_port_inputs("random", k, weighted)))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("k", [5, 16, 25, 32])
@pytest.mark.parametrize("kind", ["empty", "all_invalid", "one_run"])
def test_count_unique_edges_match_jax(kind, k, weighted):
    _assert_equal_jax(kind, k, weighted,
                      *count_unique(*_port_inputs(kind, k, weighted)))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("k", [5, 16, 25, 32])
@pytest.mark.parametrize("kind", ["random", "empty", "all_invalid",
                                  "one_run"])
def test_run_encode_matches_jax(kind, k, weighted):
    """Kernel B's plain version on the sorted stream equals JAX's
    count_unique(compact=True); total is the valid entries and the
    checksum is sum(x * run length) mod 2^32 over the runs (numpy)."""
    keys, w, word_bits = _port_inputs(kind, k, weighted)
    skeys, order = torch.sort(keys)
    ukeys, counts, n_unique, total, checksum = run_encode(
        skeys, None if w is None else w[order], word_bits)
    _assert_equal_jax(kind, k, weighted, ukeys, counts, n_unique)
    words, valid, _ = _stream(kind, k, weighted)
    uw, lengths = np.unique(words[valid], return_counts=True)
    assert total == int(valid.sum())
    x = ((uw >> np.uint64(32)) ^ (uw & np.uint64(0xFFFFFFFF))) \
        & np.uint64(0xFFFFFFFF)
    assert checksum == int((x * lengths.astype(np.uint64)).sum()) % 2 ** 32


def test_run_encode_limit(monkeypatch):
    """Past its largest stream the plain version raises, as the kernel's
    wrapper does."""
    from genometester4_tpu_torch.ops import sortcount
    monkeypatch.setattr(sortcount, "MAX_RUN_KEYS", 7)
    keys = tenc.keys_from_u64(np.arange(8, dtype=np.uint64))
    assert sortcount.run_encode(keys[:7])[2] == 7
    with pytest.raises(ValueError, match="at most 7"):
        sortcount.run_encode(keys)


def test_run_marks_cuda_rejects_cpu_tensor():
    from genometester4_tpu_torch.ops.runmarks_cuda import run_encode_cuda
    with pytest.raises(ValueError, match="CUDA tensor"):
        run_encode_cuda(torch.zeros(8, dtype=torch.int64))
