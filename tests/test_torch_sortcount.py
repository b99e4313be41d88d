"""Port vs JAX: run marks (kernel B's plain version) and
count_unique(compact=False) in both weight modes. Exact comparisons."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genometester4_tpu.ops.encode import join_u64
from genometester4_tpu_torch.ops import encode as tenc
from genometester4_tpu_torch.ops.sortcount import count_unique, run_marks

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


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("k", [5, 16, 25, 32])
def test_count_unique_matches_jax(k, weighted):
    from genometester4_tpu.ops.sortcount import count_unique as jax_cu

    rng = np.random.default_rng(k * 2 + weighted)
    n = 5000
    words = rng.integers(0, 2 ** (2 * k) - 1, size=n, dtype=np.uint64,
                         endpoint=True)
    dup = rng.random(n) < 0.5
    words[dup] = words[rng.integers(0, n, int(dup.sum()))]
    valid = rng.random(n) < 0.9
    # large weights make the u32 count sums wrap
    weights = (rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
               if weighted else np.ones(n, np.uint32))
    hi = (words >> np.uint64(32)).astype(np.uint32)
    lo = words.astype(np.uint32)
    shi, slo, head_j, tail_j, incl_j, nuni_j = (
        None if x is None else np.asarray(x) for x in jax_cu(
            jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(weights),
            jnp.asarray(valid), hi_bits=max(0, 2 * k - 32),
            unit_weights=not weighted, compact=False))

    keys = tenc.keys_from_u64(words)
    w = torch.from_numpy(weights.astype(np.int64)) if weighted else None
    if k == 32:   # no flag bit: drop invalid keys before counting
        mask = torch.from_numpy(valid)
        keys, w = keys[mask], (None if w is None else w[mask])
        word_bits = 64
    else:
        keys = torch.where(torch.from_numpy(valid), keys,
                           tenc.flag_key(2 * k))
        word_bits = 2 * k
    skeys, head, tail, incl, n_unique = count_unique(keys, w, word_bits)

    nv = int(valid.sum())
    assert n_unique == int(nuni_j)
    np.testing.assert_array_equal(tenc.u64_from_keys(skeys[:nv]),
                                  join_u64(shi, slo)[:nv])
    m = len(skeys)
    np.testing.assert_array_equal(head.numpy(), head_j[:m])
    np.testing.assert_array_equal(tail.numpy(), tail_j[:m])
    assert not head_j[m:].any() and not tail_j[m:].any()
    if weighted:
        t = tail.numpy()
        np.testing.assert_array_equal(incl.numpy()[t], incl_j[:m][t])
    else:
        assert incl is None and incl_j is None


def test_run_marks_cuda_rejects_cpu_tensor():
    from genometester4_tpu_torch.ops.runmarks_cuda import run_marks_cuda
    with pytest.raises(ValueError, match="CUDA tensor"):
        run_marks_cuda(torch.zeros(8, dtype=torch.int64), 8)
