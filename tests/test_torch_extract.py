"""Port vs JAX: int64 key helpers and k-mer extraction (kernel A's plain
version). Every output is an integer, so every comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genometester4_tpu.ops.encode import canonical_u64, join_u64, \
    reverse_complement_u64
from genometester4_tpu_torch.ops import encode as tenc
from genometester4_tpu_torch.ops.kmers import extract_kmers, \
    extract_kmers_best

torch.set_num_threads(1)

N_CODES = 128 * 128 * 2   # two 128-row Pallas blocks: one block seam


def _codes(seed, n=N_CODES, bad_frac=1 / 40):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    codes[rng.integers(0, n, size=int(n * bad_frac))] = 255
    return codes


def _words_valid(keys, valid, k):
    """Port keys -> (u64 words with the flag bit cleared, valid mask)."""
    w = tenc.u64_from_keys(keys)
    if k == 32:
        return w, valid.numpy()
    flag = np.uint64(1 << (2 * k))
    return w & (flag - np.uint64(1)), (w & flag) == 0


@pytest.mark.parametrize("k", [1, 16, 31, 32])
def test_reverse_complement_and_canonical_match_numpy(k):
    rng = np.random.default_rng(100 + k)
    hi_lim = 1 << max(0, 2 * k - 32)
    words = join_u64(rng.integers(0, hi_lim, 4096, dtype=np.uint64),
                     rng.integers(0, 1 << min(32, 2 * k), 4096,
                                  dtype=np.uint64))
    t = torch.from_numpy(words.view(np.int64))
    rc = tenc.reverse_complement(t, k).numpy().view(np.uint64)
    np.testing.assert_array_equal(rc, reverse_complement_u64(words, k))
    can = tenc.canonical(t, k).numpy().view(np.uint64)
    np.testing.assert_array_equal(can, canonical_u64(words, k))
    # the JAX device pair functions agree too
    from genometester4_tpu.ops.encode import canonical_pair, pair_less
    hi, lo = tenc.pair_from_keys(t ^ tenc.SIGN)
    chi, clo = canonical_pair(jnp.asarray(hi), jnp.asarray(lo), k)
    np.testing.assert_array_equal(join_u64(np.asarray(chi), np.asarray(clo)),
                                  can)
    a, b = t, t.flip(0)
    hb, lb = tenc.pair_from_keys(b ^ tenc.SIGN)
    np.testing.assert_array_equal(
        tenc.word_less(a, b).numpy(),
        np.asarray(pair_less(jnp.asarray(hi), jnp.asarray(lo),
                             jnp.asarray(hb), jnp.asarray(lb))))


def test_key_conversions_round_trip():
    rng = np.random.default_rng(7)
    words = rng.integers(0, 2 ** 64 - 1, 1000, dtype=np.uint64,
                         endpoint=True)
    words[:3] = [0, 2 ** 63, 2 ** 64 - 1]
    keys = tenc.keys_from_u64(words)
    np.testing.assert_array_equal(tenc.u64_from_keys(keys), words)
    hi, lo = tenc.pair_from_keys(keys)
    assert torch.equal(tenc.keys_from_pair(hi, lo), keys)
    # signed key order is unsigned word order
    order = torch.argsort(keys).numpy()
    np.testing.assert_array_equal(words[order], np.sort(words))


@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("k", [1, 5, 16, 17, 25, 31, 32])
def test_extract_matches_pallas_and_xla(k, canonical):
    from genometester4_tpu.ops.extract_pallas import make_extract_pallas
    from genometester4_tpu.ops.kmers import extract_kmers as jax_extract

    codes = _codes(k * 2 + canonical)
    keys, valid = extract_kmers(torch.from_numpy(codes), k, canonical)
    assert keys.shape == (N_CODES,) and keys.dtype == torch.int64
    assert (valid is None) == (k < 32)
    words, v = _words_valid(keys, valid, k)

    run = make_extract_pallas(N_CODES, k, canonical, rows=128,
                              interpret=True)
    hi_p, lo_p, v_p = (np.asarray(x) for x in run(jnp.asarray(codes)))
    np.testing.assert_array_equal(v, v_p)
    np.testing.assert_array_equal(words[v], join_u64(hi_p, lo_p)[v_p])

    hi_x, lo_x, v_x = (np.asarray(x) for x in jax_extract(
        jnp.asarray(codes), k, canonical=canonical))
    nw = N_CODES - k + 1
    np.testing.assert_array_equal(v[:nw], v_x)
    assert not v[nw:].any()   # trailing k-1 windows are invalid
    np.testing.assert_array_equal(words[:nw][v_x], join_u64(hi_x, lo_x)[v_x])
    # invalid windows carry the word 0 (and, for k <= 31, the flag bit)
    assert (words[~v] == 0).all()


def test_extract_short_and_empty_inputs():
    for n, k in ((0, 5), (3, 5), (5, 5), (6, 32)):
        codes = torch.zeros(n, dtype=torch.uint8)
        keys, valid = extract_kmers(codes, k)
        words, v = _words_valid(keys, valid, k)
        assert len(words) == n
        assert v.sum() == max(n - k + 1, 0)


def test_extract_best_takes_plain_version_on_cpu():
    codes = torch.from_numpy(_codes(3, n=4096))
    for k in (9, 32):
        a = extract_kmers_best(codes, k)
        b = extract_kmers(codes, k)
        assert torch.equal(a[0], b[0])
        assert (a[1] is None and b[1] is None) or torch.equal(a[1], b[1])


def test_extract_rejects_bad_arguments():
    from genometester4_tpu_torch.ops.extract_cuda import extract_kmers_cuda
    codes = torch.zeros(64, dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        extract_kmers_cuda(codes, 5)
    with pytest.raises(ValueError, match="1..32"):
        extract_kmers(codes, 33)
    with pytest.raises(ValueError, match="uint8"):
        extract_kmers(codes.to(torch.int32), 5)
