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


# ---------------------------------------------------------------------------
# Kernel A's schedule (csrc/extract.cu), emulated in numpy: the 16-byte code
# chunks (aligned, funnel-shifted from a misaligned pointer, or byte by byte
# at the end), 128 threads x 32 windows per block, priming with k - 1 codes,
# the rolling forward word and reverse complement, the last-255 index and
# the swizzled 16-byte staging of keys and mask bytes.

A_THREADS, A_WIN = 128, 32
A_TILE = A_THREADS * A_WIN
A_CHUNKS = (A_TILE + 32) // 16


def _brev64(x):
    """__brevll on a uint64 array."""
    table = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)],
                     np.uint64)
    out = np.zeros_like(x)
    for i in range(8):
        byte = (x >> np.uint64(8 * i)) & np.uint64(0xFF)
        out |= table[byte.astype(np.int64)] << np.uint64(56 - 8 * i)
    return out


def _reverse_complement_bits(w, k):
    x = _brev64(~w)
    m = np.uint64(0x5555555555555555)
    x = ((x >> np.uint64(1)) & m) | ((x & m) << np.uint64(1))
    return x >> np.uint64(64 - 2 * k)


def _load_chunk(mem, off, n, g):
    """load_chunk: codes [g, g + 16), 255 past n; the codes sit at byte
    ``off`` of ``mem``, whose other bytes the kernel must never use."""
    if off == 0 and g + 16 <= n:
        return mem[g:g + 16]
    if off != 0 and g >= off and g - off + 32 <= n:
        a = off + g - off                 # the aligned chunk's address
        assert a % 16 == 0
        x = mem[a:a + 32].view("<u4").astype(np.uint64)
        s, b = off >> 2, 8 * (off & 3)
        y = x[s:s + 5]
        words = ((y[1:] << np.uint64(32)) | y[:4]) >> np.uint64(b)
        return (words & np.uint64(0xFFFFFFFF)).astype("<u4").view(np.uint8)
    return np.array([mem[off + g + j] if g + j < n else 255
                     for j in range(16)], np.uint8)


def _key_slot(t, m):
    return t * (A_WIN // 2) + (m ^ (t & 7))


def _mask_slot(t, h):
    return 2 * t + (h ^ ((t >> 2) & 1))


def _emulate_extract(codes, k, canonical, off):
    n = len(codes)
    rng = np.random.default_rng(n + off)
    mem = rng.integers(0, 256, off + n + 64).astype(np.uint8)  # garbage
    mem[off:off + n] = codes
    blocks = -(-n // A_TILE)
    keys = np.zeros(n, np.uint64)
    valid = np.zeros(n, np.uint8)
    t = np.arange(A_THREADS)
    kmask = np.uint64((1 << (2 * k)) - 1 if k < 32 else 2 ** 64 - 1)
    for blk in range(blocks):
        base = blk * A_TILE
        tile = np.concatenate([_load_chunk(mem, off, n, base + 16 * i)
                               for i in range(A_CHUNKS)])
        # thread t's codes [32t, 32t + 64): four 16-byte shared loads
        c = np.stack([tile[32 * i:32 * i + 64] for i in t]).astype(np.uint64)
        fwd = np.zeros(A_THREADS, np.uint64)
        last = np.full(A_THREADS, -1)
        for q in range(k - 1):
            last = np.where(c[:, q] == 255, q, last)
            fwd = (fwd << np.uint64(2)) | (c[:, q] & np.uint64(3))
        s_keys = np.zeros((A_TILE // 2, 2), np.uint64)
        s_mask = np.zeros((A_TILE // 16, 16), np.uint8)
        win_keys = np.zeros((A_THREADS, A_WIN), np.uint64)
        win_ok = np.zeros((A_THREADS, A_WIN), np.uint8)
        for j in range(A_WIN):
            q = j + k - 1
            last = np.where(c[:, q] == 255, q, last)
            code = c[:, q] & np.uint64(3)
            fwd = ((fwd << np.uint64(2)) | code) & kmask
            if j == 0:
                rc = _reverse_complement_bits(fwd, k)
            else:
                rc = (rc >> np.uint64(2)) | (
                    (code ^ np.uint64(3)) << np.uint64(2 * k - 2))
            word = np.where(canonical & (rc < fwd), rc, fwd)
            ok = last < j
            flag = np.uint64(1 << (2 * k)) if k < 32 else np.uint64(0)
            word = np.where(ok, word, flag) ^ np.uint64(1 << 63)
            win_keys[:, j] = word
            win_ok[:, j] = ok
        for m in range(A_WIN // 2):
            slots = _key_slot(t, m)
            # 16-byte stores: each quarter warp hits 8 distinct bank groups
            assert all(len(set(slots[i:i + 8] % 8)) == 8
                       for i in range(0, A_THREADS, 8))
            s_keys[slots] = win_keys[:, 2 * m:2 * m + 2]
        for h in range(2):
            slots = _mask_slot(t, h)
            assert all(len(set(slots[i:i + 8] % 8)) == 8
                       for i in range(0, A_THREADS, 8))
            s_mask[slots] = win_ok[:, 16 * h:16 * h + 16]
        v = np.arange(A_TILE // 2)
        read = _key_slot(v // (A_WIN // 2), v % (A_WIN // 2))
        assert all(len(set(read[i:i + 8] % 8)) == 8
                   for i in range(0, len(v), 8))
        out = s_keys[read].ravel()
        u = np.arange(A_TILE // 16)
        outm = s_mask[_mask_slot(u >> 1, u & 1)].ravel()
        end = min(base + A_TILE, n)
        keys[base:end] = out[:end - base]
        valid[base:end] = outm[:end - base]
    return keys.view(np.int64), valid.astype(bool)


@pytest.mark.parametrize("k", [1, 5, 16, 17, 25, 31, 32])
def test_extract_kernel_schedule_emulation_equals_plain(k):
    """The emulated kernel at n = tile - 1, tile, tile + 1 and tile + k - 1
    (windows straddling tile and halo, the trailing k - 1 windows), codes
    pointers 0, 1, 7 and 15 bytes past a 16-byte boundary, both canonical
    modes: keys (and the k = 32 mask) equal extract_kmers bit for bit."""
    for n, off in ((A_TILE - 1, 1), (A_TILE, 0), (A_TILE + 1, 15),
                   (A_TILE + k - 1, 7), (2 * A_TILE + 333, 0)):
        codes = _codes(n * 3 + k + off, n=n)
        # a 255 where the tile meets its halo
        codes[A_TILE - 2:A_TILE + 1] = [0, 255, 3][:n - A_TILE + 2]
        for canonical in (True, False):
            keys, valid = _emulate_extract(codes, k, canonical, off)
            want_k, want_v = extract_kmers(torch.from_numpy(codes), k,
                                           canonical)
            np.testing.assert_array_equal(keys, want_k.numpy())
            if k == 32:
                np.testing.assert_array_equal(valid, want_v.numpy())
