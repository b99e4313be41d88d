"""Port vs JAX: pairwise merge of sorted runs (kernel E's plain version).

The JAX package's ``merge_round`` and ``merge_sorted_runs`` run the Pallas
kernel in interpret mode (``use_pallas=True``) or pure XLA passes
(``use_pallas=False``); the port's run ``ops.merge_runs.merge_runs`` on
the CPU. Keys are compared bit for bit. Payloads are compared exactly where
keys are unique; where keys tie, a bitonic network's order among equal
keys is its own, so payloads are compared after a (key, payload) sort."""

import numpy as np
import pytest
import torch

import jax

from genometester4_tpu.ops.bitonic_merge_pallas import (
    merge_round as jax_merge_round, merge_sorted_runs as jax_merge_runs)
from genometester4_tpu_torch.ops import encode as tenc
from genometester4_tpu_torch.ops.merge_runs import (merge_round, merge_runs,
                                                    merge_sorted_runs)

torch.set_num_threads(1)

SHAPES = [(256, 2), (256, 8), (1024, 4), (64, 4), (1, 8)]


def _sort_runs(L, k1, k2, *payloads):
    """Sort each aligned length-L run by (k1, k2), payloads alongside."""
    arrs = [k1, k2, *payloads]
    for s in range(0, len(k1), L):
        o = np.lexsort((k2[s:s + L], k1[s:s + L]))
        for a in arrs:
            a[s:s + L] = a[s:s + L][o]


def _merge_all(fn, arrays, L, n):
    run_len = L
    while run_len < n:
        arrays = fn(arrays, run_len)
        run_len *= 2
    return arrays


@pytest.mark.parametrize("L", [128, 1024, 4096])
@pytest.mark.parametrize("n_pairs", [1, 3])
def test_merge_round_matches_pallas(L, n_pairs):
    """The cases of tests/test_bitonic_merge.py: low-cardinality k1 so the
    k2 tiebreak decides."""
    rng = np.random.default_rng(L + n_pairs)
    n = 2 * L * n_pairs
    k1 = rng.integers(0, 7, n).astype(np.uint32)
    k2 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    _sort_runs(L, k1, k2)
    m1, m2 = jax.jit(
        lambda a, b: jax_merge_round(a, b, L, interpret=True))(k1, k2)
    got = merge_round(tenc.keys_from_pair(k1, k2), L)
    g1, g2 = tenc.pair_from_keys(got)
    np.testing.assert_array_equal(g1, np.asarray(m1))
    np.testing.assert_array_equal(g2, np.asarray(m2))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("L,n_runs", SHAPES)
def test_merge_sorted_runs_unique_keys_match_jax(L, n_runs, use_pallas):
    """log2(n_runs) rounds with a payload, unique keys: keys and payloads
    equal JAX's bit for bit."""
    rng = np.random.default_rng(L * 31 + n_runs + use_pallas)
    n = L * n_runs
    perm = rng.permutation(n).astype(np.uint64)
    k1 = (perm >> np.uint64(3)).astype(np.uint32)
    k2 = perm.astype(np.uint32)
    v = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    _sort_runs(L, k1, k2, v)

    def jax_round(arrs, run_len):
        return jax_merge_runs(arrs, run_len, use_pallas=use_pallas,
                              interpret=use_pallas)

    want = [np.asarray(x) for x in jax.jit(
        lambda a, b, c: _merge_all(jax_round, (a, b, c), L, n))(k1, k2, v)]
    keys, payload = _merge_all(
        merge_sorted_runs,
        (tenc.keys_from_pair(k1, k2), torch.from_numpy(v.view(np.int32))),
        L, n)
    g1, g2 = tenc.pair_from_keys(keys)
    np.testing.assert_array_equal(g1, want[0])
    np.testing.assert_array_equal(g2, want[1])
    np.testing.assert_array_equal(payload.numpy().view(np.uint32), want[2])


@pytest.mark.parametrize("L,n_runs", SHAPES)
def test_merge_sorted_runs_tied_keys_match_jax(L, n_runs):
    """Four distinct keys, two payloads: keys bit-exact, each payload equal
    to JAX's after a (key, payload) sort, and the port's order that of a
    stable sort (run A's equal keys first)."""
    rng = np.random.default_rng(L * 7 + n_runs)
    n = L * n_runs
    k1 = rng.integers(0, 2, n).astype(np.uint32)
    k2 = rng.integers(0, 2, n).astype(np.uint32) * np.uint32(0xFFFFFFFF)
    v = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    w = np.arange(n, dtype=np.int64)
    _sort_runs(L, k1, k2, v, w)

    want = [np.asarray(x) for x in jax.jit(lambda a, b, c: _merge_all(
        lambda arrs, r: jax_merge_runs(arrs, r, use_pallas=False),
        (a, b, c), L, n))(k1, k2, v)]
    keys0 = tenc.keys_from_pair(k1, k2)
    keys, pv, pw = _merge_all(
        merge_sorted_runs,
        (keys0, torch.from_numpy(v.astype(np.int64)), torch.from_numpy(w)),
        L, n)
    g1, g2 = tenc.pair_from_keys(keys)
    np.testing.assert_array_equal(g1, want[0])
    np.testing.assert_array_equal(g2, want[1])
    got_v = pv.numpy().astype(np.uint32)
    np.testing.assert_array_equal(
        got_v[np.lexsort((got_v, g2, g1))],
        want[2][np.lexsort((want[2], want[1], want[0]))])
    # stable: equal keys keep the order they had before the first round
    k = keys0.numpy()
    order = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(pw.numpy(), w[order])


def _runs(rng, n, L, card):
    keys = rng.integers(-card, card, n).astype(np.int64)
    return torch.from_numpy(np.sort(keys.reshape(-1, L), axis=1).ravel())


@pytest.mark.parametrize("L,n", [(1, 2), (1, 4096), (3, 6000), (100, 2200),
                                 (1000, 8000), (1024, 2048), (3000, 12000),
                                 (4096, 1 << 15)])
@pytest.mark.parametrize("card", [1, 5, 1 << 40])
def test_merge_runs_is_a_stable_sort_of_each_span(L, n, card):
    """The plain version of kernel E at the kernel's edges (L = 1, 2L below
    a 2048-slot tile, L not a power of two, all-equal keys): merged keys
    and positions equal a stable numpy sort of each 2L span."""
    rng = np.random.default_rng(L + n + card)
    keys = _runs(rng, n, L, card)
    merged, pos = merge_runs(keys, L)
    assert merged.dtype == torch.int64 and pos.dtype == torch.int32
    spans = keys.numpy().reshape(-1, 2 * L)
    order = (np.argsort(spans, axis=1, kind="stable")
             + np.arange(0, n, 2 * L)[:, None]).ravel()
    np.testing.assert_array_equal(pos.numpy(), order)
    np.testing.assert_array_equal(merged.numpy(), keys.numpy()[order])


def test_merge_runs_sentinel_tails():
    """INT64_MAX tails (the mesh merge's padding) stay last, in order."""
    L = 512
    rng = np.random.default_rng(3)
    keys = _runs(rng, 4 * L, L, 1 << 50).view(-1, L).clone()
    for r, m in enumerate((L, 17, 0, 300)):
        keys[r, m:] = (1 << 63) - 1
    keys = keys.view(-1)
    merged, pos = merge_sorted_runs((keys, torch.arange(4 * L)), L)
    spans = keys.view(-1, 2 * L)
    want = torch.sort(spans, dim=1, stable=True)
    assert torch.equal(merged, want.values.view(-1))
    assert torch.equal(pos.view(-1, 2 * L) % (2 * L), want.indices)


def test_merge_preconditions_raise():
    keys = torch.arange(16, dtype=torch.int64)
    with pytest.raises(ValueError, match="multiple of 2L"):
        merge_sorted_runs((keys,), 3)
    with pytest.raises(ValueError, match="multiple of 2L"):
        merge_runs(keys, 0)
    with pytest.raises(ValueError, match="not sorted"):
        merge_sorted_runs((keys.flip(0),), 4)
    with pytest.raises(ValueError, match="int64"):
        merge_sorted_runs((keys.to(torch.int32),), 4)
    with pytest.raises(ValueError, match="1-D"):
        merge_runs(keys.view(4, 4), 2)
    with pytest.raises(ValueError, match="payloads"):
        merge_sorted_runs((keys, keys[:8]), 4)
    with pytest.raises(ValueError, match="unsupported device"):
        merge_sorted_runs((keys.to("meta"),), 4)


# ---------------------------------------------------------------------------
# Kernel E's schedule (csrc/merge_runs.cu), emulated in numpy: the partition
# pass, each tile's slices copied into a ring slot from the aligned key
# before them (keys pointers 0 or 8 bytes past a 16-byte boundary), the
# per-thread diagonal search and register-blocked merge of 15 slots (the
# padding key past a slice read, never taken), the staging at a stride of
# 15 and the per-thread global merge of tiles that cross spans, with the
# tiles taken in a persistent grid's stride order.

E_THREADS, E_ITEMS = 256, 15
E_TILE = E_THREADS * E_ITEMS
E_SLOT = E_TILE + 4


def _merge_path(a, na, b, nb, d):
    lo, hi = max(d - nb, 0), min(d, na)
    while lo < hi:
        mid = (lo + hi) >> 1
        if a[mid] <= b[d - 1 - mid]:
            lo = mid + 1
        else:
            hi = mid
    return lo


class _View:
    """a[i] = arr[start + i], for the searches over a slice."""

    def __init__(self, arr, start):
        self.arr, self.start = arr, start

    def __getitem__(self, i):
        return self.arr[self.start + i]


def _describe(splits, tile, n, run, odd):
    span = 2 * run
    start = tile * E_TILE
    end = min(start + E_TILE, n)
    cnt = end - start
    base = start // span * span
    if end - 1 >= base + span:
        return dict(start=start, cnt=cnt, cross=True)
    d0, d1 = start - base, end - base
    a0 = splits[tile]
    a1 = run if d1 == span else splits[tile + 1]
    a1 = min(max(a1, a0, d1 - run), a0 + cnt, run)
    na = a1 - a0
    ga, gb = base + a0, base + run + d0 - a0
    sa, rb = (ga + odd) & 1, (gb + odd) & 1
    return dict(start=start, cnt=cnt, cross=False, na=na, nb=cnt - na,
                ga=ga, gb=gb, sa=sa, rb=rb, sb=((sa + na + 1) & ~1) + rb)


def _copy_slice(slot, dst, keys, n, g, s, cnt):
    """copy_slice: 16-byte copies of keys [g - s, g + cnt) where both keys
    lie in [0, n) and start on an even word (asserted), else 8-byte ones."""
    for i in range((s + cnt + 1) // 2):
        j = g - s + 2 * i
        if 0 <= j and j + 2 <= n:
            assert (j + _copy_slice.odd) % 2 == 0 and (dst + 2 * i) % 2 == 0
            slot[dst + 2 * i:dst + 2 * i + 2] = keys[j:j + 2]
        else:
            for h in (0, 1):
                if 0 <= j + h < n:
                    slot[dst + 2 * i + h] = keys[j + h]


def _emulate_merge(keys, L, odd, grid=3):
    n = len(keys)
    n_tiles = -(-n // E_TILE)
    splits = []
    for t in range(n_tiles):
        o = t * E_TILE
        base = o // (2 * L) * (2 * L)
        splits.append(_merge_path(_View(keys, base), L,
                                  _View(keys, base + L), L, o - base))
    out = np.full(n, -7, np.int64)
    pos = np.full(n, -7, np.int64)
    written = np.zeros(n, np.int64)
    rng = np.random.default_rng(n + L)
    _copy_slice.odd = odd
    order = [t for b in range(grid) for t in range(b, n_tiles, grid)]
    for tile in order:
        d = _describe(splits, tile, n, L, odd)
        start, cnt = d["start"], d["cnt"]
        if d["cross"]:
            span = 2 * L
            for tid in range(E_THREADS):
                o = start + tid * E_ITEMS
                o_end = min(o + E_ITEMS, start + cnt)
                while o < o_end:
                    sb = o // span * span
                    a, b = _View(keys, sb), _View(keys, sb + L)
                    ia = _merge_path(a, L, b, L, o - sb)
                    ib = o - sb - ia
                    for o in range(o, min(sb + span, o_end)):
                        if ib >= L or (ia < L and a[ia] <= b[ib]):
                            out[o], pos[o] = a[ia], sb + ia
                            ia += 1
                        else:
                            out[o], pos[o] = b[ib], sb + L + ib
                            ib += 1
                        written[o] += 1
                    o += 1
            continue
        # a ring slot holding the last tile's garbage
        slot = rng.integers(-2 ** 63, 2 ** 63 - 1, E_SLOT, dtype=np.int64)
        na, nb, sa, sb = d["na"], d["nb"], d["sa"], d["sb"]
        _copy_slice(slot, 0, keys, n, d["ga"], sa, na)
        _copy_slice(slot, sb - d["rb"], keys, n, d["gb"], d["rb"], nb)
        stage_k = np.zeros(E_TILE, np.int64)
        stage_p = np.zeros(E_TILE, np.int64)
        for tid in range(E_THREADS):
            dd = min(tid * E_ITEMS, cnt)
            a, b = _View(slot, sa), _View(slot, sb)
            ia = _merge_path(a, na, b, nb, dd)
            ib = dd - ia
            assert sa + ia < E_SLOT and sb + ib < E_SLOT
            ka, kb = a[ia], b[ib]
            for j in range(E_ITEMS):
                if dd + j >= cnt:
                    break
                if ib >= nb or (ia < na and ka <= kb):
                    stage_k[dd + j], stage_p[dd + j] = ka, d["ga"] + ia
                    ia += 1
                    assert sa + ia < E_SLOT
                    ka = a[ia]
                else:
                    stage_k[dd + j], stage_p[dd + j] = kb, d["gb"] + ib
                    ib += 1
                    assert sb + ib < E_SLOT
                    kb = b[ib]
        out[start:start + cnt] = stage_k[:cnt]
        pos[start:start + cnt] = stage_p[:cnt]
        written[start:start + cnt] += 1
    assert (written == 1).all()
    return out, pos


@pytest.mark.parametrize("L,n", [(1, 2), (1, 8000), (100, 2200),
                                 (1000, 8000), (E_TILE // 2, 2 * E_TILE),
                                 (E_TILE, 4 * E_TILE), (E_TILE + 1,
                                                        2 * E_TILE + 2),
                                 (3001, 6002 * 3), (5000, 20000)])
@pytest.mark.parametrize("card", [1, 5, 1 << 62])
def test_merge_kernel_schedule_emulation_equals_plain(L, n, card):
    """The emulated kernel at L = 1, 2L below a tile (tiles crossing spans),
    2L equal to a tile, L equal to and one past it, odd L, all-equal keys
    (card 1), ties (card 5) and INT64_MAX tails, with the keys pointer on
    both 8-byte parities: keys and positions equal merge_runs."""
    rng = np.random.default_rng(L + n + card)
    keys = rng.integers(-card, card, n).astype(np.int64).reshape(-1, L)
    keys[::3, L // 2:] = (1 << 63) - 1     # sentinel tails
    keys = np.sort(keys, axis=1).ravel()
    want_k, want_p = merge_runs(torch.from_numpy(keys), L)
    for odd in (0, 1):
        got_k, got_p = _emulate_merge(keys, L, odd)
        np.testing.assert_array_equal(got_k, want_k.numpy())
        np.testing.assert_array_equal(got_p, want_p.numpy())

