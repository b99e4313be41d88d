"""Kernel B's schedule (``csrc/runmarks.cu``), emulated in numpy and held
against ``run_encode``, its plain version: integer contract, tolerance 0.

The CUDA kernel cannot run here, so its schedule is mirrored step for step
at small sizes: tiles of THREADS x ITEMS keys taken in launch order, a tile
whose first key is invalid publishing an empty aggregate and stopping, the
key before and after each tile, each thread folding its consecutive keys
into (heads, weight since the last head), a warp scan by shifted lanes and
a pass over the warp totals, the aggregate published before a look-back
over windows of LANES status words (64-bit words holding flag and state)
that waits only for the words past its latest prefix, the inclusive
prefix published after it, and each tile's runs staged at
their local index and written as one contiguous range (with unit weights
a count is the distance between staged tails, the first run's plus its
carried length). Blocks run
interleaved in a random order, so tiles finish out of order and
look-backs spin on tiles that have not published yet. Every output slot
starts as garbage and must be written exactly once. The kernel itself is
held against ``run_encode`` on the card in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from genometester4_tpu_torch.ops import encode as tenc
from genometester4_tpu_torch.ops.sortcount import run_encode

torch.set_num_threads(1)

U32 = 0xFFFFFFFF
AGGREGATE = 1 << 62
PREFIX = 1 << 63
GARBAGE = -77


def combine(a, b):
    """(heads, weight since the last head) of stretch a, then stretch b."""
    return a[0] + b[0], b[1] if b[0] else (a[1] + b[1]) & U32


def encode(state, flag):
    assert state[0] < (1 << 31 if flag == PREFIX else 1 << 30)
    return flag | state[0] << 32 | state[1]


def decode(w):
    return (w >> 32) & (0x7FFFFFFF if w & PREFIX else 0x3FFFFFFF), w & U32


def warp_scan(values, warp):
    """Inclusive scan of each warp's lanes by shifted lanes (shfl_up)."""
    out = []
    for w0 in range(0, len(values), warp):
        v = list(values[w0:w0 + warp])
        off = 1
        while off < warp:
            v = [combine(v[l - off], v[l]) if l >= off else v[l]
                 for l in range(warp)]
            off *= 2
        out += v
    return out


def look_back(status, tile, lanes):
    """Generator: the state of every tile before ``tile``; yields while a
    status word it needs is unpublished. A window counts from its latest
    inclusive prefix on (all of it without one)."""
    acc = (0, 0)
    end = tile
    while True:
        while True:
            ws = [status[j] if j >= 0 else PREFIX
                  for j in range(end - lanes, end)]
            prefixed = [l for l in range(lanes) if ws[l] & PREFIX]
            latest = max(prefixed, default=0)
            if all(ws[latest:]):
                break
            yield
        v = [decode(ws[l]) if l >= latest else (0, 0) for l in range(lanes)]
        off = 1   # ordered fold by shfl_down, lane 0 first
        while off < lanes:
            v = [combine(v[l], v[l + off]) if l + off < lanes else v[l]
                 for l in range(lanes)]
            off *= 2
        acc = combine(v[0], acc)
        if prefixed:
            return acc
        end -= lanes


def tile_program(tile, keys, weights, limit, cfg, shared, rng):
    """Generator: one block's work on ``tile``; yields where the block
    may be overtaken by others."""
    threads, items, warp, lanes = cfg
    status, stats, out_k, out_c, written = shared
    n = len(keys)
    tile_n = threads * items
    start = tile * tile_n
    if limit is not None and keys[start] >= limit:
        status[tile] = AGGREGATE   # past the valid prefix: empty aggregate
        return
    yield

    def key(i):
        return int(keys[i]) if 0 <= i < n else 0

    buf = [key(start - 1)] + [key(start + p) for p in range(tile_n + 1)]
    wbuf = [int(weights[start + p]) & U32
            if weights is not None and start + p < n else 0
            for p in range(tile_n)]

    def weight(valid, p):
        return (wbuf[p] if weights is not None else 1) if valid else 0

    threads_state, sums = [], [0, 0, 0]
    for t in range(threads):
        p0 = t * items
        heads = tails = 0
        wts = []   # this thread's weights, kept from the fold
        mine = (0, 0)
        for j in range(items):
            prev, cur, nxt = buf[p0 + j], buf[p0 + j + 1], buf[p0 + j + 2]
            i = start + p0 + j
            valid = i < n and not (limit is not None and cur >= limit)
            h = valid and (i == 0 or prev != cur)
            tl = valid and (i == n - 1 or nxt != cur)
            wts.append(weight(valid, p0 + j))
            mine = combine(mine, (int(h), wts[j]))
            heads |= h << j
            tails |= tl << j
            word = (cur ^ tenc.SIGN) & (2 ** 64 - 1)
            x = (word >> 32) ^ (word & U32)
            sums[0] += h
            sums[1] += valid
            sums[2] += (tl * x * (i + 1) - h * x * i)
        threads_state.append((heads, tails, wts, mine))

    incl = warp_scan([s[3] for s in threads_state], warp)
    warp_tot = incl[warp - 1::warp]
    excl, agg = [], (0, 0)
    for w in range(threads // warp):
        lane_excl = [(0, 0)] + incl[w * warp:(w + 1) * warp - 1]
        excl += [combine(agg, e) for e in lane_excl]
        agg = combine(agg, warp_tot[w])

    # the threads stage their runs before the prefix is known (in the
    # kernel, warps 1.. while warp 0 looks back), counts within the tile
    mid = int(start > 0 and buf[0] == buf[1])
    stage_pos = [GARBAGE] * tile_n
    stage_count = [GARBAGE] * tile_n
    n_out = 0
    for t in rng.permutation(threads):   # threads stage in any order
        heads, tails, wts, _ = threads_state[t]
        p0 = t * items
        run = excl[t]
        for j in range(items):
            run = combine(run, (heads >> j & 1, wts[j]))
            if tails >> j & 1:
                last = run[0] - 1 + mid
                assert 0 <= last <= p0 + j
                stage_pos[last] = p0 + j
                if weights is not None:
                    stage_count[last] = run[1]
                n_out = max(n_out, last + 1)
    yield

    if tile == 0:
        status[0] = encode(agg, PREFIX)
        before = (0, 0)
    else:
        status[tile] = encode(agg, AGGREGATE)
        yield
        before = yield from look_back(status, tile, lanes)
        status[tile] = encode(combine(before, agg), PREFIX)
    yield

    base = before[0] - mid
    carry = before[1] if mid else 0   # the run the tile starts inside
    assert base >= 0 and base + n_out <= n
    for q in range(n_out):
        pos = stage_pos[q]
        assert pos != GARBAGE
        if weights is not None:
            count = (stage_count[q] + (0 if q else carry)) & U32
        elif q:   # unit weights: the distance from the previous tail
            count = pos - stage_pos[q - 1]
        else:
            count = pos + 1 + carry
        out_k[base + q] = buf[pos + 1]
        out_c[base + q] = count
        written[base + q] += 1
    for s in range(3):
        stats[s] = (stats[s] + sums[s]) & U32


def emulate(keys, weights, limit, cfg, seed, resident=3):
    """Run every tile's program, at most ``resident`` blocks at a time,
    stepping a random one each time; a finished block's place goes to the
    next tile id."""
    rng = np.random.default_rng(seed)
    n = len(keys)
    tile_n = cfg[0] * cfg[1]
    tiles = -(-n // tile_n)
    shared = ([0] * tiles, [0, 0, 0], np.full(n, GARBAGE, np.int64),
              np.full(n, GARBAGE, np.int64), np.zeros(n, np.int64))
    active, next_tile, steps = [], 0, 0
    while next_tile < tiles or active:
        if next_tile < tiles and len(active) < resident:
            active.append(tile_program(next_tile, keys, weights, limit, cfg,
                                       shared, rng))
            next_tile += 1
        g = active[rng.integers(len(active))]
        try:
            next(g)
        except StopIteration:
            active.remove(g)
        steps += 1
        assert steps < 100 * tiles + 10_000, "look-back never ends"
    return shared


def _stream(kind, seed, weighted, tile_n, word_bits):
    """Sorted words of one kind, with (limit key or None, weights)."""
    rng = np.random.default_rng(seed)

    def runs(lengths):
        words = np.unique(rng.integers(0, 2 ** word_bits - 1,
                                       size=2 * len(lengths),
                                       dtype=np.uint64, endpoint=True))
        return np.repeat(words[:len(lengths)], lengths)

    if kind == "short runs":   # runs of 1-3 keys, n not a multiple
        words = runs(rng.integers(1, 4, 3 * tile_n // 2 * 7 // 2))
    elif kind == "runs across two tiles":
        words = runs(rng.integers(tile_n // 2, tile_n + 2, 12))
    elif kind == "one word over many tiles":
        words = runs([5, 1, 40 * tile_n + 3, 2, tile_n])
    elif kind == "runs ending on tile edges":
        words = runs([tile_n, tile_n + 1, tile_n - 1, 1, 2 * tile_n - 1, 1,
                      tile_n])
    elif kind == "every key distinct":
        words = runs(np.ones(5 * tile_n + 3, np.int64))
    elif kind == "one key":
        words = runs([1])
    else:
        raise ValueError(kind)
    keys = tenc.keys_from_u64(words)
    limit = None
    if word_bits < 64:   # an invalid tail past more than a tile
        limit = tenc.flag_key(word_bits)
        keys = torch.cat([keys, torch.full((2 * tile_n + 3,), limit)])
    # weights of 2^31 and more: every run of two or more wraps its sum
    w = (torch.from_numpy(rng.integers(2 ** 31, 2 ** 32, len(keys)))
         if weighted else None)
    return keys, w, limit


KINDS = ["short runs", "runs across two tiles", "one word over many tiles",
         "runs ending on tile edges", "every key distinct", "one key"]
# (threads, items, warp, look-back lanes)
CONFIGS = [(2, 4, 2, 2), (4, 4, 2, 4), (2, 8, 2, 32)]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_schedule_equals_run_encode(kind, weighted, cfg):
    tile_n = cfg[0] * cfg[1]
    seed = KINDS.index(kind) * 10 + weighted * 3 + CONFIGS.index(cfg)
    word_bits = 50 if seed % 2 else 64
    keys, w, limit = _stream(kind, seed, weighted, tile_n, word_bits)
    want_k, want_c, n_unique, total, checksum = run_encode(keys, w,
                                                           word_bits)
    status, stats, out_k, out_c, written = emulate(
        keys.numpy(), None if w is None else w.numpy(), limit, cfg, seed)
    assert stats == [n_unique, total, checksum]
    np.testing.assert_array_equal(out_k[:n_unique], want_k.numpy())
    np.testing.assert_array_equal(out_c[:n_unique], want_c.numpy())
    assert (written[:n_unique] == 1).all() and not written[n_unique:].any()
    assert all(w & PREFIX for w in status[:-(-total // tile_n)])
