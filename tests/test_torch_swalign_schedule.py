"""Kernels C and D's schedule (``csrc/swalign.cu``), emulated in numpy and
held against ``sw_fill``, the plain version: integer contract, tolerance 0.

The CUDA kernels cannot run here, so their schedule is mirrored step for
step: one warp per read, lane strips of S columns, the skewed wavefront
with the left neighbour's state shifted one lane per step, the 32-row
ring copied out a row per step, slabs of 256 columns with the last
column's state carried to lane 0 of the next slab (read one step ahead),
and kernel D's blocks of four reads over one staged reference. Every
output cell starts as garbage, so a cell the schedule never writes shows.
The kernels themselves are held against ``sw_fill`` on the card in
``tests/test_torch_cuda.py``. Also here: ``sw_fill`` against the JAX
package's native fill and Pallas lanes kernel at widths past one slab."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genometester4_tpu.ops import swalign as jax_sw
from genometester4_tpu.ops import swalign_pallas as jax_pallas
from genometester4_tpu_torch.ops.swalign import sw_fill

torch.set_num_threads(1)

# csrc/swalign.cu
WARP = 32
RING_ROWS = 32
MAX_STRIP = 8
SHARED_WARPS = 4
MAX_BND_ROWS = 512
MAX_REF_SHARED = 16384
MAX_SHARED_BYTES = 232448
NEG = -1000
NONE = 6
SLAB = WARP * MAX_STRIP
GARBAGE = 77


def ring_stride(S):
    """Words per ring row: the slab's 32 * S + 1 columns, padded so that
    the stride is S + 1 modulo 32 banks."""
    return 33 * S + 1


def make_plan(n, m, warps, one_ref):
    """Mirror of ``make_plan``: (S, slabs, boundary in shared memory,
    reference staged, shared bytes per block)."""
    strip = -(-m // WARP)
    S = min(max(strip, 1), MAX_STRIP)
    slabs = m > WARP * S
    bnd_shared = slabs and n + 1 <= MAX_BND_ROWS
    ref_shared = one_ref and n <= MAX_REF_SHARED
    bnd_bytes = 16 * (n + 1) if bnd_shared else 0
    ring_bytes = 4 * RING_ROWS * ring_stride(S)
    total = warps * (bnd_bytes + ring_bytes) + (n if ref_shared else 0)
    return S, slabs, bnd_shared, ref_shared, total


def test_ring_stores_are_free_of_bank_conflicts():
    """At one step lane L stores column L*S + s of ring row t - L: the 32
    words fall in 32 banks for every S, and the flush of one row reads
    consecutive words."""
    lane = np.arange(WARP)
    for S in range(1, MAX_STRIP + 1):
        for t in (0, 5, 31, 40):
            for s in range(S):
                word = ((t - lane) % RING_ROWS) * ring_stride(S) \
                    + lane * S + s + 1
                assert len(set(word % 32)) == WARP, (S, t, s)
        assert ring_stride(S) >= WARP * S + 1
        assert 4 * RING_ROWS * ring_stride(S) % 16 == 0


def _wrap8(x):
    return ((x + 128) & 255) - 128


def _sub_table(b):
    """``sub_table`` over int64 arrays: the read code's scores against
    reference codes 0..3 as the signed bytes of a word."""
    b = np.asarray(b, np.int64)
    shift = 8 * np.minimum(b, 3)
    word = (0xFDFDFDFD & ~(0xFF << shift)) | (2 << shift)
    return np.where(b >= 4, 0, word)


def _sub_score(table, a):
    """``prmt.b32 table, 0, sub_selector(a)``: byte a of (table, 0),
    sign-extended."""
    a = np.asarray(a, np.int64)
    byte = np.where(a < 4, (table >> (8 * np.minimum(a, 3))) & 0xFF, 0)
    return np.where(byte >= 128, byte - 256, byte)


def test_substitution_table():
    """The per-column table and the prmt lookup give the recurrence's
    substitution score for every pair of codes A C G T N GAP NONE."""
    for a in range(7):
        for b in range(7):
            want = 0 if a >= 4 or b >= 4 else (2 if a == b else -3)
            assert _sub_score(_sub_table(b), a) == want, (a, b)


def _cell(a, b, diag, ls, ll, ts, tl):
    """``sw_cell`` over arrays, with the substitution score looked up as
    the kernel does: (cell, csx, csy, ls, ll, ts, tl)."""
    sub = _sub_score(_sub_table(b), a)
    dsc = diag + sub
    cell = np.maximum(dsc, 0)
    lo, le = cell - 4, ls - 2
    ll = np.where(le > lo, _wrap8(ll + 1), 0)
    ls = np.maximum(lo, le)
    left = ls >= cell
    cell = np.maximum(cell, ls)
    to, te = cell - 4, ts - 2
    tl = np.where(te > to, _wrap8(tl + 1), 0)
    ts = np.maximum(to, te)
    top = ts >= cell
    cell = np.maximum(cell, ts)
    d = np.where(dsc > 0, -1, 0)
    csx = np.where(top, 0, np.where(left, _wrap8(-ll), d))
    csy = np.where(top, _wrap8(-tl), np.where(left, 0, d))
    return cell, csx, csy, ls, ll, ts, tl


def _block(refs, lims, reads, n, m, outs, bnd, S):
    """``sw_warp`` for the R warps of one block at once, arrays [R, lane]:
    refs [R, n] (each warp's reference source), lims [R], reads [R, m],
    outs three [R, n+1, m+1] planes, bnd [R, n+1, 4]."""
    R = len(lims)
    width = WARP * S
    lims = lims if m else np.zeros_like(lims)
    for o in outs:   # row 0 and the rows past lim
        o[:, 0] = 0
        for r in range(R):
            o[r, lims[r] + 1:] = 0
    ring = [np.full((R, RING_ROWS, ring_stride(S)), GARBAGE, o.dtype)
            for o in outs]
    for p in ring:
        p[:, :, 0] = 0
    lane = np.arange(WARP)
    rows = np.arange(R)[:, None]
    for base in range(0, m, width):
        first, last = base == 0, base + width >= m
        k0, k1 = (0 if first else 1), (m - base if last else width)
        j = base + lane[:, None] * S + np.arange(S)[None, :] + 1
        code = np.where(j <= m, reads[:, np.minimum(j, m) - 1], NONE)
        up = np.zeros((R, WARP, S), np.int64)
        ts = np.full((R, WARP, S), NEG, np.int64)
        tl = np.zeros((R, WARP, S), np.int64)
        diag_in = np.zeros((R, WARP), np.int64)
        ls_in = np.full((R, WARP), NEG, np.int64)
        ll_in = np.zeros((R, WARP), np.int64)
        nxt = (np.tile([0, NEG, 0, 0], (R, 1)) if first
               else bnd[:, 1].copy())
        prev_h = np.zeros(R, np.int64)
        a_next = np.zeros((R, WARP), np.int64)
        a_next[:, 0] = refs[:, 0]
        for t in range(int(lims.max()) + WARP - 1):
            run = (t < lims + WARP - 1) & (lims > 0)
            i = t - lane + 1
            diag, ls, ll = diag_in.copy(), ls_in.copy(), ll_in.copy()
            if first:
                diag[:, 0], ls[:, 0], ll[:, 0] = 0, NEG, 0
            else:
                diag[:, 0], ls[:, 0], ll[:, 0] = prev_h, nxt[:, 1], nxt[:, 2]
                prev_h = nxt[:, 0].copy()
                ahead = run & (t + 1 < lims)   # lane 0's row i = t + 1
                if ahead.any():
                    nxt[ahead] = bnd[ahead, t + 2]
            valid = (i >= 1)[None, :] & (i[None, :] <= lims[:, None]) \
                & run[:, None]
            a = a_next.copy()   # loaded one step ahead
            ahead = (i >= 0)[None, :] & (i[None, :] < lims[:, None])
            a_next = np.where(ahead, refs[rows, np.clip(i, 0, n - 1)[None, :]],
                              a_next)
            slot = (i - 1) & (RING_ROWS - 1)
            for s in range(S):
                got = _cell(a, code[:, :, s], diag, ls, ll, ts[:, :, s],
                            tl[:, :, s])
                cell = got[0]
                ls = np.where(valid, got[3], ls)
                ll = np.where(valid, got[4], ll)
                ts[:, :, s] = np.where(valid, got[5], ts[:, :, s])
                tl[:, :, s] = np.where(valid, got[6], tl[:, :, s])
                diag = np.where(valid, up[:, :, s], diag)
                up[:, :, s] = np.where(valid, cell, up[:, :, s])
                k = lane * S + s + 1   # past k1: never copied out
                rr, ll_ = np.nonzero(valid)
                for p, v in zip(ring, got[:3]):
                    p[rr, slot[ll_], k[ll_]] = v[rr, ll_]
            w = np.flatnonzero(valid[:, WARP - 1])
            if not last and len(w):   # lane 31 leaves the last column
                bnd[w, i[WARP - 1]] = np.stack([up[w, WARP - 1, S - 1],
                                        ls[w, WARP - 1], ll[w, WARP - 1],
                                        np.zeros(len(w), np.int64)], axis=1)
            # __shfl_up_sync(…, 1): lane 0 keeps its own value
            diag_in = np.concatenate([diag[:, :1], diag[:, :-1]], axis=1)
            ls_in = np.concatenate([ls[:, :1], ls[:, :-1]], axis=1)
            ll_in = np.concatenate([ll[:, :1], ll[:, :-1]], axis=1)
            r = t - (WARP - 2)
            if r >= 1:   # copy out the row lane 31 finished
                for w in np.flatnonzero(run):
                    for o, p in zip(outs, ring):
                        o[w, r, base + k0:base + k1 + 1] = \
                            p[w, (r - 1) & (RING_ROWS - 1), k0:k1 + 1]


def emulate(refs, reads, nvec, one_ref):
    """Kernel C (``one_ref`` False: refs [B, n], nvec [B]) or D (refs [n])
    as scheduled on the card -> (score int16, sx int8, sy int8)."""
    B, m = reads.shape
    n = refs.shape[-1]
    warps = SHARED_WARPS if one_ref else 1
    S, slabs, bnd_shared, ref_shared, total = make_plan(n, m, warps,
                                                        one_ref)
    assert total <= MAX_SHARED_BYTES
    outs = [np.full((B, n + 1, m + 1), GARBAGE, dt)
            for dt in (np.int16, np.int8, np.int8)]
    for g in range(0, B, warps):
        w = slice(g, min(B, g + warps))
        R = w.stop - w.start
        if one_ref:
            src = refs.copy() if ref_shared else refs   # staged once
            rsrc = np.broadcast_to(src, (R, n)).astype(np.int64)
            lims = np.full(R, n, np.int64)
        else:
            rsrc = refs[w].astype(np.int64)
            lims = np.clip(nvec[w].astype(np.int64), 0, n)
        # in shared memory or in the scratch tensor: garbage either way
        bnd = np.full((R, n + 1, 4), 12345, np.int64)
        _block(rsrc, lims, reads[w].astype(np.int64), n, m,
               [o[w] for o in outs], bnd, S)
    return outs


def _fill(refs, reads, nvec):
    return [t.numpy() for t in sw_fill(torch.from_numpy(refs),
                                       torch.from_numpy(reads),
                                       torch.from_numpy(nvec))]


def _inputs(seed, B, n, m):
    """Codes with 2% N, odd reads padded with 6 past a random length,
    per-read reference lengths from -1 to n + 2 (the first two 0 and
    n + 5)."""
    rng = np.random.default_rng(seed)
    refs = rng.integers(0, 4, (B, n)).astype(np.int8)
    refs[rng.random((B, n)) < 0.02] = 4
    reads = rng.integers(0, 4, (B, m)).astype(np.int8)
    reads[rng.random((B, m)) < 0.02] = 4
    mlen = rng.integers(m // 2, m + 1, B)
    mlen[::2] = m
    reads[np.arange(m)[None, :] >= mlen[:, None]] = 6
    nvec = rng.integers(-1, n + 3, B).astype(np.int32)
    nvec[:2] = [0, n + 5]
    return refs, reads, nvec


def _assert_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


WIDTHS = [0, 1, 31, 32, 33, SLAB - 1, SLAB, SLAB + 1, 1473, 2000]


@pytest.mark.parametrize("m", WIDTHS)
def test_lanes_schedule_equals_sw_fill(m):
    """Kernel C's schedule: one reference and length per read (0, past
    n_cap, ragged), every width from a lane's strip to eight slabs."""
    refs, reads, nvec = _inputs(m + 1, 5, 13, m)
    _assert_equal(emulate(refs, reads, nvec, one_ref=False),
                  _fill(refs, reads, nvec))


@pytest.mark.parametrize("m", WIDTHS)
def test_shared_schedule_equals_sw_fill(m):
    """Kernel D's schedule: one reference for six reads, so blocks of four
    warps with the second block two reads short."""
    refs, reads, _ = _inputs(m + 2, 6, 11, m)
    ref = refs[0]
    want = _fill(np.tile(ref, (6, 1)), reads, np.full(6, 11, np.int32))
    _assert_equal(emulate(ref, reads, None, one_ref=True), want)


@pytest.mark.parametrize("one_ref", [False, True])
def test_schedule_boundary_in_scratch(one_ref):
    """A reference of more than 511 rows with reads past one slab: the
    boundary leaves shared memory for the scratch tensor."""
    n, m = 520, SLAB + 40
    assert make_plan(n, m, 1, one_ref)[1:3] == (True, False)
    refs, reads, nvec = _inputs(n, 2, n, m)
    if one_ref:
        got = emulate(refs[0], reads, None, one_ref=True)
        want = _fill(np.tile(refs[0], (2, 1)), reads,
                     np.full(2, n, np.int32))
    else:
        got = emulate(refs, reads, nvec, one_ref=False)
        want = _fill(refs, reads, nvec)
    _assert_equal(got, want)


def _wrap_across_slabs():
    """One read matches the reference for 300 columns and then leaves a
    left gap of more than 200 columns: its length wraps as int8 and is
    carried over the slab boundary at column 512."""
    rng = np.random.default_rng(512)
    n, m = 310, 700
    ref = rng.integers(0, 4, n).astype(np.int8)
    reads = np.stack([np.concatenate([ref[:300], rng.integers(0, 4, 400)]),
                      rng.integers(0, 4, m)]).astype(np.int8)
    return ref, reads


@pytest.mark.parametrize("one_ref", [False, True])
def test_schedule_gap_wrap_across_slab_boundary(one_ref):
    ref, reads = _wrap_across_slabs()
    n = len(ref)
    refs, nvec = np.tile(ref, (2, 1)), np.full(2, n, np.int32)
    want = _fill(refs, reads, nvec)
    # row 300: the left gap from column 300 wraps at 428 and is still open
    # on both sides of 512, where the boundary carries it
    gap = want[1][0, 300]
    assert gap[429] > 0 and gap[512] > 0 and gap[513] > 0
    got = (emulate(ref, reads, None, one_ref=True) if one_ref
           else emulate(refs, reads, nvec, one_ref=False))
    _assert_equal(got, want)


@pytest.mark.parametrize("n", [0, 1, 200, 511, 512, 16384, 16385, 1 << 20])
@pytest.mark.parametrize("m", [0, 1, 152, SLAB, SLAB + 1, 2000, 1 << 20])
def test_plan_fits_shared_memory(n, m):
    """Every (n, m) launches: a block's shared memory stays within the
    card's 227 KB for kernel C (one warp) and D (four warps, staged
    reference), one pass up to 256 columns, slabs past it."""
    for warps, one_ref in ((1, False), (SHARED_WARPS, True)):
        S, slabs, bnd_shared, ref_shared, total = make_plan(n, m, warps,
                                                            one_ref)
        assert total <= MAX_SHARED_BYTES
        assert slabs == (m > SLAB) and S == min(max(-(-m // WARP), 1), 8)
        assert bnd_shared == (slabs and n < MAX_BND_ROWS)
        assert ref_shared == (one_ref and n <= MAX_REF_SHARED)


@pytest.mark.parametrize("m", [1473, 2000])
def test_sw_fill_wide_reads_equal_jax(m):
    """``sw_fill`` past the old kernel limits equals the JAX package's
    native fill per read (ragged references) and its Pallas lanes kernel
    in interpret mode."""
    refs, reads, nvec = _inputs(m, 3, 16, m)
    got = _fill(refs, reads, nvec)
    for b in range(3):
        k = int(np.clip(nvec[b], 0, 16))
        want = jax_sw.sw_matrices_batch(refs[b, :k], reads[b:b + 1])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b, :k + 1], w[0])
            assert not g[b, k + 1:].any()
    run = jax_pallas.make_sw_pallas_lanes(16, m, interpret=True)
    want = [jax_sw.diag_to_matrix(np.asarray(x), 16, m)
            for x in run(jnp.asarray(refs), jnp.asarray(reads),
                         jnp.asarray(nvec))]
    _assert_equal(got, [want[0].astype(np.int16), want[1].astype(np.int8),
                        want[2].astype(np.int8)])
