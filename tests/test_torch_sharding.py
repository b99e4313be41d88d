"""Port vs JAX: glistmaker's mesh counting route.

The JAX package runs ``count_kmers_sharded`` on conftest's 8 virtual CPU
devices (its default ``resort`` merge); the port runs its own on a mesh of
8 ``cpu`` slots, in both merge modes (``bitonic`` reaches kernel E's plain
version). Results are compared bit for bit, as are the pieces:
``merge_gathered_sources`` (JAX outside shard_map, bitonic with
``use_pallas=False``), the prefix routing and the mesh shape.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import random_fasta
from genometester4_tpu.io.fasta import parse_sequences
from genometester4_tpu.ops.encode import join_u64, split_u64
from genometester4_tpu.parallel import sharding as jsh
from genometester4_tpu_torch.ops import encode as tenc
from genometester4_tpu_torch.parallel import sharding as port
from genometester4_tpu_torch.pipelines import listmaker as port_lm
from genometester4_tpu_torch.utils import trace


torch.set_num_threads(1)

MODES = ["resort", "bitonic"]


@pytest.fixture
def jax_default_merge(monkeypatch):
    monkeypatch.delenv("GT4_TPU_MESH_MERGE", raising=False)


def _cpu_mesh(n=8, dp=None):
    return port.make_mesh(n, dp=dp, devices=["cpu"] * n)


def _port_sharded(monkeypatch, mode, codes, k, mesh, **kw):
    monkeypatch.setenv("GT4_TPU_MESH_MERGE", mode)
    try:
        return port.count_kmers_sharded(codes, k, mesh, **kw)
    finally:
        monkeypatch.delenv("GT4_TPU_MESH_MERGE")


def _single_chip(codes, k):
    shards = list(port_lm.count_chunks(codes, k, chunk_bases=1 << 15,
                                       device="cpu"))
    out = list(port_lm.merge_sorted_shards(shards, device="cpu"))
    return (np.concatenate([w for w, _ in out]),
            np.concatenate([c for _, c in out]))


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.uint64 and got[1].dtype == np.uint32


@pytest.mark.parametrize("k,dp", [(16, 2), (25, 1), (8, 4)])
def test_sharded_equals_jax(rng, monkeypatch, jax_default_merge, k, dp):
    """tests/test_sharding.py:27-36 on both packages."""
    assert len(jax.devices()) == 8
    text = random_fasta(rng, 6, 2000, 5000, n_prob=0.01)
    codes = parse_sequences(text.encode()).codes
    want = jsh.count_kmers_sharded(codes, k, jsh.make_mesh(8, dp=dp),
                                   chunk_bases=1 << 13)
    for mode in MODES:
        _assert_same(_port_sharded(monkeypatch, mode, codes, k,
                                   _cpu_mesh(8, dp), chunk_bases=1 << 13),
                     want)


def test_dup_heavy_shrink_then_grow_equals_jax(rng, monkeypatch,
                                               jax_default_merge):
    """A tiled motif (the slack shrinks) then a random tail (buckets
    overflow and the step runs again), many steps."""
    motif = "".join("ACGT"[i] for i in rng.integers(0, 4, 97))
    text = ">dup\n" + motif * 700 + "\n>uniq\n" + "".join(
        "ACGT"[i] for i in rng.integers(0, 4, 60000)) + "\n"
    codes = parse_sequences(text.encode()).codes
    want = jsh.count_kmers_sharded(codes, 16, jsh.make_mesh(8, dp=2),
                                   chunk_bases=1 << 12)
    for mode in MODES:
        reruns = trace.total("mesh.reruns")
        _assert_same(_port_sharded(monkeypatch, mode, codes, 16,
                                   _cpu_mesh(8, 2), chunk_bases=1 << 12),
                     want)
        assert trace.total("mesh.reruns") > reruns   # counted, as it ran


def test_adapt_state_carries_like_jax(rng, monkeypatch, jax_default_merge):
    """The adapted cap_factor equals JAX's and carries into the next call,
    which gives the same result."""
    motif = "".join("ACGT"[i] for i in rng.integers(0, 4, 83))
    codes = parse_sequences((">dup\n" + motif * 900 + "\n").encode()).codes
    jstate = {}
    want = jsh.count_kmers_sharded(codes, 16, jsh.make_mesh(8, dp=2),
                                   chunk_bases=1 << 12, adapt_state=jstate)
    for mode in MODES:
        state = {}
        got = _port_sharded(monkeypatch, mode, codes, 16, _cpu_mesh(8, 2),
                            chunk_bases=1 << 12, adapt_state=state)
        _assert_same(got, want)
        assert state == jstate and 0 < state["cap_factor"] < port.CAP_FACTOR
        again = _port_sharded(monkeypatch, mode, codes, 16, _cpu_mesh(8, 2),
                              chunk_bases=1 << 12, adapt_state=state)
        _assert_same(again, want)


def test_two_slot_bitonic_large_chunk(monkeypatch, jax_default_merge):
    """The shape at which JAX's bitonic formulation lost words under
    shard_map (tests/test_sharding.py:39-54: S = 2, chunk 2^16, k = 25,
    cap 65512): the port's bitonic merge equals its single-chip route and
    JAX's mesh route."""
    sym = np.frombuffer(b"ACGT", np.uint8)
    seq = sym[np.random.default_rng(1).integers(0, 4, 2 << 16)]
    codes = parse_sequences(b">s\n" + seq.tobytes() + b"\n").codes
    mesh = _cpu_mesh(2)
    assert port.sharded_count_step(mesh, 25, 1 << 16)[1] == 2 * 65512
    got = _port_sharded(monkeypatch, "bitonic", codes, 25, mesh,
                        chunk_bases=1 << 16)
    _assert_same(got, _single_chip(codes, 25))
    _assert_same(got, jsh.count_kmers_sharded(codes, 25, jsh.make_mesh(2),
                                              chunk_bases=1 << 16))


def _sources(rng, S, cap):
    """S gathered sources as JAX holds them: sorted unique 50-bit words in
    the first bn[s] slots (drawn from one pool, so words repeat across
    sources), unsorted garbage after; a third of the counts near 2^32, so
    sums wrap."""
    pool = np.unique(rng.integers(0, 1 << 50, 3 * cap, dtype=np.uint64))
    bn = rng.integers(0, cap + 1, S)
    bn[0] = cap
    words = rng.integers(0, 1 << 50, (S, cap), dtype=np.uint64)
    counts = rng.integers(0, 1 << 32, (S, cap), dtype=np.uint64)
    for s in range(S):
        words[s, :bn[s]] = np.sort(rng.choice(pool, bn[s], replace=False))
        near = rng.random(bn[s]) < 0.33
        counts[s, :bn[s]] = np.where(
            near, (1 << 32) - rng.integers(1, 100, bn[s]),
            rng.integers(1, 1000, bn[s]))
    hi, lo = split_u64(words.ravel())
    return (hi.reshape(S, cap), lo.reshape(S, cap),
            counts.astype(np.uint32), bn.astype(np.int32))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("S,tight", [(1, False), (2, False), (3, False),
                                     (4, False), (8, False), (4, True)])
def test_merge_gathered_sources_equals_jax(mode, S, tight):
    """n_uniq, the overflow flag, the leading n_uniq keys and every count
    equal JAX's and a numpy union with u32-wrapped sums (tight: a merge
    buffer too small, overflow only).

    JAX's resort runs under ``jax.jit``. Its bitonic formulation runs op by
    op: under ``jax.jit`` on the CPU it loses words at S = 2 here (306 of
    470 unique words) even outside shard_map, the XLA fusion hazard of
    ``sharding.py:170-181``; op by op it is right."""
    rng = np.random.default_rng(S * 10 + tight + len(mode))
    cap = 300
    bh, bl, bc, bn = _sources(rng, S, cap)
    total = int(bn.sum())
    merge_cap = cap if S == 1 else (cap + total // 2 if tight
                                    else S * cap + cap)
    S2 = 1 << max(0, (S - 1).bit_length())
    geom = dict(S=S, S2=S2, cap=cap, cap2=512, merge_cap=merge_cap)
    jfn = functools.partial(jsh.merge_gathered_sources, use_pallas=False,
                            hi_bits=18, mode=mode, **geom)
    if mode == "resort":
        jfn = jax.jit(jfn)
    mhi, mlo, mcnt, n_uniq, ovf = (np.asarray(x) for x in
                                   jfn(bh, bl, bc, bn))
    keys, counts, n = port.buckets_from_pairs(bh, bl, bc, bn)
    mk, mc, pn, povf = port.merge_gathered_sources(keys, counts, n,
                                                   mode=mode, **geom)
    assert povf == bool(ovf) == tight
    if tight:
        return
    assert pn == int(n_uniq) > 0
    assert mk.shape == mc.shape == (merge_cap,)
    g_hi, g_lo = tenc.pair_from_keys(mk[:pn])
    np.testing.assert_array_equal(g_hi, mhi[:pn])
    np.testing.assert_array_equal(g_lo, mlo[:pn])
    np.testing.assert_array_equal(mc.numpy().astype(np.uint32), mcnt)
    # numpy: the union of the valid prefixes, counts summed mod 2^32
    w = np.concatenate([join_u64(bh[s, :bn[s]], bl[s, :bn[s]])
                        for s in range(S)])
    c = np.concatenate([bc[s, :bn[s]] for s in range(S)]).astype(np.uint64)
    uw, inv = np.unique(w, return_inverse=True)
    uc = np.bincount(inv, weights=c.astype(np.float64)).astype(np.uint64)
    np.testing.assert_array_equal(tenc.u64_from_keys(mk[:pn]), uw)
    np.testing.assert_array_equal(mc[:pn].numpy().astype(np.uint64),
                                  uc & np.uint64(0xFFFFFFFF))
    assert (uc >> np.uint64(32)).any() == (S > 1)   # some sums wrapped


@pytest.mark.parametrize("k", [8, 16, 25, 32])
def test_owner_shard_and_route_equal_jax(k):
    rng = np.random.default_rng(k)
    words = np.unique(rng.integers(0, 2 ** (2 * k) - 1, 3000,
                                   dtype=np.uint64, endpoint=True))
    m = len(words)
    N = m + 100
    hi, lo = split_u64(np.pad(words, (0, N - m)))
    keys = tenc.keys_from_u64(words)
    counts = torch.from_numpy(rng.integers(1, 1 << 32, m, dtype=np.int64))
    jc = np.pad(counts.numpy().astype(np.uint32), (0, N - m))
    valid = np.arange(N) < m
    for kp in (1, 2, 4, 8):
        jo = np.asarray(jsh._owner_shard(jnp.asarray(hi[:m]),
                                         jnp.asarray(lo[:m]), k, kp))
        np.testing.assert_array_equal(
            port._owner_shard(keys, k, kp).numpy(), jo)
        for cap in (m // kp + 50, m // (2 * kp)):
            jb = [np.asarray(x) for x in jsh._route_by_prefix(
                jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(jc),
                jnp.asarray(valid), k, kp, cap)]
            bk, bc, bn, ovf = port._route_by_prefix(keys, counts, k, kp, cap)
            assert bn == jb[3].tolist() and ovf == bool(jb[4])
            for b in range(kp):
                f = min(bn[b], cap)
                g_hi, g_lo = tenc.pair_from_keys(bk[b, :f])
                np.testing.assert_array_equal(g_hi, jb[0][b, :f])
                np.testing.assert_array_equal(g_lo, jb[1][b, :f])
                np.testing.assert_array_equal(
                    bc[b, :f].numpy().astype(np.uint32), jb[2][b, :f])


def test_make_mesh_shapes_equal_jax():
    for n in range(1, 9):
        for dp in (None, 1, 2):
            kp = n // (dp or 1)
            if dp is not None and (kp < 1 or kp & (kp - 1)):
                with pytest.raises(ValueError, match="power of 2"):
                    port.make_mesh(n, dp=dp, devices=["cpu"] * 8)
                continue
            want = jsh.make_mesh(n, dp=dp).devices.shape
            mesh = port.make_mesh(n, dp=dp, devices=["cpu"] * 8)
            assert (mesh.shape["dp"], mesh.shape["kp"]) == want
            assert all(d == torch.device("cpu") for row in mesh.devices
                       for d in row)
    with pytest.raises(RuntimeError, match="no device"):
        port.make_mesh(devices=[])


@pytest.mark.parametrize("k", [14, 25])
def test_make_list_mesh_byte_identical(tmp_path, monkeypatch, rng, k):
    """make_list(mesh=...) writes the single-chip route's bytes in both
    merge modes, with cutoffs too, every record handed to the writer as
    a slice of the records the columns copied back; kernel E's wrapper
    never runs on the CPU."""
    fa = tmp_path / "in.fa"
    fa.write_text(random_fasta(rng, 4, 3000, 9000, n_prob=0.01))
    launches = trace.total("launch.merge_runs")
    for kw in ({}, {"min_count": 2}):
        port_lm.make_list([str(fa)], k, str(tmp_path / "one.list"),
                          device="cpu", **kw)
        want = (tmp_path / "one.list").read_bytes()
        assert len(want) > 48 or kw
        for mode in MODES:
            monkeypatch.setenv("GT4_TPU_MESH_MERGE", mode)
            whole = trace.total("list.records_whole")
            hdr = port_lm.make_list([str(fa)], k,
                                    str(tmp_path / "mesh.list"),
                                    device="cpu", mesh=_cpu_mesh(8, 2), **kw)
            assert (tmp_path / "mesh.list").read_bytes() == want
            assert (trace.total("list.records_whole") - whole
                    == hdr.n_words)
    assert trace.total("launch.merge_runs") == launches
    with pytest.raises(ValueError, match="canonical"):
        port_lm.make_list([str(fa)], k, str(tmp_path / "x.list"),
                          device="cpu", mesh=_cpu_mesh(), canonical=False)


def test_default_mesh_rule(monkeypatch):
    """JAX's rule: a mesh by default only on CUDA with more than one card,
    canonical k-mers and GT4_TPU_MESH != 0."""
    monkeypatch.setattr(port, "make_mesh", lambda: "mesh")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cuda = torch.device("cuda")
    assert port_lm._default_mesh(cuda, True) == "mesh"
    assert port_lm._default_mesh(cuda, False) is None
    assert port_lm._default_mesh(torch.device("cpu"), True) is None
    monkeypatch.setenv("GT4_TPU_MESH", "0")
    assert port_lm._default_mesh(cuda, True) is None
    monkeypatch.delenv("GT4_TPU_MESH")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert port_lm._default_mesh(cuda, True) is None
