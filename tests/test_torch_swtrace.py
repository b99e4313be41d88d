"""gassembler's traceback over filled SW matrices in one native call
(``csrc/swtrace.c`` ``gt4_sw_align_mats``, through the port's
``pipelines.gassemble.align_reads``) against the JAX package's per-read
loop (``genometester4_tpu.pipelines.gassemble.align_reads`` with the same
``sw_mats``) and against the port's host route (``fgx_sw_align_region8``,
its own fill in front): the kept reads, their rows and the ``-DD`` trace
on stderr must be equal.

The matrices come from one padded launch of several regions, as the card
route's prefetch lays them out (``swalign_cuda._batch_multi`` on CPU
tensors: views with ``n < n_cap`` and ``m < m_cap``), or from the native
host fill (contiguous)."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from chip_smoke import reference_cli
from genometester4_tpu.pipelines import gassemble as jax_gas
from genometester4_tpu_torch.cli import gassembler as port_cli
from genometester4_tpu_torch.ops import swalign, swalign_cuda
from genometester4_tpu_torch.pipelines import gassemble as port_gas
from genometester4_tpu_torch.tools import katk_fixture as kf
from genometester4_tpu_torch.utils import trace

torch.set_num_threads(1)

N_CODE = 4
COMP = np.array([3, 2, 1, 0, 4], np.int8)


def _mutate(rng, codes, rate):
    """Substitutions at ``rate``, and now and then a short indel."""
    out = codes.copy()
    hit = rng.random(len(out)) < rate
    out[hit] = (out[hit] + rng.integers(1, 4, hit.sum())) % 4
    r = rng.random()
    if r < 0.1 and len(out) > 40:
        at = int(rng.integers(10, len(out) - 10))
        out = np.concatenate([out[:at], out[at + int(rng.integers(1, 4)):]])
    elif r < 0.2:
        at = int(rng.integers(10, len(out) - 10))
        out = np.concatenate([out[:at], rng.integers(0, 4, 2).astype(np.int8),
                              out[at:]])
    return out.astype(np.int8)


def _region(rng, n, n_reads, read_bp):
    """A random reference of ``n`` and reads from it: most lie within it
    or hang over an end, with substitutions and indels; some are random,
    some carry Ns, some are reverse complements (which align poorly)."""
    ref = rng.integers(0, 4, n).astype(np.int8)
    flank = rng.integers(0, 4, read_bp).astype(np.int8)
    src = np.concatenate([flank, ref, flank[::-1]])
    reads = []
    for _ in range(n_reads):
        kind = rng.random()
        if kind < 0.1:
            rd = rng.integers(0, 4, read_bp).astype(np.int8)
        else:
            bp = int(rng.integers(read_bp * 2 // 3, read_bp + 1))
            at = int(rng.integers(read_bp // 2, read_bp + n - bp // 2))
            rd = _mutate(rng, src[at:at + bp],
                         float(rng.choice([0.0, 0.01, 0.03, 0.08])))
            if kind < 0.15:
                rd = COMP[rd[::-1]]
            elif kind < 0.2:
                rd[rng.random(len(rd)) < 0.05] = N_CODE
        reads.append(rd[:read_bp])
    return ref, reads


def _case_random(rng):
    return [_region(rng, 200, int(rng.integers(40, 90)), 150)
            for _ in range(4)]


def _case_strided(rng):
    # one launch over regions of several n and m: views with n < n_cap
    # and m < m_cap in every region but the widest
    return [_region(rng, n, b, m) for n, b, m in
            ((200, 50, 150), (187, 40, 141), (163, 30, 117), (200, 12, 99))]


def _case_all_n(rng):
    ref, reads = _region(rng, 200, 30, 150)
    for i in range(0, 30, 3):
        reads[i] = np.full(len(reads[i]), N_CODE, np.int8)
    return [(ref, reads)]


def _case_tied(rng):
    # the reference repeats itself, so a read from it scores its maximum
    # at two cells; the first in row-major order must win
    half = rng.integers(0, 4, 100).astype(np.int8)
    ref = np.concatenate([half, half])
    reads = []
    for _ in range(30):
        bp = int(rng.integers(40, 90))
        at = int(rng.integers(0, 100 - bp + 1))
        reads.append(half[at:at + bp].copy())
    return [(ref, reads)]


def _case_cap(rng):
    # 1,100 near-identical reads: the 1,024th kept read stops the scan
    ref = rng.integers(0, 4, 200).astype(np.int8)
    reads = []
    for _ in range(1100):
        rd = ref[25:175].copy()
        at = int(rng.integers(0, 150))
        rd[at] = (rd[at] + 1) % 4
        reads.append(rd)
    return [(ref, reads)]


def _case_short_ref(rng):
    return [_region(rng, 120, 40, 100), _region(rng, 61, 20, 50)]


def _case_wide(rng):
    # reads up to 2,000 wide that span the reference with long flanks
    ref = rng.integers(0, 4, 200).astype(np.int8)
    reads = []
    for _ in range(12):
        bp = int(rng.integers(1500, 2001))
        left = int(rng.integers(0, bp - 210))
        rd = rng.integers(0, 4, bp).astype(np.int8)
        seg = _mutate(rng, ref, 0.01)
        rd[left:left + len(seg)] = seg
        reads.append(rd)
    return [(ref, reads)]


CASES = {
    "random": (_case_random, "host"),
    "strided": (_case_strided, "launch"),
    "all_n": (_case_all_n, "launch"),
    "tied": (_case_tied, "host"),
    "cap": (_case_cap, "host"),
    "short_ref": (_case_short_ref, "launch"),
    "wide": (_case_wide, "host"),
}


def _fills(regions, how):
    """Each region's (score, sx, sy): views of one padded launch, or the
    native host fill's contiguous arrays."""
    batches = [(ref, port_gas.pad_reads(_port_reads(reads)))
               for ref, reads in regions]
    if how == "launch":
        return swalign_cuda.sw_matrices_batch_device_multi(batches,
                                                           device="cpu")
    return [swalign.sw_matrices_batch(ref, b) for ref, b in batches]


def _reads(gas, codes):
    return [gas.GASMRead(f"r{i}".encode(),
                         "".join("ACGTN"[c] for c in rd).encode(),
                         rd, 1)
            for i, rd in enumerate(codes)]


def _port_reads(codes):
    return _reads(port_gas, codes)


def _align(gas, ref, codes, debug, sw_mats):
    params = gas.Params(debug=debug)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        a_reads, rows = gas.align_reads(ref, _reads(gas, codes), params,
                                        sw_mats=sw_mats)
    return [r.name for r in a_reads], rows, err.getvalue()


@pytest.mark.parametrize("debug", [0, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_native_traceback_equals_per_read_loop(case, debug, monkeypatch):
    make, how = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case) + 2000)
    regions = make(rng)
    fills = _fills(regions, how)
    if how == "launch":
        assert any(not f[0].flags.c_contiguous for f in fills)
    kept = 0
    for (ref, codes), mats in zip(regions, fills):
        want = _align(jax_gas, ref, codes, debug, mats)
        before = trace.total("align.native")
        got = _align(port_gas, ref, codes, debug, mats)
        assert trace.total("align.native") - before == len(codes)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
        kept += len(got[0])
        # the host route (its own fill, fused) gives the same
        monkeypatch.setenv("GT4_TPU_DEVICE_SW", "0")
        host = _align(port_gas, ref, codes, debug, None)
        monkeypatch.delenv("GT4_TPU_DEVICE_SW")
        assert host[0] == got[0] and host[2] == got[2]
        np.testing.assert_array_equal(host[1], got[1])
        if case == "cap":
            assert len(got[0]) == port_gas.MAX_ALIGNED_READS
            assert got[2].count("maximum number of aligned reads") == 1
        if case == "all_n":
            dropped = {f"r{i}".encode() for i in range(0, len(codes), 3)}
            assert not dropped & set(got[0])
        if case == "tied":
            for b, rd in enumerate(codes):
                score = mats[0][b, :, :len(rd) + 1]
                assert (score == score.max()).sum() > 1
        if debug == 2:
            assert "divergen" in got[2]
    assert kept > 0


def test_debug3_keeps_the_per_read_loop():
    """-DDD fills and traces every read on the host for the alignment
    dump: no read reaches the native call, and stderr equals the JAX
    package's."""
    rng = np.random.default_rng(2100)
    regions = _case_random(rng)[:1]
    mats = _fills(regions, "launch")[0]
    ref, codes = regions[0]
    want = _align(jax_gas, ref, codes, 3, mats)
    before = trace.total("align.native")
    got = _align(port_gas, ref, codes, 3, mats)
    assert trace.total("align.native") == before
    assert got[0] == want[0] and got[2] == want[2]
    np.testing.assert_array_equal(got[1], want[1])


@pytest.fixture(scope="module")
def small_katk(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("swtrace_katk")
    kf.write_katk_fixture(str(tmp), seed=5, n_regions=8)
    r, _ = reference_cli(str(tmp), "gmer_counter", kf.INDEX_ARGS,
                         GT4_TPU_COUNT_IMPL="host")
    assert r.returncode == 0, r.stderr
    yield tmp
    (tmp / "db.idx").unlink()


def _run_port(tmp, args):
    out, err = io.StringIO(), io.StringIO()
    old = os.getcwd()
    os.chdir(tmp)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = port_cli.main(args, device="cpu")
    finally:
        os.chdir(old)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("debug", [0, 3])
def test_align_native_counts_the_reads_aligned(small_katk, monkeypatch,
                                               debug):
    """On the fixture's card route (the plain fill on the CPU) every read
    handed to alignment goes through the native call; under -DDD none
    does. Output equals the port's host route's."""
    monkeypatch.delenv("GT4_TPU_DEVICE_SW", raising=False)
    handed = []
    orig = port_gas.align_reads

    def counting(ref_codes, reads, params, **kw):
        handed.append(len(reads))
        return orig(ref_codes, reads, params, **kw)

    monkeypatch.setattr(port_gas, "align_reads", counting)
    args = kf.ARGS + ["-D"] * debug
    before = trace.total("align.native")
    got = _run_port(small_katk, args)
    native = trace.total("align.native") - before
    assert got[0] == 0 and sum(handed) > 0
    assert native == (sum(handed) if debug < 3 else 0)
    monkeypatch.setenv("GT4_TPU_DEVICE_SW", "0")
    assert _run_port(small_katk, args) == got


def test_matrices_of_another_layout_are_refused():
    """The native call reads the three matrices through one pair of
    strides with dense columns: matrices that do not share such a layout,
    or do not cover the region, are refused before any pointer is
    passed."""
    rng = np.random.default_rng(2200)
    (ref, codes), = _case_short_ref(rng)[:1]
    score, sx, sy = _fills([(ref, codes)], "host")[0]
    params = port_gas.Params()
    bad = [(score, np.asfortranarray(sx), sy),
           (score[:, :, ::-1], sx, sy),
           (score[:, :-5], sx[:, :-5], sy[:, :-5]),
           (score.astype(np.int32), sx, sy)]
    for mats in bad:
        with pytest.raises(ValueError):
            port_gas.align_reads(ref, _port_reads(codes), params,
                                 sw_mats=mats)
