"""Port vs JAX: the Smith-Waterman fill. ``sw_fill`` (the plain PyTorch
version of kernels C and D) must equal the Pallas kernels in interpret mode,
the numpy wavefront and the native C fill on whole matrices: integer
contract, tolerance 0. The CUDA kernels themselves are held against
``sw_fill`` in ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genometester4_tpu.ops import swalign as jax_sw
from genometester4_tpu.ops import swalign_pallas as jax_pallas
from genometester4_tpu_torch.ops import swalign_cuda
from genometester4_tpu_torch.ops.swalign import sw_fill
from genometester4_tpu_torch.pipelines import gassemble as port_gas
from genometester4_tpu_torch.utils import trace


torch.set_num_threads(1)


def _fill(refs, reads, nvec):
    return [t.numpy() for t in sw_fill(torch.from_numpy(refs),
                                       torch.from_numpy(reads),
                                       torch.from_numpy(nvec))]


def _shared(ref, reads):
    B = reads.shape[0]
    return _fill(np.tile(ref, (B, 1)), reads, np.full(B, len(ref), np.int32))


def _assert_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_sw_fill_equals_pallas_lanes_interpret():
    """Per-lane references and lengths, N codes, padded reads and
    B > 128 (two lane groups), as tests/test_gassembler.py:270-298."""
    rng = np.random.default_rng(270)
    n_cap, m_cap, B = 41, 33, 140
    refs = rng.integers(0, 5, size=(B, n_cap)).astype(np.int8)
    reads = rng.integers(0, 5, size=(B, m_cap)).astype(np.int8)
    nvec = rng.integers(5, n_cap + 1, size=B).astype(np.int32)
    mlen = rng.integers(5, m_cap + 1, size=B)
    for b in range(B):
        reads[b, mlen[b]:] = 6
        refs[b, nvec[b]:] = 6
    run = jax_pallas.make_sw_pallas_lanes(n_cap, m_cap, interpret=True)
    want = [jax_sw.diag_to_matrix(np.asarray(x), n_cap, m_cap)
            for x in run(jnp.asarray(refs), jnp.asarray(reads),
                         jnp.asarray(nvec))]
    want = [want[0].astype(np.int16), want[1].astype(np.int8),
            want[2].astype(np.int8)]
    _assert_equal(_fill(refs, reads, nvec), want)


@pytest.mark.parametrize("n,m,B", [(70, 40, 5), (1, 1, 3), (9, 1, 2),
                                   (1, 17, 2), (37, 64, 9)])
def test_sw_fill_equals_pallas_numpy_and_native(n, m, B):
    """One shared reference: make_sw_pallas (interpret), the numpy
    wavefront and the native C fill all equal sw_fill and the port's
    sw_pallas_matrices on the CPU."""
    rng = np.random.default_rng(n * 1000 + m)
    ref = rng.integers(0, 5, n).astype(np.int8)
    reads = rng.integers(0, 5, (B, m)).astype(np.int8)
    reads[:, m // 2:][rng.random((B, m - m // 2)) < 0.3] = 6
    got = _shared(ref, reads)
    _assert_equal(got, jax_pallas.sw_pallas_matrices(ref, reads,
                                                     interpret=True))
    _assert_equal(got, jax_sw.sw_matrices_batch_numpy(ref, reads))
    _assert_equal(got, jax_sw.sw_matrices_batch(ref, reads))
    _assert_equal(swalign_cuda.sw_pallas_matrices(ref, reads, device="cpu"),
                  got)


def test_sw_fill_int8_gap_length_wrap():
    """Gaps longer than 127 columns (rows): the int8 wrap of the gap
    length and of -length in sx/sy must match the native fill."""
    rng = np.random.default_rng(5)
    n = m = 300
    ref = rng.integers(0, 4, n).astype(np.int8)
    reads = np.stack([
        np.concatenate([ref[:140], rng.integers(0, 4, 160)]),
        np.concatenate([rng.integers(0, 4, 10), ref[:150],
                        rng.integers(0, 4, 140)])]).astype(np.int8)
    got = _shared(ref, reads)
    _assert_equal(got, jax_sw.sw_matrices_batch(ref, reads))
    for d in got[1:]:   # both directions reach the wrap
        assert d.min() == -128 and d.max() == 127


def test_sw_fill_lane_lengths_and_edges():
    """nvec below 0 or above n_cap clamps; rows past a lane's length are
    0; empty batches and widths give zero matrices."""
    rng = np.random.default_rng(31)
    B, n, m = 30, 41, 33
    refs = rng.integers(0, 5, (B, n)).astype(np.int8)
    reads = rng.integers(0, 5, (B, m)).astype(np.int8)
    nvec = rng.integers(-2, n + 5, B).astype(np.int32)
    got = _fill(refs, reads, nvec)
    for b in range(B):
        k = int(np.clip(nvec[b], 0, n))
        want = jax_sw.sw_matrices_batch(refs[b, :k], reads[b:b + 1])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b, :k + 1], w[0])
            assert not g[b, k + 1:].any()
    for shape in ((0, 5, 4), (3, 0, 4), (3, 5, 0)):
        B, n, m = shape
        out = _fill(np.zeros((B, n), np.int8), np.zeros((B, m), np.int8),
                    np.full(B, n, np.int32))
        for o, dt in zip(out, (np.int16, np.int8, np.int8)):
            assert o.shape == (B, n + 1, m + 1) and o.dtype == dt
            assert not o.any()


def test_multi_region_equals_per_region_and_jax():
    """One launch for many regions equals per-region fills (as
    tests/test_gassembler.py:301-320) and the JAX multi-region entry in
    interpret mode, with mixed reference and read lengths."""
    rng = np.random.default_rng(301)
    regions = []
    for (n, b, m) in ((37, 5, 29), (18, 3, 33), (52, 9, 12)):
        regions.append((rng.integers(0, 5, size=n).astype(np.int8),
                        rng.integers(0, 5, size=(b, m)).astype(np.int8)))
    multi = swalign_cuda.sw_matrices_batch_device_multi(regions, device="cpu")
    jax_pallas._lanes_cached.cache_clear()
    try:
        want = jax_pallas.sw_matrices_batch_device_multi(regions,
                                                         interpret=True)
    finally:
        jax_pallas._lanes_cached.cache_clear()
    for (ref, reads), got, w in zip(regions, multi, want):
        _assert_equal(got, w)
        _assert_equal(got, swalign_cuda.sw_matrices_batch_device(
            ref, reads, device="cpu"))
        _assert_equal(got, jax_sw.sw_matrices_batch(ref, reads))


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor never reaches a kernel wrapper, and the wrappers refuse
    one; bad dtypes and shapes are refused before any launch."""
    before = (trace.total("launch.sw_lanes"),
              trace.total("launch.sw_shared"))
    ref = np.arange(12, dtype=np.int8) % 4
    reads = np.tile(ref[:10], (3, 1))
    swalign_cuda.sw_matrices_batch_device(ref, reads, device="cpu")
    swalign_cuda.sw_pallas_matrices(ref, reads, device="cpu")
    assert (trace.total("launch.sw_lanes"),
            trace.total("launch.sw_shared")) == before
    refs_t = torch.zeros((3, 12), dtype=torch.int8)
    reads_t = torch.zeros((3, 10), dtype=torch.int8)
    nvec_t = torch.full((3,), 12, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        swalign_cuda.sw_fill_lanes_cuda(refs_t, reads_t, nvec_t)
    with pytest.raises(ValueError, match="CUDA"):
        swalign_cuda.sw_fill_shared_cuda(refs_t[0], reads_t)
    with pytest.raises(ValueError, match="int8"):
        sw_fill(refs_t.to(torch.int16), reads_t, nvec_t)
    with pytest.raises(ValueError, match="int32"):
        sw_fill(refs_t, reads_t, nvec_t.to(torch.int64))
    with pytest.raises(ValueError, match="batch sizes"):
        sw_fill(refs_t, reads_t[:2], nvec_t)


@pytest.mark.parametrize("value,enabled", [(None, True), ("1", True),
                                           ("0", False), ("yes", False)])
def test_device_sw_enabled(monkeypatch, value, enabled):
    """GT4_TPU_DEVICE_SW decides as in the JAX package; unset means on."""
    if value is None:
        monkeypatch.delenv("GT4_TPU_DEVICE_SW", raising=False)
    else:
        monkeypatch.setenv("GT4_TPU_DEVICE_SW", value)
    assert port_gas.device_sw_enabled() is enabled
