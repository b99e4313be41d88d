"""Kernels C and D: Smith-Waterman fill on the GPU (``csrc/swalign.cu``),
and the host entry points with the JAX package's contracts.

``sw_fill_lanes_cuda`` (kernel C) replaces
``genometester4_tpu/ops/swalign_pallas.py:make_sw_pallas_lanes`` and
``sw_fill_shared_cuda`` (kernel D) replaces ``make_sw_pallas``. Both only
launch: a tensor that is not on a CUDA device raises. Their plain PyTorch
version is ``ops.swalign.sw_fill``; the host entry points below take the
kernel for CUDA tensors and ``sw_fill`` for CPU tensors.

The host entry points keep the signatures of ``swalign_pallas.py``'s
(``sw_matrices_batch_device_multi``, ``sw_matrices_batch_device``,
``sw_pallas_matrices``) with an explicit ``device`` in place of
``interpret``, and return numpy (score int16, sx int8, sy int8) matrices
row-major, as ``ops/swalign.sw_matrices_batch`` does. Device results come
back in one pinned copy per output tensor, after one synchronize.
"""

from __future__ import annotations

import numpy as np
import torch

from genometester4_tpu_torch.ops import _build
from genometester4_tpu_torch.ops.swalign import PAD, check_fill_inputs, sw_fill
from genometester4_tpu_torch.utils import trace
from genometester4_tpu_torch.utils.device import resolve_device


def _outputs(B: int, n: int, m: int, device):
    shape = (B, n + 1, m + 1)
    return (torch.empty(shape, dtype=torch.int16, device=device),
            torch.empty(shape, dtype=torch.int8, device=device),
            torch.empty(shape, dtype=torch.int8, device=device))


def _scratch(lib, B: int, n: int, m: int, device):
    """The kernels' slab boundary in device memory, where the library asks
    for one (wide reads against a reference of more than 511 rows); None
    otherwise."""
    per_read = lib.gt4_sw_scratch(n, m)
    if not per_read:
        return None
    return torch.empty(B * per_read, dtype=torch.uint8, device=device)


def _check_cuda_contiguous(name: str, **tensors) -> None:
    for arg, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name} needs CUDA tensors, got {arg} on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")


def sw_fill_lanes_cuda(refs: torch.Tensor, reads: torch.Tensor,
                       nvec: torch.Tensor):
    """Kernel C: refs int8[B, n_cap], reads int8[B, m_cap], nvec int32[B]
    (CUDA, contiguous, any widths) -> (score int16, sx int8, sy int8)
    [B, n_cap+1, m_cap+1], as ``ops.swalign.sw_fill``."""
    check_fill_inputs(refs, reads, nvec)
    _check_cuda_contiguous("sw_fill_lanes_cuda", refs=refs, reads=reads,
                           nvec=nvec)
    B, n = refs.shape
    m = reads.shape[1]
    score, sx, sy = _outputs(B, n, m, refs.device)
    if B:
        lib = _build.load_library()
        scratch = _scratch(lib, B, n, m, refs.device)
        with torch.cuda.device(refs.device):
            err = lib.gt4_sw_lanes(
                refs.data_ptr(), reads.data_ptr(), nvec.data_ptr(),
                score.data_ptr(), sx.data_ptr(), sy.data_ptr(),
                None if scratch is None else scratch.data_ptr(), B, n, m,
                torch.cuda.current_stream().cuda_stream)
        _build.check_launch(lib, err, "sw lanes")
        trace.count("launch.sw_lanes")
    return score, sx, sy


def sw_fill_shared_cuda(ref: torch.Tensor, reads: torch.Tensor):
    """Kernel D: one reference int8[n] for all reads int8[B, m] (CUDA,
    contiguous, any widths) -> (score int16, sx int8, sy int8)
    [B, n+1, m+1], as ``ops.swalign.sw_fill`` with ``nvec = n``."""
    if ref.dtype != torch.int8 or ref.dim() != 1:
        raise ValueError(f"ref must be a 1-D int8 tensor, got {ref.dtype} "
                         f"of shape {tuple(ref.shape)}")
    if reads.dtype != torch.int8 or reads.dim() != 2:
        raise ValueError(f"reads must be a 2-D int8 tensor, got "
                         f"{reads.dtype} of shape {tuple(reads.shape)}")
    _check_cuda_contiguous("sw_fill_shared_cuda", ref=ref, reads=reads)
    if ref.device != reads.device:
        raise ValueError("ref and reads must be on one device")
    B, m = reads.shape
    n = ref.shape[0]
    score, sx, sy = _outputs(B, n, m, ref.device)
    if B:
        lib = _build.load_library()
        scratch = _scratch(lib, B, n, m, ref.device)
        with torch.cuda.device(ref.device):
            err = lib.gt4_sw_shared(
                ref.data_ptr(), reads.data_ptr(), score.data_ptr(),
                sx.data_ptr(), sy.data_ptr(),
                None if scratch is None else scratch.data_ptr(), B, n, m,
                torch.cuda.current_stream().cuda_stream)
        _build.check_launch(lib, err, "sw shared")
        trace.count("launch.sw_shared")
    return score, sx, sy


# ----------------------------------------------------------- host entries

def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _to_numpy(mats) -> list:
    """(score, sx, sy) tensors -> numpy; device tensors through pinned
    memory, one copy each, then one synchronize."""
    if not mats[0].is_cuda:
        return [t.numpy() for t in mats]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in mats]
    for h, t in zip(host, mats):
        h.copy_(t, non_blocking=True)
    with trace.span("sw_wait", wait=True):
        torch.cuda.current_stream(mats[0].device).synchronize()
    return [h.numpy() for h in host]


def sw_matrices_batch_device_multi(region_inputs, device=None):
    """Many regions' SW fills in one kernel C launch.

    ``region_inputs``: list of (ref int8[n_i], reads int8[B_i, m_i]).
    Returns per region (score int16[B_i, n_i+1, m_i+1], sx int8, sy int8)
    numpy arrays, equal to per-region fills: every lane carries its own
    reference and length. Caps are the window maxima rounded up to
    multiples of 8, as in ``swalign_pallas.py:390-391``. The arrays are
    views of the launch's one host copy, not copies of their own: copying
    every region's slice out faulted in fresh pages for each matrix, and
    on the H100 host that took longer than the fill itself.

    The span "sw" (its wait on the copy back "sw_wait"); the counters
    "sw.cells", the cells the fill writes (B x (n_cap + 1) x (m_cap + 1)),
    and "sw.in_bytes", the bytes of references, reads and lengths it
    reads (B x (n_cap + m_cap + 4)).
    """
    with trace.span("sw"):
        return _batch_multi(region_inputs, resolve_device(device))


def _batch_multi(region_inputs, dev):
    n_cap = _round_up(max(max(len(r) for r, _ in region_inputs), 8), 8)
    m_cap = _round_up(max(max(b.shape[1] for _, b in region_inputs), 8), 8)
    B = sum(b.shape[0] for _, b in region_inputs)
    refs = np.full((B, n_cap), PAD, np.int8)
    reads = np.full((B, m_cap), PAD, np.int8)
    nvec = np.empty(B, np.int32)
    off = 0
    for ref, batch in region_inputs:
        bi, mi = batch.shape
        refs[off:off + bi, :len(ref)] = ref
        reads[off:off + bi, :mi] = batch
        nvec[off:off + bi] = len(ref)
        off += bi
    refs_t, reads_t, nvec_t = (torch.from_numpy(a).to(dev)
                               for a in (refs, reads, nvec))
    fill = sw_fill_lanes_cuda if refs_t.is_cuda else sw_fill
    trace.count("sw.cells", B * (n_cap + 1) * (m_cap + 1))
    trace.count("sw.in_bytes", B * (n_cap + m_cap + 4))
    score, sx, sy = _to_numpy(fill(refs_t, reads_t, nvec_t))
    out = []
    off = 0
    for ref, batch in region_inputs:
        bi, mi = batch.shape
        n = len(ref)
        out.append(tuple(x[off:off + bi, :n + 1, :mi + 1]
                         for x in (score, sx, sy)))
        off += bi
    return out


def sw_matrices_batch_device(ref: np.ndarray, reads: np.ndarray,
                             device=None):
    """One region through kernel C: the contract of
    ``ops/swalign.sw_matrices_batch``."""
    return sw_matrices_batch_device_multi([(ref, reads)], device=device)[0]


def sw_pallas_matrices(ref: np.ndarray, reads: np.ndarray, device=None):
    """One reference, many reads, through kernel D: the contract of
    ``ops/swalign.sw_matrices_batch`` (no padding of n or m)."""
    dev = resolve_device(device)
    ref_t = torch.from_numpy(np.ascontiguousarray(ref, np.int8)).to(dev)
    reads_t = torch.from_numpy(np.ascontiguousarray(reads, np.int8)).to(dev)
    if ref_t.is_cuda:
        mats = sw_fill_shared_cuda(ref_t, reads_t)
    else:
        B = reads_t.shape[0]
        mats = sw_fill(ref_t.expand(B, -1), reads_t,
                       torch.full((B,), len(ref_t), dtype=torch.int32))
    return tuple(_to_numpy(mats))
