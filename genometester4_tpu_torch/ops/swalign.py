"""Affine-gap Smith-Waterman (port of ``genometester4_tpu/ops/swalign.py``).

``sw_fill`` is the plain PyTorch version of the fill that kernels C and D
compute (``ops/swalign_cuda.py``, ``csrc/swalign.cu``). It is what a CPU
tensor runs, and what the kernels are held against bit for bit.
``sw_matrices_batch`` and ``sw_traceback`` are the host fill and traceback
of the native library (``utils.native``), which gassembler's host route
and its ``-DDD`` trace use, as in the JAX package.

Contract (the JAX package's, ``ops/swalign.py`` and
``ops/swalign_pallas.py``): reads are aligned to references over the
nucleotide codes A C G T N GAP NONE = 0..6. Match +2, mismatch -3, a code
>= N on either side 0, gap open -4, gap extend -2. Cell (i, j) takes

    cell = diag + sub if diag + sub > 0, else 0          (sx = sy = -1 / 0)
    left gap: max(cell - 4, left[i, j-1] - 2), length wraps as int8;
              taken if >= cell                           (sx = -len, sy = 0)
    top gap:  max(cell - 4, top[i-1, j] - 2) on the UPDATED cell;
              taken if >= cell                           (sx = 0, sy = -len)

Row 0 and column 0 are 0, and so is every cell past a lane's reference
length ``nvec[b]``; the gap states of such cells are NEG and 0. Padded read
columns (code NONE) are computed like any other, as the kernels do.

torch is imported by the functions that use it, as the JAX package imports
jax inside ``make_sw_jax``: the gassembler CLI imports this module for its
host traceback and imports no torch before it builds an ``Assembler``.
"""

from __future__ import annotations

import numpy as np

M_SCORE = 2
N_SCORE = 0
MM_SCORE = -3
GAP_OPEN = -4
GAP_EXT = -2
NEG = -1000

NUCL_N = 4  # matrix.h nucleotide codes: A C G T N GAP NONE
PAD = NUCL_N + 2   # NONE: padding code of references and reads


def sw_matrices_batch(ref: np.ndarray, reads: np.ndarray):
    """One reference int8[n] against reads int8[B, m] (padded with NONE)
    through the native fill (``fgx_sw_batch``) -> (score int16, sx int8,
    sy int8), each [B, n+1, m+1]."""
    from genometester4_tpu_torch.utils.native import get_lib
    lib = get_lib()
    B, m = reads.shape
    n = len(ref)
    score = np.zeros((B, n + 1, m + 1), np.int16)
    sx = np.zeros((B, n + 1, m + 1), np.int8)
    sy = np.zeros((B, n + 1, m + 1), np.int8)
    if B and n and m:
        tg_s = np.empty(m + 1, np.int16)
        tg_l = np.empty(m + 1, np.int8)
        lib.fgx_sw_batch(np.ascontiguousarray(ref, np.int8), n,
                         np.ascontiguousarray(reads, np.int8), B, m,
                         score, sx, sy, tg_s, tg_l)
    return score, sx, sy


def sw_traceback(score: np.ndarray, sx: np.ndarray, sy: np.ndarray,
                 m_valid: int):
    """Traceback of one read's matrices (reference
    src/gassembler.c:2298-2320) through the native ``fgx_sw_traceback``:
    the first maximum in row-major order over the first ``m_valid`` read
    columns, then back along sx/sy. Returns the aligned (a_pos, b_pos)
    int32 pairs in ascending order."""
    from genometester4_tpu_torch.utils.native import get_lib
    lib = get_lib()
    n1, m1 = score.shape
    cap = n1 + m1
    a_pos = np.empty(cap, np.int32)
    b_pos = np.empty(cap, np.int32)
    cnt = lib.fgx_sw_traceback(
        np.ascontiguousarray(score, np.int16),
        np.ascontiguousarray(sx, np.int8),
        np.ascontiguousarray(sy, np.int8), n1, m1, m_valid, a_pos, b_pos)
    return a_pos[:cnt], b_pos[:cnt]


def _wrap8(x):
    """int32 -> the value an int8 store keeps (C wrap)."""
    return ((x + 128) & 255) - 128


def check_fill_inputs(refs: torch.Tensor, reads: torch.Tensor,
                      nvec: torch.Tensor) -> None:
    import torch
    if refs.dtype != torch.int8 or refs.dim() != 2:
        raise ValueError(f"refs must be a 2-D int8 tensor, got {refs.dtype} "
                         f"of shape {tuple(refs.shape)}")
    if reads.dtype != torch.int8 or reads.dim() != 2:
        raise ValueError(f"reads must be a 2-D int8 tensor, got "
                         f"{reads.dtype} of shape {tuple(reads.shape)}")
    if nvec.dtype != torch.int32 or nvec.dim() != 1:
        raise ValueError(f"nvec must be a 1-D int32 tensor, got "
                         f"{nvec.dtype} of shape {tuple(nvec.shape)}")
    if not refs.shape[0] == reads.shape[0] == nvec.shape[0]:
        raise ValueError(f"batch sizes differ: refs {refs.shape[0]}, reads "
                         f"{reads.shape[0]}, nvec {nvec.shape[0]}")
    if not refs.device == reads.device == nvec.device:
        raise ValueError("refs, reads and nvec must be on one device")


def sw_fill(refs: torch.Tensor, reads: torch.Tensor, nvec: torch.Tensor):
    """refs int8[B, n_cap], reads int8[B, m_cap], nvec int32[B] ->
    (score int16, sx int8, sy int8), each [B, n_cap+1, m_cap+1] row-major.

    Lane b aligns ``reads[b]`` to ``refs[b, :nvec[b]]`` (rows past
    ``min(nvec[b], n_cap)`` stay 0). Anti-diagonal sweep over (B, m_cap+1)
    tensors in int16, like ``make_sw_jax``, then one gather from the
    diagonal stack to row-major; runs on any device.
    """
    import torch
    check_fill_inputs(refs, reads, nvec)
    B, n = refs.shape
    m = reads.shape[1]
    dev = refs.device
    t = torch.int16
    score = torch.zeros((B, n + 1, m + 1), dtype=t, device=dev)
    sx = torch.zeros((B, n + 1, m + 1), dtype=torch.int8, device=dev)
    sy = torch.zeros((B, n + 1, m + 1), dtype=torch.int8, device=dev)
    if B == 0 or n == 0 or m == 0:
        return score, sx, sy
    js = torch.arange(m + 1, device=dev)
    # read base of column j is reads[j-1]; column 0 is never valid
    b_n = torch.cat([torch.full((B, 1), PAD, dtype=t, device=dev),
                     reads.to(t)], dim=1)
    b_bad = b_n >= NUCL_N
    # reference base of cell (d - j, j) for j = 0..m is a plain slice of
    # the reversed reference padded by m + 1 on both sides:
    # rev[:, n + 2m + 1 - k] = ref[:, k - m - 1]
    pad = torch.full((B, m + 1), PAD, dtype=t, device=dev)
    rev = torch.cat([pad, refs.to(t), pad], dim=1).flip(1)
    rev_bad = rev >= NUCL_N
    lim = nvec.to(torch.int64).clamp(max=n)[:, None]
    # diagonal d's cells at [d - 2], converted to row-major at the end
    stack = [torch.empty((n + m - 1, B, m + 1), dtype=dt, device=dev)
             for dt in (t, torch.int8, torch.int8)]
    # states of diagonal d in [d % 3] (score) and [d % 2] (left gap), with
    # column j at index j + 1 and a border column (j = -1) at index 0
    h = [torch.zeros((B, m + 2), dtype=t, device=dev) for _ in range(3)]
    lg_s = [torch.full((B, m + 2), NEG, dtype=t, device=dev)
            for _ in range(2)]
    lg_l = [torch.zeros((B, m + 2), dtype=t, device=dev) for _ in range(2)]
    neg = torch.full((B, m + 1), NEG, dtype=t, device=dev)
    tg_s = neg
    tg_l = torch.zeros((B, m + 1), dtype=t, device=dev)
    for d in range(2, n + m + 1):
        iis = d - js
        valid = (js >= 1) & (iis >= 1) & (iis <= lim)          # (B, m+1)
        keep = valid.to(t)
        r0 = n + m + 1 - d
        a_n = rev[:, r0:r0 + m + 1]
        sub = (a_n == b_n).to(t) * (M_SCORE - MM_SCORE) + MM_SCORE
        sub = torch.where(rev_bad[:, r0:r0 + m + 1] | b_bad, N_SCORE, sub)
        # (i-1, j-1) on diagonal d-2 and (i, j-1) on d-1: column j-1
        dsc = h[(d - 2) % 3][:, :-1] + sub
        cell = dsc.clamp_min(0)
        csx = csy = -(dsc > 0).to(t)
        ext_s = lg_s[(d - 1) % 2][:, :-1] + GAP_EXT
        ls = torch.maximum(ext_s, cell + GAP_OPEN)
        ll = _wrap8(lg_l[(d - 1) % 2][:, :-1] + 1) * (ext_s > cell + GAP_OPEN)
        sel = ls >= cell
        cell = torch.maximum(ls, cell)
        csx = torch.where(sel, _wrap8(-ll), csx)
        csy = csy.masked_fill(sel, 0)
        # (i-1, j) on diagonal d-1: the same column
        ext_s = tg_s + GAP_EXT
        ts = torch.maximum(ext_s, cell + GAP_OPEN)
        tl = _wrap8(tg_l + 1) * (ext_s > cell + GAP_OPEN)
        sel = ts >= cell
        cell = torch.maximum(ts, cell)
        csx = csx.masked_fill(sel, 0)
        csy = torch.where(sel, _wrap8(-tl), csy)

        cell *= keep
        stack[0][d - 2] = cell
        stack[1][d - 2] = csx * keep
        stack[2][d - 2] = csy * keep
        h[d % 3][:, 1:] = cell
        lg_s[d % 2][:, 1:] = torch.where(valid, ls, neg)
        lg_l[d % 2][:, 1:] = ll * keep
        tg_s = torch.where(valid, ts, neg)
        tg_l = tl * keep
    # cell (i, j) sits on diagonal i + j, column j
    ii = torch.arange(1, n + 1, device=dev)[:, None]
    jj = torch.arange(1, m + 1, device=dev)[None, :]
    for out, st in zip((score, sx, sy), stack):
        out[:, 1:, 1:] = st[ii + jj - 2, :, jj].permute(2, 0, 1)
    return score, sx, sy
