"""Kernel B wrapper: one-pass run encoding on the GPU (``csrc/runmarks.cu``).

Replaces ``genometester4_tpu/ops/runmarks_pallas.py:make_run_marks`` and
the compaction after it: sorted keys in, their unique keys and counts out
(JAX's ``count_unique(compact=True)`` on a sorted stream), with one host
sync for the number of runs. Its plain PyTorch version, with the same
contract, is ``ops.sortcount.run_encode``; ``ops.sortcount.count_unique``
picks between the two by the tensor's device. This wrapper only launches:
a tensor that is not on a CUDA device raises.
"""

from __future__ import annotations

import torch

from genometester4_tpu_torch.ops import _build
from genometester4_tpu_torch.ops.encode import flag_key
from genometester4_tpu_torch.ops.sortcount import MAX_RUN_KEYS, _U32
from genometester4_tpu_torch.utils import trace


def _check(name: str, x: torch.Tensor, n: int | None = None) -> None:
    if not x.is_cuda:
        raise ValueError(f"run_encode_cuda needs a CUDA tensor, got "
                         f"{x.device} for {name}")
    if x.dtype != torch.int64 or x.dim() != 1:
        raise ValueError(f"{name} must be a 1-D int64 tensor, got "
                         f"{x.dtype} of shape {tuple(x.shape)}")
    if n is not None and x.numel() != n:
        raise ValueError(f"{name} must have the keys' shape ({n},), got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def run_encode_cuda(keys: torch.Tensor, weights: torch.Tensor | None = None,
                    word_bits: int = 64):
    """Sorted keys int64[n] (CUDA, contiguous), optional weights int64[n]
    -> (unique keys int64[n_unique], counts int64[n_unique], n_unique,
    total, checksum), as ``ops.sortcount.run_encode``.

    A key at or above ``flag_key(word_bits)`` is invalid (none with
    ``word_bits = 64``); counts are the runs' weight sums mod 2^32, or
    their lengths without weights. The three ints come back in one
    device-to-host copy, the call's only sync. n must stay below 2^31.
    """
    _check("keys", keys)
    n = keys.numel()
    if weights is not None:
        _check("weights", weights, n)
        if weights.device != keys.device:
            raise ValueError(f"weights on {weights.device}, keys on "
                             f"{keys.device}")
    if n > MAX_RUN_KEYS:
        raise ValueError(f"run_encode_cuda takes at most {MAX_RUN_KEYS} "
                         f"keys, got {n}")
    if not 0 <= word_bits <= 64:
        raise ValueError(f"word_bits={word_bits} outside 0..64")
    if n == 0:
        return keys.new_empty(0), keys.new_empty(0), 0, 0, 0
    lib = _build.load_library()
    # one buffer, to keep host work before the launch short: the run keys,
    # their counts, 16 bytes of stats and the tile counter, a status word
    # a tile (the launcher zeroes the last two)
    out = torch.empty(2 * n + 2 + -(-n // lib.gt4_run_encode_tile()),
                      dtype=torch.int64, device=keys.device)
    err = lib.gt4_run_encode(
        keys.data_ptr(), None if weights is None else weights.data_ptr(),
        out.data_ptr(), n, flag_key(word_bits) if word_bits < 64 else 0,
        int(word_bits < 64), keys.device.index,
        torch.cuda.current_stream(keys.device).cuda_stream)
    _build.check_launch(lib, err, "run encode")
    trace.count("launch.run_encode")
    with trace.span("sync", wait=True):
        n_unique, total, checksum = (
            out[2 * n:2 * n + 2].view(torch.int32)[:3].tolist())
    return (out[:n_unique], out[n:n + n_unique], n_unique, total,
            checksum & _U32)
