"""Pairwise merge of sorted runs (port of
``genometester4_tpu/ops/bitonic_merge_pallas.py``: ``merge_sorted_runs``
and ``merge_round``).

The JAX package merges each pair of aligned sorted length-L runs of
``(k1, k2)`` u32 pairs with a bitonic network: big distances as XLA
passes, the rest in VMEM with the Pallas kernel ``make_block_merge``.
Here the keys are int64 (``ops.encode``: word ^ SIGN) and the merge is a
merge-path merge: kernel E (``ops.merge_runs_cuda``) on a CUDA tensor, or
its plain version ``merge_runs`` below on a CPU tensor. Both emit the
merged keys and, for every output slot, the position of its key in the
input; payloads are gathered with those positions, so any number follow.

Ties: a bitonic network leaves equal keys in an order of its own. Merge
path is stable, run A before run B, so the kernel and ``merge_runs`` (a
stable sort of each 2L span) agree bit for bit, positions included. Keys
equal the JAX package's bit for bit; payloads do wherever keys are
unique.
"""

from __future__ import annotations

import torch


def check_runs(keys: torch.Tensor, L: int) -> None:
    """Raise unless ``keys`` is a 1-D int64 tensor that splits into whole
    pairs of length-L runs, with int32 positions."""
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise ValueError(f"keys must be a 1-D int64 tensor, got {keys.dtype} "
                         f"of shape {tuple(keys.shape)}")
    n = keys.numel()
    if L < 1 or n % (2 * L):
        raise ValueError(f"n={n} is not a multiple of 2L={2 * L}")
    if n >= 1 << 31:
        raise ValueError(f"n={n} needs positions beyond int32")


def merge_runs(keys: torch.Tensor, L: int):
    """Plain PyTorch version of kernel E, on any device.

    keys int64[n], every aligned length-L run sorted, n % 2L == 0 ->
    (merged int64[n], pos int32[n]): each 2L span sorted ascending, stably
    (run A's keys before run B's equal ones), and ``merged = keys[pos]``.
    """
    check_runs(keys, L)
    n = keys.numel()
    merged, order = torch.sort(keys.reshape(-1, 2 * L), dim=1, stable=True)
    base = torch.arange(0, n, 2 * L, dtype=torch.int64, device=keys.device)
    pos = (order + base[:, None]).view(n).to(torch.int32)
    return merged.view(n), pos


def merge_sorted_runs(arrays, L: int):
    """One merge round: ``arrays`` = (keys, *payloads), each 1-D of length
    n, where every aligned length-L run of ``keys`` (int64) is sorted and
    n is a multiple of 2L. Returns the same tuple with every 2L span sorted
    and each payload element moved with its key.

    A CUDA tensor runs kernel E and a CPU tensor ``merge_runs``; a broken
    precondition raises.
    """
    keys, payloads = arrays[0], arrays[1:]
    check_runs(keys, L)
    if keys.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {keys.device}")
    runs = keys.reshape(-1, L)
    if not bool((runs[:, 1:] >= runs[:, :-1]).all()):
        raise ValueError(f"a length-{L} run of keys is not sorted")
    for p in payloads:
        if p.shape != keys.shape or p.device != keys.device:
            raise ValueError("payloads must match the keys' shape and device")
    if keys.is_cuda:
        from genometester4_tpu_torch.ops.merge_runs_cuda import merge_runs_cuda
        merged, pos = merge_runs_cuda(keys, L)
    else:
        merged, pos = merge_runs(keys, L)
    return (merged, *(p[pos] for p in payloads))


def merge_round(keys: torch.Tensor, L: int) -> torch.Tensor:
    """Keys-only merge round (JAX's ``merge_round`` on int64 keys)."""
    return merge_sorted_runs((keys,), L)[0]
