"""Sort + run counting (port of ``genometester4_tpu/ops/sortcount.py``,
``count_unique(compact=False)`` in both weight modes).

The JAX package sorts flag-packed ``(hi, lo)`` pairs with XLA's
``lax.sort`` and marks runs with element-wise neighbour compares. Here the
sort is ``torch.sort`` on int64 keys (``ops.encode``) and the marks come
from kernel B (``ops.runmarks_cuda``) on a CUDA tensor, or from its plain
version ``run_marks`` below on a CPU tensor.

``compact=True``, ``sort_compact`` and ``filter_counts`` are not ported
yet: the port's pipelines compact on the device with boolean indexing.
"""

from __future__ import annotations

import torch

from genometester4_tpu_torch.ops.encode import SIGN, flag_key

_U32 = 0xFFFFFFFF


def run_marks(keys: torch.Tensor, n_valid: int):
    """Plain PyTorch version of kernel B.

    Sorted keys int64[n] whose first ``n_valid`` are valid ->
    (head bool[n], tail bool[n], stats int32[3]) with

    * head[i]: i < n_valid and keys[i] differs from keys[i-1] (or i = 0);
    * tail[i]: i < n_valid and keys[i] differs from keys[i+1] (or i is the
      last valid slot);
    * stats = (n_unique = sum(head), total = n_valid,
      checksum = sum(tail * x * (i+1)) - sum(head * x * i) mod 2^32), with
      x = hi32(word) ^ lo32(word): the checksum of
      ``genometester4_tpu/ops/runmarks_pallas.py``; stored as the 32-bit
      pattern, like the kernel's.
    """
    n = keys.numel()
    if not 0 <= n_valid <= n:
        raise ValueError(f"n_valid={n_valid} outside 0..{n}")
    pos = torch.arange(n, dtype=torch.int64, device=keys.device)
    valid = pos < n_valid
    differs = keys[1:] != keys[:-1]
    true1 = torch.ones(min(n, 1), dtype=torch.bool, device=keys.device)
    head = valid & torch.cat([true1, differs])
    tail = valid & (torch.cat([differs, true1]) | (pos == n_valid - 1))
    word = keys ^ SIGN
    x = ((word >> 32) & _U32) ^ (word & _U32)
    # every product < 2^63 and is reduced before summing, so no int64 sum
    # can overflow below 2^31 elements
    up = ((x * (pos + 1)) & _U32).masked_fill(~tail, 0).sum()
    down = ((x * pos) & _U32).masked_fill(~head, 0).sum()
    stats = torch.stack([head.sum(), valid.sum(), (up - down) & _U32])
    return head, tail, stats.to(torch.int32)  # int64 -> int32 keeps the bits


def count_unique(keys: torch.Tensor, weights: torch.Tensor | None = None,
                 word_bits: int = 64):
    """Dedupe-and-count over unsorted keys, as a marked stream.

    ``keys`` int64[n]; a key whose word has a bit at or above ``word_bits``
    set is invalid (the flag of ``ops.kmers`` for k <= 31: pass 2k). With
    ``word_bits = 64`` every key is valid. ``weights`` int64[n] are the
    per-entry counts (``None``: every valid entry counts 1, the
    ``unit_weights`` mode).

    Returns (skeys, head, tail, incl, n_unique) like the JAX
    ``count_unique(compact=False)``: the sorted keys, bool masks on the
    first and last slot of every run of valid keys (the runs tile the
    stream from slot 0), the inclusive weight prefix mod 2^32 as int64
    (meaningful at tail slots; ``None`` with unit weights, where counts
    are differences of tail positions) and the number of runs.
    """
    if weights is None:
        skeys = torch.sort(keys).values
        sw = None
    else:
        skeys, order = torch.sort(keys)
        sw = weights[order]
    n_valid = (keys.numel() if word_bits >= 64
               else int(torch.searchsorted(skeys, flag_key(word_bits))))
    if skeys.is_cuda:
        from genometester4_tpu_torch.ops.runmarks_cuda import run_marks_cuda
        head, tail, stats = run_marks_cuda(skeys, n_valid)
    else:
        head, tail, stats = run_marks(skeys, n_valid)
    n_unique = int(stats[0])
    incl = None if sw is None else torch.cumsum(sw, 0) & _U32
    return skeys, head, tail, incl, n_unique
