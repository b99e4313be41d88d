"""Sort + run counting (port of ``genometester4_tpu/ops/sortcount.py``:
``count_unique(compact=True)`` in both weight modes, and ``sort_compact``).

The JAX package sorts flag-packed ``(hi, lo)`` pairs with XLA's
``lax.sort``, marks runs with element-wise neighbour compares and compacts
them with a second sort. Here the sort is ``torch.sort`` on int64 keys
(``ops.encode``), and one pass turns the sorted keys into the unique keys
and their counts: kernel B (``ops.runmarks_cuda.run_encode_cuda``, one
host sync) on a CUDA tensor, its plain version ``run_encode`` below on a
CPU tensor. ``run_marks`` keeps the marks of the TPU kernel, from which
``run_encode`` is defined.

``sort_compact`` (gmer_counter's index mode, glistcompare) is an
order-preserving ``torch.nonzero`` compaction. ``filter_counts`` is not
ported: the port's pipelines cut counts on the host.
"""

from __future__ import annotations

import torch

from genometester4_tpu_torch.ops.encode import SIGN, flag_key
from genometester4_tpu_torch.utils import trace

_U32 = 0xFFFFFFFF
# kernel B's largest stream (JAX's int32 positions)
MAX_RUN_KEYS = (1 << 31) - 1


def sort_compact(mask: torch.Tensor, *arrays: torch.Tensor):
    """Stream compaction: the entries where ``mask`` is set, in order.

    Returns (n_kept, each array's kept entries): the first ``n_kept``
    slots of JAX's ``sort_compact`` (a sort keyed on (not kept, position),
    scatter-free for the TPU), without its tail of non-kept entries. The
    count is read back to the host (one synchronization)."""
    idx = torch.nonzero(mask).flatten()
    return (idx.numel(), *(a[idx] for a in arrays))


def run_marks(keys: torch.Tensor, n_valid: int):
    """The run marks of the TPU kernel (``runmarks_pallas.py``), which
    ``run_encode`` compacts.

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


def run_encode(keys: torch.Tensor, weights: torch.Tensor | None = None,
               word_bits: int = 64):
    """Plain PyTorch version of kernel B: sorted keys int64[n], optional
    weights int64[n] -> (unique keys int64[n_unique], counts
    int64[n_unique], n_unique, total, checksum).

    A key at or above ``flag_key(word_bits)`` is invalid (none with
    ``word_bits = 64``); the invalid keys of a sorted stream are its tail.
    The runs are those of ``run_marks`` over the valid prefix: each run's
    key in order, its count the summed weight mod 2^32 (its length without
    weights), and ``run_marks``' stats as ints, the checksum in
    [0, 2^32).
    """
    n = keys.numel()
    if n > MAX_RUN_KEYS:
        raise ValueError(f"run_encode takes at most {MAX_RUN_KEYS} keys, "
                         f"got {n}")
    n_valid = (n if word_bits >= 64
               else int(torch.searchsorted(keys, flag_key(word_bits))))
    _, tail, stats = run_marks(keys, n_valid)
    tails = torch.nonzero(tail).flatten()
    # the runs tile the valid prefix: a count is the difference of the
    # inclusive prefix (of positions, or of weights) at consecutive tails
    ends = tails + 1 if weights is None else torch.cumsum(weights, 0)[tails]
    counts = torch.diff(ends, prepend=ends.new_zeros(1)) & _U32
    with trace.span("sync", wait=True):
        n_unique, total, checksum = stats.tolist()
    return keys[tails], counts, n_unique, total, checksum & _U32


def count_unique(keys: torch.Tensor, weights: torch.Tensor | None = None,
                 word_bits: int = 64):
    """Dedupe-and-count over unsorted keys: JAX's
    ``count_unique(compact=True)``.

    ``keys`` int64[n]; a key whose word has a bit at or above ``word_bits``
    set is invalid (the flag of ``ops.kmers`` for k <= 31: pass 2k). With
    ``word_bits = 64`` every key is valid. ``weights`` int64[n] are the
    per-entry counts (``None``: every valid entry counts 1, the
    ``unit_weights`` mode).

    Returns (unique keys int64[n_unique] ascending, their counts
    int64[n_unique] mod 2^32, n_unique): JAX's leading ``n_unique`` slots
    of (uhi, ulo) and counts. On a CUDA tensor kernel B runs after the
    sort, and reading n_unique is the only host sync.
    """
    if weights is None:
        skeys = torch.sort(keys).values
        sw = None
    else:
        skeys, order = torch.sort(keys)
        sw = weights[order]
    if skeys.is_cuda:
        from genometester4_tpu_torch.ops.runmarks_cuda import \
            run_encode_cuda as encode
    else:
        encode = run_encode
    ukeys, counts, n_unique, _, _ = encode(skeys, sw, word_bits)
    return ukeys, counts, n_unique
