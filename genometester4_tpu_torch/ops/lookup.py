"""Batched dictionary lookup over sorted k-mer keys (port of
``genometester4_tpu/ops/lookup.py``).

The JAX package walks a branchless binary search of ``lookup_steps(n)``
gather steps over a sorted, padded ``(hi, lo)`` table whose first
``n_words`` entries are valid. Those are XLA programs, not Pallas kernels,
and a GPU has a 64-bit key and a library binary search, so the port is
``torch.searchsorted`` over the int64 keys of ``ops.encode`` (bit 63
flipped: signed order is the words' unsigned order). The table holds the
valid entries only, so no ``n_words`` and no step count are needed: the
search is exact at any size.
"""

from __future__ import annotations

import torch


def batched_lookup(table: torch.Tensor, codes: torch.Tensor,
                   queries: torch.Tensor):
    """Look queries up in a sorted table of unique keys.

    ``table`` int64[N] sorted keys, ``codes`` [N] their values (any
    dtype), ``queries`` int64[Q] keys. Returns (found bool[Q], the code of
    each found query and 0 elsewhere [Q], lower bound int64[Q]) — the
    contract of JAX's ``batched_lookup_pair``.
    """
    idx = torch.searchsorted(table, queries)
    n = table.numel()
    if n == 0:
        return (torch.zeros_like(queries, dtype=torch.bool),
                torch.zeros(queries.shape, dtype=codes.dtype,
                            device=queries.device), idx)
    at = idx.clamp(max=n - 1)
    found = (idx < n) & (table[at] == queries)
    return found, torch.where(found, codes[at], 0), idx


def batched_bounds(table: torch.Tensor, queries: torch.Tensor):
    """Lower and upper bound of each query in a sorted table that may hold
    duplicates: (first index >= q, first index > q), both int64[Q], so
    upper - lower is the number of occurrences of q — the contract of
    JAX's ``batched_bounds_pair``."""
    return (torch.searchsorted(table, queries),
            torch.searchsorted(table, queries, right=True))
