"""Set operations over sorted k-mer lists (port of
``genometester4_tpu/ops/setops.py``) on int64 keys (``ops.encode``), on any
device.

The reference walks two (or N) sorted lists with a cursor zipper
(src/glistcompare.c:843-905, :500-717) deciding per word via
``include_in_union/intersection/complement`` (src/glistcompare.c:433-489).
Here the lists' valid entries are concatenated and sorted once
(``torch.sort``); run heads come from a shifted compare, per-run sums
from ``index_add_`` over the run ids, per-run minima and maxima from
``scatter_reduce``, and every output is a mask and an order-preserving
``nonzero`` compaction (``sort_compact``). The JAX package keys a padded
sort on ``(invalid, hi, lo, count[, source])`` and compacts with a second
sort, because a TPU serializes scatters; a GPU has atomics and scans.
The JAX package runs these outside any Pallas kernel, so the port's are
plain PyTorch too.

Counts are int64 tensors holding u32 values. Rule semantics are JAX's
exactly:

* 2-list union: excluded only if BOTH freqs are below cutoff;
* 2-list intersection: both freqs must reach cutoff; default rule MIN;
* difference: freq1 >= cutoff and freq2 < cutoff, default rule SUBTRACT;
* ``-du`` subtract quirk: keep only words with freq1 == freq2 >= cutoff
  (src/glistcompare.c:477-482);
* N-list union/intersect apply the cutoff to the COMBINED frequency
  (src/glistcompare.c:575,686) — different from the 2-list path;
* a rule freq of 0 suppresses the word (``*freq != 0`` checks);
* ADD and the per-run sums wrap as C unsigned ints (summed in int64,
  then ``& 0xFFFFFFFF``).
"""

from __future__ import annotations

import torch

from genometester4_tpu_torch.ops.sortcount import sort_compact
from genometester4_tpu_torch.utils import trace

RULE_DEFAULT = "default"
RULE_ADD = "add"
RULE_SUBTRACT = "subtract"
RULE_MIN = "min"
RULE_MAX = "max"
RULE_FIRST = "first"
RULE_SECOND = "second"
RULE_NUMBER = "number"

_U32 = 0xFFFFFFFF


def _runs(keys: torch.Tensor):
    """Sorted keys -> (the first slot of every run bool [n], each slot's
    run id int64 [n], the number of runs). Reading the number back is the
    span "sync"."""
    head = torch.ones_like(keys, dtype=torch.bool)
    head[1:] = keys[1:] != keys[:-1]
    run = torch.cumsum(head, 0) - 1
    if not keys.numel():
        return head, run, 0
    with trace.span("sync", wait=True):
        return head, run, int(run[-1]) + 1


def _compact(inc, keys, counts):
    """``sort_compact``, whose host read of the kept count is the span
    "sync": (kept keys, their counts)."""
    with trace.span("sync", wait=True):
        _, keys, counts = sort_compact(inc, keys, counts)
    return keys, counts


def pair_align(keys1: torch.Tensor, c1: torch.Tensor, keys2: torch.Tensor,
               c2: torch.Tensor):
    """Align two sorted unique lists into one unique word table.

    Returns (ukeys, f1, f2): every key present in either list, ascending,
    with its count in list 1 and in list 2 (0 where absent)."""
    keys = torch.cat([keys1, keys2])
    skeys, order = torch.sort(keys)
    head, run, n_u = _runs(skeys)
    from1 = order < keys1.numel()
    sc = torch.cat([c1, c2])[order]
    zero = torch.zeros(n_u, dtype=torch.int64, device=keys.device)
    # each list is unique: a run holds at most one entry of each
    f1 = zero.index_add(0, run, torch.where(from1, sc, 0))
    f2 = zero.index_add(0, run, torch.where(from1, 0, sc))
    return skeys[head], f1, f2


def _rule_freq(f1, f2, rule: str, count_override: int):
    """calculate_freq (src/glistcompare.c:433-455)."""
    if rule == RULE_ADD:
        return (f1 + f2) & _U32
    if rule == RULE_SUBTRACT:
        return torch.where(f1 > f2, f1 - f2, 0)
    if rule == RULE_MIN:
        return torch.minimum(f1, f2)
    if rule == RULE_MAX:
        return torch.maximum(f1, f2)
    if rule == RULE_FIRST:
        return f1
    if rule == RULE_SECOND:
        return f2
    if rule == RULE_NUMBER:
        return torch.full_like(f1, count_override & _U32)
    raise ValueError(f"invalid rule {rule}")


def apply_pair_op(ukeys, f1, f2, op: str, rule: str = RULE_DEFAULT,
                  cutoff: int = 1, count_override: int = 1,
                  subtract: bool = False):
    """One set-operation output from an aligned pair table.

    op is one of union, intrsec, diff1, diff2. Returns (keys, counts) of
    the kept words, ascending."""
    ge1, ge2 = f1 >= cutoff, f2 >= cutoff
    present1, present2 = f1 > 0, f2 > 0
    if op == "union":
        r = RULE_ADD if rule == RULE_DEFAULT else rule
        freq = _rule_freq(f1, f2, r, count_override)
        inc = (ge1 | ge2) & (freq != 0)
    elif op == "intrsec":
        r = RULE_MIN if rule == RULE_DEFAULT else rule
        freq = _rule_freq(f1, f2, r, count_override)
        # the zipper evaluates intersection only for words in BOTH lists
        inc = present1 & present2 & ge1 & ge2 & (freq != 0)
    elif op == "diff1":
        if subtract:
            freq = f1
            inc = present1 & present2 & (f1 == f2) & ge1
        else:
            r = RULE_SUBTRACT if rule == RULE_DEFAULT else rule
            freq = _rule_freq(f1, f2, r, count_override)
            inc = present1 & ge1 & ~ge2 & (freq != 0)
    elif op == "diff2":
        # ddiff swaps roles and never applies subtract
        # (src/glistcompare.c:866)
        r = RULE_SUBTRACT if rule == RULE_DEFAULT else rule
        freq = _rule_freq(f2, f1, r, count_override)
        inc = present2 & ge2 & ~ge1 & (freq != 0)
    else:
        raise ValueError(f"unknown op {op}")
    return _compact(inc, ukeys, freq)


def apply_multi_op(keys: torch.Tensor, counts: torch.Tensor, n_lists: int,
                   op: str, rule: str = RULE_DEFAULT, cutoff: int = 1,
                   count_override: int = 1):
    """N-list union/intersection (src/glistcompare.c:500-717) over the
    concatenation of N sorted unique lists' keys and counts.

    The cutoff applies to the combined frequency; intersection requires
    presence in all N lists. Returns (keys, counts), ascending."""
    skeys, order = torch.sort(keys)
    sc = counts[order]
    head, run, n_u = _runs(skeys)
    if op == "union":
        r = RULE_ADD if rule == RULE_DEFAULT else rule
    else:
        r = RULE_MIN if rule == RULE_DEFAULT else rule
    empty = torch.zeros(n_u, dtype=torch.int64, device=keys.device)
    if r == RULE_ADD:
        freq = empty.index_add(0, run, sc) & _U32
    elif r in (RULE_MIN, RULE_MAX):
        freq = empty.scatter_reduce(0, run, sc, "amin" if r == RULE_MIN
                                    else "amax", include_self=False)
    elif r == RULE_NUMBER:
        freq = torch.full_like(empty, count_override & _U32)
    else:
        raise ValueError(f"rule {r} not valid for multi-list {op}")
    inc = freq >= cutoff
    if op == "intrsec":
        n_src = empty.index_add(0, run, torch.ones_like(run))
        inc &= n_src == n_lists
    return _compact(inc, skeys[head], freq)
