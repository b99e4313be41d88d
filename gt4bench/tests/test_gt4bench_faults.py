"""A run whose timed path is broken underneath comes out not correct,
for each fault a cell can have: a step that returns its state unchanged,
half of the batch left out, the exchange between cards left out, and an
answer altered where it is produced. The runs skip the look for a card
and drive the rest of a run on the CPU at a small size."""

import pytest
import torch

from gt4bench.tests import tiny


def _list_faults(where=None):
    from genometester4_tpu_torch.pipelines import listmaker as lm
    where = where or lm   # the module whose count_chunk the route calls
    count_chunk = where.count_chunk

    def half(codes, k, canonical=True):
        return count_chunk(codes[: codes.numel() // 2], k, canonical)

    def altered(codes, k, canonical=True):
        words, counts = count_chunk(codes, k, canonical)
        if len(counts):   # a mesh slot may get no chunk
            counts = counts.clone()
            counts[len(counts) // 2] += 1
        return words, counts

    def unmerged(shards, target_bucket=None, device=None):
        # the merge's state handed on as it came: shards neither summed
        # nor interleaved
        for w, c in shards:
            if len(w):
                yield w, c

    return {"half_batch": (where, "count_chunk", half),
            "altered_answer": (where, "count_chunk", altered),
            "state_unchanged": (lm, "merge_sorted_shards", unmerged)}


def _count_faults():
    from genometester4_tpu_torch.pipelines import gmercount as gc
    step = gc.count_step

    def unchanged(codes, k, db_keys, acc, zero_word):
        return torch.zeros((), dtype=torch.int64)

    def half(codes, k, db_keys, acc, zero_word):
        return step(codes[: codes.numel() // 2], k, db_keys, acc, zero_word)

    def altered(codes, k, db_keys, acc, zero_word):
        out = step(codes, k, db_keys, acc, zero_word)
        acc[acc.numel() // 3] += 1
        return out

    return {"state_unchanged": (gc, "count_step", unchanged),
            "half_batch": (gc, "count_step", half),
            "altered_answer": (gc, "count_step", altered)}


def _mesh_faults():
    from genometester4_tpu_torch.parallel import sharding
    merge = sharding.merge_gathered_sources

    def no_exchange(keys, counts, n, **kw):
        # each column keeps its own slot's bucket alone
        return merge(keys, counts, [n[0]] + [0] * (len(n) - 1), **kw)

    # one mesh step a job: the merge of steps never runs
    faults = _list_faults(sharding)
    del faults["state_unchanged"]
    return {**faults,
            "no_exchange": (sharding, "merge_gathered_sources",
                            no_exchange)}


FAULTS = {"glistmaker.chr22": _list_faults,
          "glistmaker.bacteria": lambda: {
              k: v for k, v in _list_faults().items()
              if k != "state_unchanged"},   # one chunk a job: no merge
          "glistmaker.chr22x4": _mesh_faults,
          "gmer_counter.wgs": _count_faults}
CASES = [(cell, fault) for cell, make in FAULTS.items() for fault in make()]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_comes_out_not_correct(cell, fault, monkeypatch):
    obj, attr, fn = FAULTS[cell]()[fault]
    monkeypatch.setattr(obj, attr, fn)
    r = tiny.run(cell, seconds=0.05)
    assert not r["correct"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())
    assert r["failed"] > 0
