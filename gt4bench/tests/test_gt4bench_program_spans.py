"""The metrics read from the program's own spans and counters
(``gt4bench/program_spans.py``): each reads a value in a traced CPU run of
every small cell it names and nothing untraced or without the program's
recorder; the padding share is the small sizes' own; the metrics that
read before still read."""

import shutil
import sys
import tempfile
from types import SimpleNamespace

import pytest

from gt4bench import manifest
from gt4bench.tests import tiny

B = manifest.benchmark()
NEW = [m for m in B["per_layer"] if m["source"] in ("program_span",
                                                     "program_counter")
       and m["name"].split(".")[0] not in
       ("parse_pct", "count_pct", "merge_pct", "write_pct",
        "peak_device_GiB")]
# the span metrics of the benchmark's own spans, which read on the CPU
OUTSIDE = ("parse_pct", "count_pct", "merge_pct", "write_pct")
# a share of the device trace's copy time: no copy time on the CPU
DEVICE_ONLY = {"copyback_GBps.list"}


def _cells(metric):
    return metric["workloads"]


@pytest.fixture(scope="module")
def traced():
    """One traced run of each small cell: (result, the recorder's rows)."""
    from genometester4_tpu_torch.utils import trace
    out = {}
    for name in tiny.OVERRIDES:
        trace.reset()
        r = tiny.run(name, trace=True, seconds=0.5)
        assert r["correct"], name
        out[name] = (r, trace.rows())
    return out


def test_the_new_metrics_are_the_ones_named():
    assert sorted(m["name"] for m in NEW) == sorted(
        [f"parse_{w}_pct.{s}" for w in ("read", "frame", "decode")
         for s in ("list", "count")]
        + ["host_wait_pct.list", "host_wait_pct.count",
           "merge_wait_pct.list", "pad_waste_pct.list",
           "pad_waste_pct.count", "copyback_GBps.list",
           "mesh_rerun_pct.list"])


@pytest.mark.parametrize("cell", sorted(tiny.OVERRIDES))
def test_every_new_metric_reads_in_its_cells(traced, cell):
    got = traced[cell][0]["metrics"]
    for m in NEW:
        if cell in _cells(m) and m["name"] not in DEVICE_ONLY:
            assert m["name"] in got, (cell, m["name"])
            assert got[m["name"]]["value"] >= 0
        elif cell not in _cells(m):
            assert m["name"] not in got
    for m in B["per_layer"]:
        if m["name"].split(".")[0] in OUTSIDE and cell in _cells(m):
            assert m["name"] in got, (cell, m["name"])


@pytest.mark.parametrize("cell", sorted(tiny.OVERRIDES))
def test_parse_parts_sum_to_the_outside_parse_span(traced, cell):
    got = {k: v["value"] for k, v in traced[cell][0]["metrics"].items()}
    split = "count" if cell.startswith("gmer") else "list"
    parts = sum(got[f"parse_{w}_pct.{split}"]
                for w in ("read", "frame", "decode"))
    # the benchmark's span around each next() holds the program's; at
    # these sizes a slab's parse is a few hundred microseconds, of which
    # the generator's steps and the spans themselves take tens
    outside = got[f"parse_pct.{split}"]
    assert 0.5 * outside < parts <= outside


def _expected_pad(cell):
    """Padding / codes sent of each input of the small cell, from the
    inputs the cell makes and the program's chunking rules."""
    from genometester4_tpu_torch.io.fasta import iter_code_slabs
    from genometester4_tpu_torch.pipelines.listmaker import pow2_cap
    c = manifest.cell(cell)
    over = tiny.OVERRIDES[cell]
    cfg = {**c.config, **over.get("config", {})}
    k, chunk = int(cfg["word_length"]), int(cfg["chunk_bases"])
    work = tempfile.mkdtemp()
    try:
        drv = manifest.driver(c.config["driver"]).Driver(
            c.config, c.traffic, tiny.SEED, "cpu", work, over)
        drv.make_inputs()
        paths = drv.paths if hasattr(drv, "paths") else [drv.lane]
        shares = set()
        for path in paths:
            slots = pad = 0
            for codes, _ in iter_code_slabs(path, k, int(cfg["slab_bytes"])):
                n = len(codes)
                if "mesh_devices" in over:   # one step of every slot
                    slots_n = len(over["mesh_devices"])
                    width = max(1 << 14, n // slots_n + k)
                    width = 1 << (width - 1).bit_length()
                    starts = range(0, max(n - (k - 1), 1), width - (k - 1))
                    assert len(starts) <= slots_n
                    slots += slots_n * width
                    pad += slots_n * width - sum(min(width, n - s)
                                                 for s in starts)
                    continue
                for s in range(0, max(n - (k - 1), 1), chunk - (k - 1)):
                    m = min(chunk, n - s)
                    slots += pow2_cap(m, chunk)
                    pad += pow2_cap(m, chunk) - m
            shares.add(100.0 * pad / slots)
        return shares
    finally:
        shutil.rmtree(work, ignore_errors=True)


@pytest.mark.parametrize("cell", sorted(tiny.OVERRIDES))
def test_pad_waste_is_the_small_sizes_padding(traced, cell):
    split = "count" if cell.startswith("gmer") else "list"
    got = traced[cell][0]["metrics"][f"pad_waste_pct.{split}"]["value"]
    (want,) = _expected_pad(cell)   # every input pads alike
    assert got == pytest.approx(want, rel=1e-12)


def _window_of(rows):
    return min(r.t0 for r in rows), max(r.t1 for r in rows)


class _Trace:
    """A device trace holding ``copy_s`` seconds of ``Memcpy DtoH``."""

    def __init__(self, copy_s):
        self.copy_s = copy_s

    def kernel_seconds(self, patterns):
        return self.copy_s if "memcpy dtoh" in patterns else 0.0


def _with_copies(rows, n=12_000):
    """``rows`` with ``n`` bytes copied back in each "copyback" span, as a
    card's copies count them (the CPU route copies nothing back and
    counts nothing)."""
    return [r._replace(counts={**(r.counts or {}), "copy.d2h_bytes": n})
            if r.name == "copyback" else r for r in rows]


def test_copyback_rate_is_the_counted_bytes_over_the_copy_time(traced):
    from genometester4_tpu_torch.utils import trace
    _, rows = traced["glistmaker.chr22"]
    assert not any("copy.d2h_bytes" in (r.counts or {}) for r in rows)
    rows = _with_copies(rows)
    t0, t1 = _window_of(rows)
    d2h = sum((r.counts or {}).get("copy.d2h_bytes", 0) for r in rows)
    assert d2h > 0
    trace.reset()
    trace._rows.extend(rows)
    try:
        run = SimpleNamespace(kind="list", t0=t0, t1=t1, window_s=t1 - t0,
                              trace=_Trace(0.5))
        read = manifest.metric_reader("copyback_GBps.list")
        assert read(run) == pytest.approx(d2h / 0.5 / 1e9)
        run.trace = _Trace(0.0)
        assert read(run) is None
    finally:
        trace.reset()


@pytest.mark.parametrize("metric", NEW, ids=lambda m: m["name"])
def test_nothing_untraced_dropped_or_without_the_recorder(traced, metric,
                                                          monkeypatch):
    from genometester4_tpu_torch.utils import trace
    cell = _cells(metric)[0]
    rows = _with_copies(traced[cell][1])
    t0, t1 = _window_of(rows)
    kind = "count" if cell.startswith("gmer") else "list"
    read = manifest.metric_reader(metric["name"])
    trace.reset()
    trace._rows.extend(rows)
    try:
        run = SimpleNamespace(kind=kind, t0=t0, t1=t1, window_s=t1 - t0,
                              trace=_Trace(1.0))
        assert read(run) is not None
        run.trace = None   # an untraced run
        assert read(run) is None
        run.trace = _Trace(1.0)
        monkeypatch.setattr(trace, "dropped", 1)
        assert read(run) is None
        monkeypatch.setattr(trace, "dropped", 0)
        # a program without the recorder
        from genometester4_tpu_torch import utils
        monkeypatch.delattr(utils, "trace")
        monkeypatch.setitem(sys.modules,
                            "genometester4_tpu_torch.utils.trace", None)
        assert read(run) is None
    finally:
        trace.reset()
