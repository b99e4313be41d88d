"""The glistcompare cell at a small size on the CPU: a small copy of
``glistcompare.lane`` through ``run_cell``, planted faults that must come
out not correct, the control, the per-layer metrics of a traced run, and
a run that loads no JAX. (The reference against the port's CPU route is
``tests/test_torch_compare_reference.py``.)"""

import json
import os
import subprocess
import sys
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest

from gt4bench import control, manifest
from gt4bench.tests.tiny import GENOME

CELL = "glistcompare.lane"
# a 30 kb source and a ~200 kB lane (~650 reads): one bucket a compare
OVERRIDES = {
    "traffic": {"source": {"bases": 30000}, "genome": GENOME,
                "lane": {"bytes": 200000, "read_len": 150,
                         "substitution": 0.002, "rc_share": 0.5}}}
SEED = (1 << 31) + 12345
NEW = ["make_pct.cmp", "compare_pct.cmp", "compare_upload_pct.cmp",
       "compare_ops_pct.cmp", "compare_copyback_pct.cmp",
       "compare_write_pct.cmp"]
DEVICE = ["setops_roofline.cmp"]
# glistmaker's metrics that the cell reports too: those read on the host,
# and those that need a card
SHARED = ["parse_pct.list", "count_pct.list", "merge_pct.list",
          "host_wait_pct.list"]
SHARED_DEVICE = ["extract_roofline.list", "runenc_roofline.list",
                 "sort_roofline.list", "device_idle_pct.list",
                 "peak_device_GiB.list", "copyback_GBps.list"]


def tiny_run(trace=False, seconds=0.05, seed=SEED) -> dict:
    from gt4bench.run import run_cell
    return run_cell(manifest.cell(CELL), seed, seconds, trace, device="cpu",
                    overrides=OVERRIDES, log=lambda s: None)


def test_a_small_copy_comes_out_correct():
    r = tiny_run()
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"] == {"compare_outputs_wrong": {"value": 0,
                                                     "limit": 0}}
    assert r["metrics"]["list_Mbp_s"]["value"] > 0
    assert set(r["metrics"]) == {"list_Mbp_s", "setup_s"}


def _small_buckets(monkeypatch):
    from genometester4_tpu_torch.pipelines import listcompare as lc
    cuts = lc.bucket_cuts
    monkeypatch.setattr(lc, "bucket_cuts",
                        lambda w, target, n_min=1: cuts(w, 2048, n_min))
    return lc


def _bucket_left_out(monkeypatch):
    lc = _small_buckets(monkeypatch)
    run_parts = lc._run_parts

    def skipped(run, n, slots, host=None):
        assert n >= 4
        for p, out in enumerate(run_parts(run, n, slots, host)):
            if p != n // 2:
                yield out
    monkeypatch.setattr(lc, "_run_parts", skipped)


def _pair_op(change):
    def plant(monkeypatch):
        from genometester4_tpu_torch.ops import setops
        op_fn = setops.apply_pair_op

        def planted(*args, op, rule="default", **kw):
            return op_fn(*args, **change(op, rule), **kw)
        monkeypatch.setattr(setops, "apply_pair_op", planted)
    return plant


def _last_read_left_out(monkeypatch):
    from genometester4_tpu_torch.pipelines import listmaker
    slabs = listmaker.iter_code_slabs

    def cut(path, k, slab_bytes):
        got = list(slabs(path, k, slab_bytes))
        for i, (codes, meta) in enumerate(got):
            yield (codes[:-150] if i == len(got) - 1 else codes), meta
    monkeypatch.setattr(listmaker, "iter_code_slabs", cut)


FAULTS = {
    "bucket_left_out": _bucket_left_out,
    "intersection_under_max": _pair_op(lambda op, rule: {
        "op": op, "rule": "max" if op == "intrsec" else rule}),
    "double_difference_lists_swapped": _pair_op(lambda op, rule: {
        "op": "diff1" if op == "diff2" else op, "rule": rule}),
    "last_read_left_out": _last_read_left_out}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_comes_out_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    r = tiny_run()
    assert not r["correct"] and r["failed"] > 0
    assert r["checks"]["compare_outputs_wrong"]["value"] > 0


def test_small_buckets_alone_come_out_correct(monkeypatch):
    _small_buckets(monkeypatch)
    assert tiny_run()["correct"]


@pytest.mark.parametrize("seed", [1, (1 << 31) + 3])
def test_control_comes_out_wrong(seed):
    got = control.readings(manifest.cell(CELL), seed, 2, "cpu", OVERRIDES)
    assert got["compare_outputs_wrong"] == 4


class _Trace:
    """A device trace of one card: ``acts`` (start, end, name)."""

    def __init__(self, acts):
        self.by_device = {0: acts}

    def busiest(self):
        return 0

    def busy(self, dev):
        return sum(b - a for a, b, _ in self.by_device[dev])


def test_the_traced_run_reads_every_new_metric(monkeypatch):
    """Each new span metric reads a value in a traced run of the small
    copy, and the make and compare roots cover the window; the device
    metrics read a device trace (none on the CPU); nothing reads in an
    untraced run, with the recorder's rows dropped, or without the
    recorder."""
    from genometester4_tpu_torch import utils
    from genometester4_tpu_torch.utils import trace
    trace.reset()
    try:
        r = tiny_run(trace=True, seconds=0.5)
        assert r["correct"]
        got = r["metrics"]
        for name in NEW + SHARED:
            assert got[name]["value"] > 0, name
        # no card, no device activity
        assert not set(DEVICE + SHARED_DEVICE) & set(got)
        assert got["make_pct.cmp"]["value"] \
            + got["compare_pct.cmp"]["value"] > 90
        parts = sum(got[n]["value"] for n in NEW[2:6])
        assert parts <= got["compare_pct.cmp"]["value"]
        rows = trace.rows()
        roots = [x for x in rows if x.parent is None and x.name == "compare"]
        words = [sum((x.counts or {}).get(n, 0) for x in rows)
                 for n in ("compare.words_in", "compare.words_out")]
        assert roots and words[0] > 0 and words[1] > 0
        r0 = roots[0]
        half = (r0.t1 - r0.t0) / 2
        acts = [(r0.t0, r0.t0 + half, "sort_kernel"),
                (r0.t0 + half, r0.t1, "Memcpy DtoH (Device -> Pageable)"),
                (r0.t0 - 1.0, r0.t0, "extract_kernel")]   # outside
        run = SimpleNamespace(kind="list", t0=min(x.t0 for x in rows),
                              t1=max(x.t1 for x in rows), trace=_Trace(acts))
        run.window_s = run.t1 - run.t0
        roof = manifest.metric_reader("setops_roofline.cmp")
        assert roof(run) == pytest.approx(
            100.0 * 12 * sum(words) / 3.35e12 / half)
        idle = manifest.metric_reader("device_idle_pct.list")
        assert idle(run) == pytest.approx(
            100.0 * (1 - (2 * half + 1.0) / run.window_s))
        readers = [manifest.metric_reader(n) for n in NEW + DEVICE]
        assert all(read(run) is not None for read in readers)
        run.trace = None      # an untraced run
        assert all(read(run) is None for read in readers)
        run.trace = _Trace(acts)
        monkeypatch.setattr(trace, "dropped", 1)
        assert all(read(run) is None for read in readers)
        monkeypatch.setattr(trace, "dropped", 0)
        monkeypatch.delattr(utils, "trace")     # a program without it
        monkeypatch.setitem(sys.modules,
                            "genometester4_tpu_torch.utils.trace", None)
        assert all(read(run) is None for read in readers)
    finally:
        trace.reset()
    untraced = tiny_run()["metrics"]
    assert not set(NEW + DEVICE + SHARED + SHARED_DEVICE) & set(untraced)


def test_the_cell_is_listed_on_every_metric_it_reports():
    """Every new and shared per-layer metric lists the cell, and the cell
    reports no per-layer metric besides them."""
    listed = {m["name"] for m in manifest.metrics(CELL, True)
              if m["name"] not in ("list_Mbp_s", "setup_s")}
    assert listed == set(NEW + DEVICE + SHARED + SHARED_DEVICE)


def test_the_check_counts_the_list_steps_work(tmp_path):
    """``check`` gives the list step's rooflines their work: kernel A's
    windows (no window spans two reads) and the words of the sample's
    list, as the program's own ``.list`` of the lane holds them."""
    from genometester4_tpu_torch.formats.list_format import \
        read_list_header
    from gt4bench.run import Run
    cell = manifest.cell(CELL)
    drv = manifest.driver("glistcompare").Driver(
        cell.config, cell.traffic, SEED, "cpu", str(tmp_path), OVERRIDES)
    drv.setup()
    try:
        t0, t1, jobs = drv.window(0.01)
    finally:
        drv.release()
    run = Run(drv.kind, t0, t1, jobs, 0.0, {})
    checks, failed = drv.check(run)
    assert checks == {"compare_outputs_wrong": (0, 0)} and failed == 0
    n_reads, length = drv.sample.read_codes.shape
    words = read_list_header(tmp_path / "sample_25.list").n_words
    assert run.work["windows"] == len(jobs) * n_reads * (length - 24)
    assert run.work["unique"] == len(jobs) * words
    assert run.work["bases"] == len(jobs) * n_reads * length


def test_the_outputs_pin_the_sample_list():
    """The reference's union against a known genome list gives every count
    of the sample list back: the outputs judge glistmaker's step."""
    import torch

    from gt4bench.reference import setops as ref
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, (30, 150)).astype(np.uint8)
    gw = torch.unique(torch.from_numpy(
        rng.integers(0, 1 << 50, 5000)).to(torch.int64))
    gc = torch.from_numpy(rng.integers(1, 9, len(gw))).to(torch.int64)
    sw, sc = ref.reads_list(codes, 25, "cpu")
    union = ref.set_ops(sw, sc, gw, gc)["union"]
    at = torch.searchsorted(union[0], sw)
    _, g_of_s = ref._lookup(sw, gw, gc)
    assert torch.equal(union[1][at] - g_of_s, sc)


def test_a_dry_run_loads_neither_jax_nor_the_jax_package():
    from gt4bench.run import FORBIDDEN
    repo = manifest.BENCHMARK.parent
    code = ("import json\n"
            "from gt4bench.tests.test_gt4bench_glistcompare import tiny_run\n"
            "from gt4bench.run import forbidden_modules\n"
            "assert tiny_run()['correct']\n"
            "print(json.dumps(forbidden_modules()))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["TMPDIR"] = tempfile.gettempdir()
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert "jax" in FORBIDDEN

