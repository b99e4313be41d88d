"""The KATK cell at a small size on the CPU: the plain reference against
the port's CPU route (the read index of ``gmer_counter --compile_index``,
the fill ``ops.swalign.sw_fill``, a gap-length wrap among its lanes),
a small copy of ``katk.wgs30x`` through ``run_cell``, planted faults that
must come out not correct, the control, the per-layer metrics of a traced
run, and a run that loads no JAX."""

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gt4bench import control, manifest
from gt4bench.gen.katk import make_sample
from gt4bench.reference import katk as ref
from gt4bench.tests.tiny import GENOME

CELL = "katk.wgs30x"
# 20 regions over a 20 kb stretch; every launch tapped, as a small job
# makes a few. The calls' limit is the small copy's own reading at SEED
# (four planted variants within 50 bases of a region's end called wrong,
# as at the full size): one call flipped passes it
OVERRIDES = {
    "traffic": {"source": {"bases": 20000, "scale_from_bp": 50818468},
                "genome": GENOME,
                "regions": {"count": 20, "region_bp": 200, "spacing": 1000,
                            "first": 400, "anchor_step": 30,
                            "anchor_offset": 5}},
    "config": {"tap_every": 1,
               "limits": {"index_entries_wrong": 0, "sw_lanes_wrong": 0,
                          "calls_wrong": 4}}}
SEED = (1 << 31) + 12345
NEW = ["index_pct.katk", "gather_pct.katk", "align_pct.katk",
       "group_call_pct.katk", "host_wait_pct.katk"]


def tiny_run(trace=False, seconds=0.05, seed=SEED) -> dict:
    from gt4bench.run import run_cell
    return run_cell(manifest.cell(CELL), seed, seconds, trace, device="cpu",
                    overrides=OVERRIDES, log=lambda s: None)


def _traffic():
    t = manifest.cell(CELL).traffic
    return {**t, **OVERRIDES["traffic"]}


@pytest.mark.parametrize("seed", [3, (1 << 31) + 11])
def test_reference_index_is_the_ports(tmp_path, seed):
    from genometester4_tpu_torch.cli import gmer_counter
    s = make_sample(seed, _traffic(), str(tmp_path))
    idx = str(tmp_path / "s.idx")
    with contextlib.redirect_stdout(io.StringIO()):
        assert gmer_counter.main(["-db", s.db_txt, "--compile_index", idx,
                                  s.reads_fq], device="cpu") == 0
    got = ref.gt4i_keys(idx, s.record_bytes, len(s.read_codes))
    want = ref.read_index(s.read_codes, s.db_words, 25, "cpu",
                          block_rows=1000)
    assert len(want) > 1000 and ref.entries_wrong(got, want) == 0
    assert np.array_equal(got, want)
    dirs = (want // 256) % 2
    assert 0 < dirs.sum() < len(dirs)      # both strands listed
    forward = ref.read_index(s.read_codes, s.db_words, 25, "cpu",
                             canonical=False)
    assert ref.entries_wrong(forward, want) == dirs.sum()
    os.remove(idx)


def _lanes(rng, B, n, m):
    refs = rng.integers(0, 4, (B, n)).astype(np.int8)
    reads = rng.integers(0, 4, (B, m)).astype(np.int8)
    reads[: B // 2, 10:10 + m // 2] = refs[: B // 2, 20:20 + m // 2]
    refs[rng.random((B, n)) < 0.02] = 4               # N
    reads[:, m - 3:] = ref.PAD                         # padding
    nvec = rng.integers(n // 2, n + 1, B).astype(np.int32)
    return refs, reads, nvec


def _wrap_lane(rng):
    """A read of 160 + 40 bases against a reference that holds 200 more
    bases between them: a gap along the reference longer than 127."""
    a = rng.integers(0, 4, 160).astype(np.int8)
    c = rng.integers(0, 4, 40).astype(np.int8)
    mid = rng.integers(0, 4, 200).astype(np.int8)
    return np.concatenate([a, mid, c]), np.concatenate([a, c])


@pytest.mark.parametrize("seed", [1, 2])
def test_reference_fill_is_the_ports(seed):
    from genometester4_tpu_torch.ops import swalign
    rng = np.random.default_rng(seed)
    refs, reads, nvec = _lanes(rng, 6, 40, 30)
    wref, wread = _wrap_lane(rng)
    refs = np.concatenate([np.pad(refs, ((0, 0), (0, 360)),
                                  constant_values=ref.PAD), wref[None]])
    reads = np.concatenate([np.pad(reads, ((0, 0), (0, 170)),
                                   constant_values=ref.PAD), wread[None]])
    nvec = np.append(nvec, 400).astype(np.int32)
    args = [torch.from_numpy(a) for a in (refs, reads, nvec)]
    want = swalign.sw_fill(*args)
    got = ref.sw_fill(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert (got[2][-1] > 0).any()     # a gap length past 127 wrapped
    wrong8 = ref.sw_fill(*args, score_bits=8)
    assert not torch.equal(wrong8[0], want[0])


def test_fill_regions_equals_one_fill_a_region():
    rng = np.random.default_rng(4)
    regions = []
    for n, b, m in ((30, 3, 20), (25, 2, 24), (30, 1, 17)):
        regions.append((rng.integers(0, 4, n).astype(np.int8),
                        rng.integers(0, 4, (b, m)).astype(np.int8)))
    got = ref.fill_regions(regions, "cpu", block_lanes=4)
    for (r, batch), mats in zip(regions, got):
        b, m = batch.shape
        one = ref.sw_fill(torch.from_numpy(np.tile(r, (b, 1))),
                          torch.from_numpy(batch),
                          torch.full((b,), len(r), dtype=torch.int32))
        for g, w in zip(mats, one):
            assert g.shape == (b, len(r) + 1, m + 1)
            assert np.array_equal(g, w.numpy())


def test_a_small_copy_comes_out_correct():
    r = tiny_run()
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == {"index_entries_wrong", "sw_lanes_wrong",
                                "calls_wrong"}
    assert r["checks"]["index_entries_wrong"]["value"] == 0
    assert r["checks"]["sw_lanes_wrong"]["value"] == 0
    assert r["metrics"]["count_Mbp_s"]["value"] > 0


def _drop_an_entry():
    from genometester4_tpu_torch.formats import read_index
    pack = read_index.pack_read_index

    def dropped(nbf, nbn, nbk, files, blocks, reads):
        return pack(nbf, nbn, nbk, files, blocks, reads[:-1])
    return read_index, "pack_read_index", dropped


def _alter_a_cell():
    from genometester4_tpu_torch.ops import swalign_cuda
    fill = swalign_cuda.sw_fill

    def altered(refs, reads, nvec):
        score, sx, sy = fill(refs, reads, nvec)
        score[0, 5, 5] += 1
        return score, sx, sy
    return swalign_cuda, "sw_fill", altered


def _flip_a_call():
    from gt4bench.drivers import katk
    job = katk.Driver._job

    def flipped(self):
        text = job(self)
        s = self.sample
        calls = ref.parse_calls(text)
        v = next(v for v in s.variants if s.judged[v.region]
                 and v.kind != "del" and (v.pos, 0) in calls
                 and tuple(sorted(calls[v.pos, 0][1])) == v.genotype[0])
        lines = text.split("\n")
        for i, line in enumerate(lines):
            f = line.split("\t")
            if len(f) > 6 and f[1] == str(v.pos) and f[2] == "0":
                f[5] = f[3] + f[3]
                lines[i] = "\t".join(f)
        return "\n".join(lines)
    return katk.Driver, "_job", flipped


FAULTS = {"index_entry_dropped": _drop_an_entry,
          "tapped_cell_altered": _alter_a_cell,
          "call_flipped": _flip_a_call}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_comes_out_not_correct(fault, monkeypatch):
    obj, attr, fn = FAULTS[fault]()
    monkeypatch.setattr(obj, attr, fn)
    r = tiny_run()
    assert not r["correct"] and r["failed"] > 0
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("seed", [1, (1 << 31) + 3])
def test_control_comes_out_wrong(seed):
    cell = manifest.cell(CELL)
    got = control.readings(cell, seed, 2, "cpu", OVERRIDES)
    lim = OVERRIDES["config"]["limits"]
    assert got["index_entries_wrong"] > lim["index_entries_wrong"]
    assert got["sw_lanes_wrong"] > lim["sw_lanes_wrong"]
    assert got["calls_wrong"] > lim["calls_wrong"]


class _Trace:
    """A device trace holding ``kernel_s`` seconds of kernel C."""

    def __init__(self, kernel_s):
        self.kernel_s = kernel_s

    def kernel_seconds(self, patterns):
        return self.kernel_s if "sw_lanes_kernel" in patterns else 0.0


def test_the_traced_run_reads_every_new_metric(monkeypatch):
    """Each new metric reads a value in a traced run of the small copy,
    and nothing untraced, with the recorder's rows dropped, or without
    the recorder; the roofline reads the fills' counted cells against a
    kernel time."""
    from genometester4_tpu_torch import utils
    from genometester4_tpu_torch.utils import trace
    trace.reset()
    try:
        r = tiny_run(trace=True, seconds=0.5)
        assert r["correct"]
        got = r["metrics"]
        for name in NEW:
            assert got[name]["value"] >= 0, name
        # no card: no kernel C in the trace
        assert "sw_roofline.katk" not in got
        assert got["align_pct.katk"]["value"] > 0
        assert got["index_pct.katk"]["value"] > 0
        assert sum(got[n]["value"] for n in NEW[:4]) <= 100.0
        rows = trace.rows()
        cells = sum((x.counts or {}).get("sw.cells", 0) for x in rows)
        inb = sum((x.counts or {}).get("sw.in_bytes", 0) for x in rows)
        assert cells > 0 and inb > 0
        run = SimpleNamespace(kind="count", t0=min(x.t0 for x in rows),
                              t1=max(x.t1 for x in rows), trace=_Trace(1.0))
        run.window_s = run.t1 - run.t0
        roof = manifest.metric_reader("sw_roofline.katk")
        assert roof(run) == pytest.approx(100.0 * max(
            (4 * cells + inb) / 3.35e12, 30 * cells / 16.7e12))
        readers = [manifest.metric_reader(n)
                   for n in NEW + ["sw_roofline.katk"]]
        assert all(read(run) is not None for read in readers)
        run.trace = None      # an untraced run
        assert all(read(run) is None for read in readers)
        run.trace = _Trace(1.0)
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
    assert not set(NEW) & set(untraced)


def test_a_dry_run_loads_neither_jax_nor_the_jax_package():
    from gt4bench.run import FORBIDDEN
    repo = manifest.BENCHMARK.parent
    code = ("import json\n"
            "from gt4bench.tests.test_gt4bench_katk import tiny_run\n"
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
