"""Port vs JAX: glistmaker, glistcompare and make_union on a process group.

Real gloo groups over loopback: each process runs the port's CLI on the CPU
through ``genometester4_tpu_torch.tools.group_run`` (with
``make_global_mesh(devices=["cpu"] * local)`` where a process has several
slots), the JAX package's CLI runs in this process as one process. Only
process 0 may print or write, no process may return before process 0's
files exist, and process 0's files and stdout must equal JAX's, byte for
byte (tolerance 0)."""

import contextlib
import io
import os
import time
from pathlib import Path

import numpy as np
import pytest

from tests.conftest import random_fasta
from genometester4_tpu.cli import glistcompare as jax_compare
from genometester4_tpu.cli import glistmaker as jax_maker
from genometester4_tpu.cli import make_union as jax_union
from genometester4_tpu_torch.formats.list_format import write_list
from genometester4_tpu_torch.tools import group_run

GROUP_TIMEOUT = 180   # s, each process's communicate()


def run_group(nprocs, spec, cwd, timeout=GROUP_TIMEOUT, dist_timeout=60,
              env=None):
    """``tools.group_run.launch`` of ``nprocs`` processes with ``spec`` (one
    for all or a list, one a process), each in ``cwd`` (one directory, or
    a list) with ``env`` added, one thread of torch each."""
    cwds = cwd if isinstance(cwd, list) else [cwd] * nprocs
    specs = spec if isinstance(spec, list) else [spec] * nprocs
    penv = {"OMP_NUM_THREADS": "1", **(env or {})}
    return group_run.launch(specs, [str(c) for c in cwds],
                            [penv] * nprocs, timeout, dist_timeout)


def assert_group_ok(res, names):
    """Every process exited 0 and returned after process 0's files
    ``names`` existed; only process 0 printed."""
    for rank, (rc, out, err, rep) in enumerate(res):
        assert rc == 0, f"process {rank}: {err[-3000:]}"
        assert rep["rank"] == rank and rep["transport"] == "gloo"
        assert set(names) <= set(rep["files"]), (rank, rep["files"])
        if rank:
            assert out == b""


def run_cli(main, args, cwd, **env):
    """A CLI ``main`` in ``cwd`` in this process, with ``env`` set:
    (rc, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    old_dir, old_env = os.getcwd(), {k: os.environ.get(k) for k in env}
    os.chdir(cwd)
    os.environ.update(env)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                rc = main(list(args))
            except SystemExit as e:
                rc = e.code
    finally:
        os.chdir(old_dir)
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return rc or 0, out.getvalue(), err.getvalue()


def files(d):
    """Every file under ``d`` but the runner's reports, by relative name."""
    return {str(p.relative_to(d)): p.read_bytes() for p in Path(d).rglob("*")
            if p.is_file() and not p.name.startswith(".group_report")}


def _dirs(tmp_path, *names):
    out = []
    for n in names:
        (tmp_path / n).mkdir()
        out.append(tmp_path / n)
    return out


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """Two FASTA files with Ns (the multi-file, multi-slab input of JAX's
    ``tests/test_multihost.py``)."""
    d = tmp_path_factory.mktemp("mh_fa")
    rng = np.random.default_rng(121)
    (d / "a.fa").write_text(random_fasta(rng, 3, 3000, 6000, n_prob=0.01))
    (d / "b.fa").write_text(random_fasta(rng, 2, 2000, 4000, n_prob=0.01))
    return [str(d / "a.fa"), str(d / "b.fa")]


def _jax_list(fasta, k, cwd):
    rc, out, err = run_cli(jax_maker.main, fasta + ["-w", str(k), "-o",
                                                    "jax"], cwd,
                           GT4_TPU_MESH="0", GT4_TPU_COUNT_IMPL="device")
    assert rc == 0, err
    return (Path(cwd) / f"jax_{k}.list").read_bytes(), out


@pytest.mark.parametrize("nprocs,local", [(2, 1), (2, 2), (4, 2)])
def test_glistmaker_group_equals_jax(tmp_path, fasta, nprocs, local):
    """JAX's shapes (``tests/test_multihost.py``): the group's .list equals
    JAX's single-process one; only process 0 writes, and none returns
    before it exists."""
    jd, pd = _dirs(tmp_path, "jax", "port")
    want, want_out = _jax_list(fasta, 16, jd)
    res = run_group(nprocs, {"tool": "glistmaker", "device": "cpu",
                             "local": ["cpu"] * local,
                             "argv": fasta + ["-w", "16", "-o", "mh"]}, pd)
    assert_group_ok(res, ["mh_16.list"])
    assert files(pd) == {"mh_16.list": want}
    assert res[0][1].decode() == want_out
    for _, _, _, rep in res:   # from the spans of parallel.multihost
        assert rep["exchange"]["bytes"] > 0 and rep["exchange"]["s"] > 0
        assert rep["exchange"]["stage_s"] == 0   # no card tensor to stage
        assert rep["launches"] == {"extract": 0, "run_marks": 0,
                                   "merge_runs": 0}


def test_glistmaker_group_overflow_on_some_processes(tmp_path):
    """A small starting bucket slack: process 0's chunk (random bases)
    overflows its buckets, process 1's (a repeat) does not. Both retry
    together on the group's overflow flag and the bytes equal JAX's."""
    rng = np.random.default_rng(5)
    fa = tmp_path / "skew.fa"
    head = rng.choice(np.frombuffer(b"ACGT", np.uint8), 32_768).tobytes()
    fa.write_bytes(b">s\n" + head + b"ACGTTGCA" * 3000 + b"\n")
    jd, pd = _dirs(tmp_path, "jax", "port")
    want, _ = _jax_list([str(fa)], 16, jd)
    step = "genometester4_tpu_torch.parallel.sharding:sharded_count_step"
    res = run_group(2, {"tool": "glistmaker", "device": "cpu",
                        "cap_factor": 0.3, "count": [step],
                        "argv": [str(fa), "-w", "16", "-o", "mh"]}, pd)
    assert_group_ok(res, ["mh_16.list"])
    assert files(pd) == {"mh_16.list": want}
    steps = [rep["calls"][step] for _, _, _, rep in res]
    assert steps[0] == steps[1] > 1     # retried, in step on both


def test_glistmaker_group_spills_on_process_0_only(tmp_path, fasta):
    """A spill budget of one byte: process 0 spills every counted shard to
    tmp .list files (and deletes them), the other process holds none."""
    jd, pd, tmp = _dirs(tmp_path, "jax", "port", "spill")
    want, _ = _jax_list(fasta, 16, jd)
    spill = "genometester4_tpu_torch.pipelines.listmaker:write_list"
    res = run_group(2, {"tool": "glistmaker", "device": "cpu",
                        "count": [spill],
                        "argv": fasta + ["-w", "16", "-o", "mh"]}, pd,
                    env={"GT4_SPILL_BYTES": "1",
                         "GT4_TPU_TMPDIR": str(tmp)})
    assert_group_ok(res, ["mh_16.list"])
    assert files(pd) == {"mh_16.list": want}
    assert [rep["calls"][spill] for _, _, _, rep in res][1] == 0
    assert res[0][3]["calls"][spill] >= 2
    assert not list(tmp.iterdir())


def _random_list(path, rng, base, keep, k=12):
    w = base[rng.random(len(base)) < keep]
    c = rng.integers(1, 7, len(w)).astype(np.uint32)
    c[rng.random(len(w)) < 0.1] = 0xFFFFFFF8   # ADD wraps at 2^32
    write_list(str(path), k, w, c)
    return str(path)


@pytest.fixture(scope="module")
def lists(tmp_path_factory):
    """Three .list files of 12-mers sharing words."""
    d = tmp_path_factory.mktemp("mh_lists")
    rng = np.random.default_rng(77)
    base = np.unique(rng.integers(0, 1 << 24, 6000).astype(np.uint64))
    return [_random_list(d / f"l{i}_12.list", rng, base, 0.6)
            for i in range(3)]


def _compare_both(tmp_path, nprocs, local, args):
    jd, pd = _dirs(tmp_path, "jax", "port")
    rj = run_cli(jax_compare.main, args, jd, GT4_TPU_MESH="0",
                 GT4_TPU_SETOPS_IMPL="device")
    res = run_group(nprocs, {"tool": "glistcompare", "device": "cpu",
                             "local": ["cpu"] * local, "argv": args}, pd)
    return rj, files(jd), res, files(pd)


@pytest.mark.parametrize("nprocs,local", [(2, 1), (2, 2)])
def test_glistcompare_pair_group_equals_jax(tmp_path, lists, nprocs, local):
    """-u -i -d -dd -r add with --count_only's counts: the four files and
    stdout equal JAX's."""
    args = [lists[0], lists[1], "-u", "-i", "-d", "-dd", "-r", "add", "-o",
            "cmp"]
    rj, fj, res, fp = _compare_both(tmp_path, nprocs, local, args)
    assert rj[0] == 0 and len(fj) == 4
    assert_group_ok(res, list(fj))
    assert fp == fj and res[0][1].decode() == rj[1]


def test_glistcompare_pair_group_with_empty_parts(tmp_path):
    """Three words over four slots: some parts hold nothing and are still
    signalled, so process 0 does not wait for them."""
    one, two = tmp_path / "one_12.list", tmp_path / "two_12.list"
    write_list(str(one), 12, np.array([5], np.uint64),
               np.array([3], np.uint32))
    write_list(str(two), 12, np.array([5, 9], np.uint64),
               np.array([1, 2], np.uint32))
    args = [str(one), str(two), "-u", "-i", "-d", "-dd", "--count_only",
            "-o", "cmp"]
    rj, fj, res, fp = _compare_both(tmp_path, 2, 2, args)
    assert rj[0] == 0 and fj == fp == {}
    assert_group_ok(res, [])
    assert res[0][1].decode() == rj[1] and "NUnique" in rj[1]


@pytest.mark.parametrize("op", ["-u", "-i"])
def test_glistcompare_multi_group_equals_jax(tmp_path, lists, op):
    """An N-list operation over three plain .lists runs on the group (not
    each process's host fast path): the file and stdout equal JAX's."""
    args = lists + [op, "-c", "2", "-o", "multi", "-D"]
    rj, fj, res, fp = _compare_both(tmp_path, 2, 2, args)
    assert rj[0] == 0 and len(fj) == 1
    assert_group_ok(res, list(fj))
    assert fp == fj and res[0][1].decode() == rj[1]
    assert "NUnique" in rj[1]


def test_make_union_group_equals_jax(tmp_path, lists):
    """make_union over three lists on a group: every staged and final
    file equals JAX's make_union (its host route)."""
    jd, pd = _dirs(tmp_path, "jax", "port")
    rj = run_cli(jax_union.main_union, lists, jd,
                 GT4_TPU_SETOPS_IMPL="host")
    t0 = time.perf_counter()
    res = run_group(2, {"tool": "make_union", "device": "cpu",
                        "argv": lists}, pd)
    assert time.perf_counter() - t0 < GROUP_TIMEOUT
    fj = files(jd)
    assert rj[0] == 0 and "union_12_union.list" in fj
    assert_group_ok(res, ["union_12_union.list"])
    assert files(pd) == fj
