"""Port vs JAX: gmer_counter on a process group, and the group's
environment contract.

Real gloo groups over loopback (``tests/test_torch_multihost_list.run_group``):
each process runs the port's gmer_counter CLI on the CPU with 1,500-base
chunks, so that chunk g goes to global slot g mod (dp * kp) across the
group; JAX's CLI runs in this process as one process, on its host route.
Process 0's stdout must equal JAX's and the other processes print nothing
(tolerance 0)."""

import time
from pathlib import Path

import numpy as np
import pytest

from chip_smoke import same_file
from tests.test_torch_gmercounter import _db_text, _fasta, _genome, _reads
from tests.test_torch_multihost_list import (assert_group_ok, run_cli,
                                             run_group)
from genometester4_tpu.cli import gmer_counter as jax_cli
from genometester4_tpu.parallel import multihost as jax_mh
from genometester4_tpu_torch.parallel import multihost as port_mh

CHUNK = 1500
STEP = "genometester4_tpu_torch.pipelines.gmercount:count_step"

ENVS = [
    {},
    {"GT4_DIST_COORD": ""},
    {"GT4_DIST_NPROCS": "2"},
    {"GT4_DIST_NPROCS": "2", "GT4_DIST_PROC_ID": "1"},
    {"GT4_DIST_COORD": "h:1"},
    {"GT4_DIST_COORD": "h:1", "GT4_DIST_NPROCS": "1"},
    {"GT4_DIST_COORD": "h:1", "GT4_DIST_NPROCS": "0"},
    {"GT4_DIST_COORD": "h:1", "GT4_DIST_NPROCS": "-3"},
    {"GT4_DIST_COORD": "h:1", "GT4_DIST_NPROCS": "2"},
    {"GT4_DIST_COORD": "10.0.0.1:29500", "GT4_DIST_NPROCS": "4",
     "GT4_DIST_PROC_ID": "3"},
    {"GT4_DIST_COORD": "h:1", "GT4_DIST_NPROCS": "x"},
    {"GT4_DIST_COORD": "h:1", "GT4_DIST_NPROCS": "2",
     "GT4_DIST_PROC_ID": "y"},
]


def _outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return type(e)


@pytest.mark.parametrize("env", ENVS, ids=lambda e: ",".join(
    f"{k[9:]}={v}" for k, v in e.items()) or "unset")
def test_distributed_env_equals_jax(monkeypatch, env):
    """The port's GT4_DIST_* contract is JAX's: the same triple, None
    without a coordinator or with NPROCS <= 1, the same error on a bad
    number; and a group that is not configured joins nothing."""
    for k in ("GT4_DIST_COORD", "GT4_DIST_NPROCS", "GT4_DIST_PROC_ID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want = _outcome(jax_mh.distributed_env)
    assert _outcome(port_mh.distributed_env) == want
    if want is None:
        assert port_mh.is_multiprocess() is False
        assert port_mh.init_from_env() is False


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("mh_gmer")
    rng = np.random.default_rng(909)
    g = _genome(rng)
    for k in (25, 32):
        (d / f"db{k}.txt").write_text(_db_text(rng, g, k))
    (d / "reads.fq").write_bytes(_reads(rng, g))
    (d / "reads.fa").write_bytes(_fasta(g))
    return d


CASES = {
    "plain": (2, 1, ["-db", "DB25", "READS_FQ"], {}),
    "stats": (2, 1, ["-db", "DB25", "--stats", "--total", "--unique",
                     "READS_FA", "READS_FQ"], {}),
    "stats_2x2_k32": (2, 2, ["-db", "DB32", "--stats", "--kmers",
                             "READS_FQ"], {}),
    "three_processes": (3, 1, ["-db", "DB32", "--stats", "READS_FA"], {}),
    "over_host_route": (2, 1, ["-db", "DB25", "--stats", "READS_FQ"],
                        {"GT4_TPU_COUNT_IMPL": "host"}),
}


def _argv(data, args):
    names = {"DB25": "db25.txt", "DB32": "db32.txt", "READS_FQ": "reads.fq",
             "READS_FA": "reads.fa"}
    return [str(data / names[a]) if a in names else a for a in args]


@pytest.mark.parametrize("case", list(CASES))
def test_gmer_counter_group_equals_jax(tmp_path, data, case):
    """Count mode on the group: process 0 prints JAX's counts (and
    --stats' totals, summed over the group); the chunks are dealt over
    every process, each counting some; a group overrides the host
    route."""
    nprocs, local, args, env = CASES[case]
    argv = _argv(data, args)
    rj = run_cli(jax_cli.main, argv, tmp_path, GT4_TPU_COUNT_IMPL="host")
    assert rj[0] == 0 and rj[1].count("\n") > 60
    res = run_group(nprocs, {"tool": "gmer_counter", "device": "cpu",
                             "local": ["cpu"] * local, "chunk_bases": CHUNK,
                             "count": [STEP], "argv": argv}, tmp_path,
                    env=env)
    assert_group_ok(res, [])
    assert res[0][1].decode() == rj[1]
    steps = [rep["calls"][STEP] for _, _, _, rep in res]
    assert min(steps) > 0 and max(steps) - min(steps) <= 1 + (
        len(args) > 3)


def test_gmer_counter_compile_index_stays_per_process(tmp_path, data):
    """--compile_index under a group: every process builds its own read
    index (in its own directory here), process 0's equal to JAX's."""
    jd = tmp_path / "jax"
    dirs = [tmp_path / f"p{i}" for i in range(2)]
    for d in [jd, *dirs]:
        d.mkdir()
    argv = _argv(data, ["-db", "DB25", "--compile_index", "db.idx",
                        "READS_FQ"])
    try:
        rj = run_cli(jax_cli.main, argv, jd, GT4_TPU_COUNT_IMPL="host")
        assert rj[0] == 0
        res = run_group(2, {"tool": "gmer_counter", "device": "cpu",
                            "chunk_bases": CHUNK, "argv": argv}, dirs)
        for rank, (rc, out, err, rep) in enumerate(res):
            assert rc == 0, err[-3000:]
            assert "db.idx" in rep["files"]
        assert res[0][1].decode() == rj[1] and res[1][1] == b""
        assert same_file(str(dirs[0] / "db.idx"), str(jd / "db.idx"))
        assert same_file(str(dirs[1] / "db.idx"), str(jd / "db.idx"))
    finally:
        for d in [jd, *dirs]:
            p = Path(d) / "db.idx"
            if p.exists():
                p.unlink()


def test_a_process_that_exits_early_fails_the_group(tmp_path, data):
    """Process 1 leaves right after joining: process 0 fails at its first
    collective, well within the collective timeout, instead of hanging,
    and prints nothing."""
    spec = {"tool": "gmer_counter", "device": "cpu", "chunk_bases": CHUNK,
            "argv": _argv(data, ["-db", "DB25", "READS_FQ"])}
    t0 = time.perf_counter()
    res = run_group(2, [spec, {**spec, "exit": 3}], tmp_path,
                    dist_timeout=30, timeout=90)
    assert time.perf_counter() - t0 < 60
    assert res[1][0] == 3
    assert res[0][0] != 0 and res[0][1] == b"" and res[0][3] is None
