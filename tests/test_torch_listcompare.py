"""Port vs JAX: glistcompare's pipelines (``pipelines.listcompare``) and CLI
on the CPU. The port runs its device route with ``device="cpu"`` and its
native host route (``GT4_TPU_SETOPS_IMPL=host``); the JAX package runs
its device route (without the mesh) and its host route in-process. Files,
counts, stdout, stderr and exit codes must be equal (tolerance 0)."""

import contextlib
import io
import itertools
import os

import numpy as np
import pytest
import torch

from tests.conftest import random_fasta
from tests.test_glistcompare_chrome import CASES as CHROME_CASES
from genometester4_tpu.cli import glistcompare as jax_cli
from genometester4_tpu.pipelines import listcompare as jax_lc
from genometester4_tpu.pipelines import listmaker as jax_listmaker
from genometester4_tpu_torch.cli import glistcompare as port_cli
from genometester4_tpu_torch.formats.list_format import write_list
from genometester4_tpu_torch.pipelines import listcompare as port_lc

torch.set_num_threads(1)

ALL_OPS = ["union", "intrsec", "diff1", "diff2"]


@pytest.fixture(params=["device", "host"])
def route(request, monkeypatch):
    """Both packages' route: ``device`` (the port on the CPU) or
    ``host``."""
    monkeypatch.setenv("GT4_TPU_MESH", "0")
    monkeypatch.setenv("GT4_TPU_SETOPS_IMPL", request.param)
    return request.param


def _random_list(path, rng, n, k=12, big=False):
    space = 1 << (2 * k)
    w = np.unique(rng.integers(0, space, n).astype(np.uint64))
    c = rng.integers(1, 7, len(w)).astype(np.uint32)
    if big:   # counts near 2^32: ADD wraps
        c[rng.random(len(w)) < 0.3] = 0xFFFFFFF8
    write_list(str(path), k, w, c)
    return str(path)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Three .list files of 12-mers sharing words, and a FASTA's .index
    and .list (made by the JAX package's host route)."""
    d = tmp_path_factory.mktemp("lc")
    rng = np.random.default_rng(41)
    base = np.unique(rng.integers(0, 1 << 24, 4000).astype(np.uint64))
    paths = []
    for i in range(3):
        keep = rng.random(len(base)) < 0.6
        w = base[keep]
        c = rng.integers(1, 7, len(w)).astype(np.uint32)
        c[rng.random(len(w)) < 0.1] = 0xFFFFFFF8
        write_list(str(d / f"l{i}.list"), 12, w, c)
        paths.append(str(d / f"l{i}.list"))
    fa = d / "g.fa"
    fa.write_text(random_fasta(rng, 4, 1000, 3000, n_prob=0.01))
    old = os.environ.get("GT4_TPU_COUNT_IMPL")
    os.environ["GT4_TPU_COUNT_IMPL"] = "host"
    try:
        jax_listmaker.make_index([str(fa)], 12, str(d / "g.index"))
        jax_listmaker.make_list([str(fa)], 12, str(d / "g.list"))
    finally:
        os.environ.pop("GT4_TPU_COUNT_IMPL")
        if old is not None:
            os.environ["GT4_TPU_COUNT_IMPL"] = old
    return d, paths, str(d / "g.index")


def _outputs(d):
    return {p.name: p.read_bytes() for p in d.iterdir()
            if p.suffix == ".list"}


def _pair_both(tmp_path, route, a, b, **kw):
    """compare_pair of both packages (the port on device="cpu" for the
    device route); results and output files."""
    jd, pd = tmp_path / "jax", tmp_path / "port"
    jd.mkdir(parents=True)
    pd.mkdir(parents=True)
    rj = jax_lc.compare_pair(a, b, ALL_OPS, str(jd / "o"), **kw)
    rp = port_lc.compare_pair(a, b, ALL_OPS, str(pd / "o"), device="cpu",
                              **kw)
    return rj, rp, _outputs(jd), _outputs(pd)


@pytest.mark.parametrize("rule,subtract", [("default", False),
                                           ("default", True), ("add", False),
                                           ("max", False), ("min", False),
                                           ("number", False)])
@pytest.mark.parametrize("cutoff", [1, 3])
def test_compare_pair_equal(tmp_path, route, inputs, rule, subtract, cutoff):
    """Four outputs in one pass, in small buckets (several device passes)
    and in one."""
    _, (a, b, _), _ = inputs
    for bucket in (512, 1 << 25):
        rj, rp, fj, fp = _pair_both(tmp_path / str(bucket), route, a, b,
                                    cutoff=cutoff, rule=rule,
                                    count_override=4, subtract=subtract,
                                    bucket_target=bucket)
        assert rj == rp and len(fj) == 4 and fj == fp


def test_compare_pair_index_input_and_wrap(tmp_path, route, inputs):
    """An .index source (its counts are location counts) beside a .list;
    and two lists whose counts wrap under ADD."""
    d, _, idx = inputs
    rj, rp, fj, fp = _pair_both(tmp_path / "i", route, idx, str(d / "g.list"))
    assert rj == rp and fj == fp and rj["intrsec"][0] > 0
    rng = np.random.default_rng(3)
    x = _random_list(tmp_path / "x.list", rng, 900, big=True)
    y = _random_list(tmp_path / "y.list", rng, 900, big=True)
    rj, rp, fj, fp = _pair_both(tmp_path / "w", route, x, y, rule="add")
    assert rj == rp and fj == fp


@pytest.mark.parametrize("op,rule", [("union", "default"), ("union", "max"),
                                     ("union", "number"),
                                     ("intrsec", "default"),
                                     ("intrsec", "add"), ("intrsec", "max")])
def test_compare_multi_equal(tmp_path, route, inputs, op, rule):
    """Three .lists and an .index, cutoffs 1 and 2, small buckets."""
    _, paths, idx = inputs
    for cutoff, srcs in itertools.product((1, 2), (paths, paths + [idx])):
        jd, pd = tmp_path / f"j{cutoff}{len(srcs)}", tmp_path / f"p{cutoff}{len(srcs)}"
        jd.mkdir()
        pd.mkdir()
        rj = jax_lc.compare_multi(srcs, op, str(jd / "o"), cutoff, rule, 3,
                                  bucket_target=700)
        rp = port_lc.compare_multi(srcs, op, str(pd / "o"), cutoff, rule, 3,
                                   bucket_target=700, device="cpu")
        assert rj == rp and _outputs(jd) == _outputs(pd)


@pytest.mark.parametrize("impl", ["native", "numpy"])
@pytest.mark.parametrize("nmm,subtract", [(1, False), (2, False), (1, True),
                                          (2, True)])
def test_compare_pair_mm_equal(tmp_path, monkeypatch, inputs, impl, nmm,
                               subtract):
    """-mm: the mismatch difference, host code in both packages (native C
    or numpy, by GT4_MM_IMPL)."""
    monkeypatch.setenv("GT4_MM_IMPL", impl)
    rng = np.random.default_rng(nmm)
    a = _random_list(tmp_path / "a.list", rng, 400, k=7)
    b = _random_list(tmp_path / "b.list", rng, 300, k=7)
    for cutoff in (1, 2):
        rj = jax_lc.compare_pair_mm(a, b, ["diff1", "diff2"],
                                    str(tmp_path / "j"), cutoff, nmm,
                                    subtract)
        rp = port_lc.compare_pair_mm(a, b, ["diff1", "diff2"],
                                     str(tmp_path / "p"), cutoff, nmm,
                                     subtract)
        assert rj == rp
        for op in ("diff1", "diff2"):
            assert ((tmp_path / f"j_7_{nmm}_{op}.list").read_bytes()
                    == (tmp_path / f"p_7_{nmm}_{op}.list").read_bytes())


@pytest.mark.parametrize("method", ["rand", "rand_unique",
                                    "rand_weighted_unique"])
def test_make_subset_equal(tmp_path, inputs, method):
    """-ss on a .list (the native drand48 loop) and on an .index (the
    Python Rand48 twin of the JAX package's generic path)."""
    _, _, idx = inputs
    # small counts: "rand" draws once per count unit
    a = _random_list(tmp_path / "a.list", np.random.default_rng(8), 3000)
    for src, size in ((a, 300), (idx, 200)):
        j = jax_lc.make_subset(src, method, size, str(tmp_path / "j"), 11)
        p = port_lc.make_subset(src, method, size, str(tmp_path / "p"), 11)
        assert open(j, "rb").read() == open(p, "rb").read()


def test_rand48_stream_equal():
    from genometester4_tpu.utils.rand48 import Rand48 as JaxRand48
    from genometester4_tpu_torch.utils.rand48 import Rand48
    a, b = JaxRand48(1234), Rand48(1234)
    assert [a.drand() for _ in range(50)] == [b.drand() for _ in range(50)]
    assert np.array_equal(a.drand_array(1000), b.drand_array(1000))


# ---------------------------------------------------------------- the CLI

def _run(main, args, cwd, **kw):
    """A CLI ``main`` in ``cwd``: (rc, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                rc = main(list(args), **kw)
            except SystemExit as e:
                rc = e.code if isinstance(e.code, int) else 1
    finally:
        os.chdir(old)
    return rc or 0, out.getvalue(), err.getvalue()


def _cli_both(tmp_path, args):
    """The same argv through the JAX CLI and the port's (``device="cpu"``)
    in two empty directories; (rc, stdout, stderr) and the files each
    wrote."""
    jd, pd = tmp_path / "jax_cli", tmp_path / "port_cli"
    jd.mkdir(parents=True)
    pd.mkdir(parents=True)
    rj = _run(jax_cli.main, args, jd)
    rp = _run(port_cli.main, args, pd, device="cpu")
    return (rj, {p.name: p.read_bytes() for p in jd.iterdir()},
            rp, {p.name: p.read_bytes() for p in pd.iterdir()})


@pytest.fixture(scope="module")
def chrome_lists(tmp_path_factory):
    """The chrome test's fixture, made by the port's glistmaker CLI."""
    from genometester4_tpu_torch.cli.glistmaker import main
    d = tmp_path_factory.mktemp("gc_chrome")
    (d / "a.fa").write_text(">s1\nACGTACGTACGTACGT\n")
    (d / "b.fa").write_text(">s2\nTTTTACGTACGTAAAA\n")
    for fa, w, o in (("a.fa", 8, "A"), ("b.fa", 8, "B"), ("b.fa", 9, "C")):
        rc, _, err = _run(main, [str(d / fa), "-w", str(w), "-o",
                                 str(d / o)], d, device="cpu")
        assert rc == 0, err
    (d / "trunc.list").write_bytes((d / "A_8.list").read_bytes()[:20])
    return d


@pytest.mark.parametrize("case", CHROME_CASES,
                         ids=lambda c: " ".join(c)[:50] or "noargs")
def test_cli_chrome_cases_equal(case, chrome_lists, tmp_path, route):
    d = chrome_lists
    sub = {"{A}": str(d / "A_8.list"), "{B}": str(d / "B_8.list"),
           "{C}": str(d / "C_9.list"), "{FA}": str(d / "a.fa"),
           "{T}": str(d / "trunc.list")}
    rj, fj, rp, fp = _cli_both(tmp_path, [sub.get(a, a) for a in case])
    assert rp == rj
    assert fp == fj


@pytest.fixture(scope="module")
def fast_lists(tmp_path_factory):
    """tests/test_fastcli.py's inputs: four .lists of 16-mers (3 random
    records of 3-6 kb each), made by the port's glistmaker CLI."""
    from genometester4_tpu_torch.cli.glistmaker import main
    d = tmp_path_factory.mktemp("fastcli")
    rng = np.random.default_rng(5)
    paths = []
    for i in range(4):
        fa = d / f"in{i}.fa"
        fa.write_text(random_fasta(rng, 3, 3000, 6000, n_prob=0.01))
        rc, _, err = _run(main, [str(fa), "-w", "16", "-o", str(d / f"l{i}")],
                          d, device="cpu")
        assert rc == 0, err
        paths.append(str(d / f"l{i}_16.list"))
    rc, _, _ = _run(main, [str(d / "in0.fa"), "-w", "16", "--index", "-o",
                           str(d / "x")], d, device="cpu")
    assert rc == 0
    return d, paths


FAST_CASES = [
    ["LST0", "-ss", "rand", "800", "--seed", "11"],
    ["LST0", "-ss", "rand_unique", "800", "--seed", "11"],
    ["LST0", "-ss", "rand_weighted_unique", "800", "--seed", "11"],
    ["LST0", "-ss", "rand", "99999999", "--seed", "3"],
    ["LST0", "LST1", "LST2", "LST3", "-u"],
    ["LST0", "LST1", "LST2", "LST3", "-i"],
    ["LST0", "LST1", "LST2", "LST3", "-u", "-i"],
    ["LST0", "LST1", "LST2", "LST3", "-u", "--count_only"],
    ["LST0", "LST1", "LST2", "LST3", "-i", "--count_only"],
    ["LST0", "LST1", "LST2", "LST3", "-u", "-i", "--count_only"],
    ["-v"],
    ["-u"],
    ["LST0", "LST1", "-u"],
    ["LST0", "LST1", "LST2", "-u", "-c", "2"],
    ["LST0", "LST1", "LST2", "-u", "-r", "max"],
    ["LST0", "LST1", "LST2", "--count_only", "-u"],
    ["LST0", "-ss", "rand_unique", "99999999"],
    ["LST0", "-ss", "bogus", "5"],
    ["LST0", "LST1", "LST2", "-u", "-o", "-i"],
    ["LST0", "LST1", "LST2"],
    # an .index source: the fast paths refuse it, the device route runs
    ["IDX", "LST1", "LST2", "-u", "-i"],
    ["IDX", "-ss", "rand_unique", "500", "--seed", "2"],
    ["IDX", "LST0", "-u", "-i", "-d", "-dd", "-D"],
]


@pytest.mark.parametrize("case", FAST_CASES, ids=lambda c: " ".join(c))
def test_cli_fastcli_cases_equal(case, fast_lists, tmp_path, route):
    d, paths = fast_lists
    args = [paths[int(a[3])] if a.startswith("LST")
            else str(d / "x_16.index") if a == "IDX" else a for a in case]
    rj, fj, rp, fp = _cli_both(tmp_path, args)
    assert rp == rj
    assert fp == fj


def test_cli_multi_with_empty_input(fast_lists, tmp_path, route):
    """A zero-record member list (the empty-stream branch)."""
    d, paths = fast_lists
    empty = str(tmp_path / "empty_16.list")
    write_list(empty, 16, np.empty(0, np.uint64), np.empty(0, np.uint32))
    for flag in ("-u", "-i"):
        rj, fj, rp, fp = _cli_both(tmp_path / flag,
                                   [paths[0], paths[1], empty, flag])
        assert rp == rj and fp == fj and rj[0] == 0


def test_cli_refuses_a_process_group(monkeypatch, tmp_path, inputs):
    """GT4_DIST_NPROCS=2 without GT4_DIST_COORD is no group, as in JAX
    (``multihost.distributed_env``): the CLI runs as one process, and its
    files and output equal JAX's."""
    monkeypatch.setenv("GT4_DIST_NPROCS", "2")
    monkeypatch.delenv("GT4_DIST_COORD", raising=False)
    monkeypatch.setenv("GT4_TPU_MESH", "0")
    _, paths, _ = inputs
    rj, fj, rp, fp = _cli_both(tmp_path, [paths[0], paths[1], "-u", "-i",
                                          "-D"])
    assert rp == rj and rj[0] == 0 and len(fj) == 2 and fp == fj
    assert not torch.distributed.is_initialized()
