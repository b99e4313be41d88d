"""Port vs JAX: the glistmaker CLI. The same argv goes through the JAX
package's CLI (its device route without the mesh, or its host route) and
the port's (``main(argv, device="cpu")``; its ``--index`` also on its
native host route under ``GT4_TPU_COUNT_IMPL=host``) in two empty
directories: exit codes, stdout, stderr and the ``.list``/``.index`` bytes
must be equal."""

import contextlib
import gzip
import io
import os

import numpy as np
import pytest
import torch

from tests.conftest import random_fasta, random_fastq
from tests.test_cli_chrome import CASES as CHROME_CASES
from genometester4_tpu.cli import glistmaker as jax_cli
from genometester4_tpu_torch.cli import glistmaker as port_cli

torch.set_num_threads(1)


@pytest.fixture(params=["device", "host"])
def route(request, monkeypatch):
    monkeypatch.setenv("GT4_TPU_MESH", "0")
    monkeypatch.setenv("GT4_TPU_COUNT_IMPL", request.param)
    return request.param


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("glm")
    rng = np.random.default_rng(17)
    (d / "in.fa").write_text(random_fasta(rng, 4, 10, 5000, n_prob=0.01))
    (d / "in.fq").write_text(random_fastq(rng, 60, 100, n_prob=0.01))
    (d / "in.fa.gz").write_bytes(gzip.compress((d / "in.fa").read_bytes()))
    return d


def _run(main, args, cwd, **kw):
    out, err = io.StringIO(), io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(list(args), **kw)
    finally:
        os.chdir(old)
    return rc, out.getvalue(), err.getvalue()


def _both(tmp_path, args):
    jd, pd = tmp_path / "jax", tmp_path / "port"
    jd.mkdir(parents=True)
    pd.mkdir(parents=True)
    rj = _run(jax_cli.main, args, jd)
    rp = _run(port_cli.main, args, pd, device="cpu")
    return (rj, {p.name: p.read_bytes() for p in jd.iterdir()},
            rp, {p.name: p.read_bytes() for p in pd.iterdir()})


@pytest.mark.parametrize("args", [a for t, a in CHROME_CASES
                                  if t == "glistmaker"],
                         ids=lambda a: " ".join(a) or "noargs")
def test_chrome_cases_equal(tmp_path, args):
    rj, fj, rp, fp = _both(tmp_path, args)
    assert rp == rj and fp == fj == {}


ERRORS = [
    [],                                   # no input
    ["IN", "-w", "0"],
    ["IN", "-w", "40"],
    ["IN", "-w", "x"],
    ["IN", "-w", "-3"],
    ["IN", "-w", "12", "-c", "0"],
    ["IN", "-w", "12", "-c", "5", "--max", "4"],
    ["IN", "-w", "12", "-c", "x"],
    ["IN", "-w", "12", "--max", "x"],
    ["IN", "-w", "12", "--num_threads", "x"],
    ["IN", "-w", "12", "--max_tables", "x"],
    ["IN", "-w", "12", "--table_size", "x"],
    ["IN", "-w", "12", "-o", "o" * 201],
    ["missing.fa", "-w", "12"],
    ["IN", "-w"],                         # a flag missing its value
    ["IN", "-w", "12", "-o"],
    ["IN", "-w", "12", "--tmpdir"],
    ["IN", "-w", "12", "--bogus"],
    ["-v", "IN"],
    ["IN", "-h"],
]


@pytest.mark.parametrize("args", ERRORS, ids=lambda a: " ".join(a)[:40]
                         or "noargs")
def test_error_paths_equal(tmp_path, inputs, args):
    args = [str(inputs / "in.fa") if a == "IN" else a for a in args]
    rj, fj, rp, fp = _both(tmp_path, args)
    assert rp == rj and fp == fj == {}


@pytest.mark.parametrize("k", [12, 25, 32])
@pytest.mark.parametrize("index", [False, True])
def test_outputs_equal(tmp_path, inputs, route, k, index):
    """.list and .index bytes over FASTA, gzipped FASTA and FASTQ; the
    cutoffs reach --index only (the reference's bug, kept)."""
    args = [str(inputs / "in.fa"), str(inputs / "in.fa.gz"),
            str(inputs / "in.fq"), "-w", str(k), "-o", "out", "-c", "2",
            "--max", "9"] + (["--index"] if index else [])
    rj, fj, rp, fp = _both(tmp_path, args)
    assert rp == rj and rj[0] == 0
    name = f"out_{k}.index" if index else f"out_{k}.list"
    assert list(fp) == [name] and fp == fj and len(fp[name]) > 200


def test_table_size_swallows_the_next_argument(tmp_path, inputs, route):
    """--table_size's value and the argument after it are skipped (the
    reference's stray ``i += 1``)."""
    args = ["--table_size", "10", "skipped.fa", str(inputs / "in.fa"),
            "-w", "12"]
    rj, fj, rp, fp = _both(tmp_path, args)
    assert rp == rj and rj[0] == 0 and fp == fj and list(fp) == ["out_12.list"]


def test_debug_header_lines_equal(tmp_path, inputs, route):
    """-D prints the C variables' header block (clamped as the reference
    does), then the phase lines; only the timed lines may differ."""
    args = [str(inputs / "in.fa"), "-w", "12", "-D", "-D", "--num_threads",
            "900", "--max_tables", "5000", "--table_size", "77", "-x"]
    rj, fj, rp, fp = _both(tmp_path, args)
    assert rp[0] == rj[0] == 0 and fp == fj
    head = [ln for ln in rj[2].splitlines() if " at " not in ln]
    assert [ln for ln in rp[2].splitlines() if " at " not in ln] == head
    assert head[:4] == ["Total file size %d" % (inputs / "in.fa").stat().st_size,
                        "Num threads is 1", "Num tables is 256",
                        "Table size is 77"]
    assert head[4].startswith("Words ")


def test_refuses_a_process_group(tmp_path, inputs, monkeypatch):
    """GT4_DIST_NPROCS=2 without GT4_DIST_COORD is no group, as in JAX
    (``multihost.distributed_env``): the CLI runs as one process and
    writes JAX's .list."""
    monkeypatch.setenv("GT4_DIST_NPROCS", "2")
    monkeypatch.delenv("GT4_DIST_COORD", raising=False)
    monkeypatch.setenv("GT4_TPU_MESH", "0")
    rj, fj, rp, fp = _both(tmp_path, [str(inputs / "in.fa"), "-w", "12"])
    assert rp == rj and rj[0] == 0
    assert list(fp) == ["out_12.list"] and fp == fj
    assert not torch.distributed.is_initialized()
