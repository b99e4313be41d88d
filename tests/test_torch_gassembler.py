"""Port vs JAX: gassembler end to end. The port's CLI
(``genometester4_tpu_torch.cli.gassembler``) runs its region alignment on
the CPU (``sw_fill``, the plain version of kernel C); its stdout and stderr
must be byte-identical to the JAX package's CLI on its host route
(``GT4_TPU_DEVICE_SW=0``, the native C fill, which matches the C
reference) and on its device route (the Pallas kernel in interpret mode).

The port's pipeline and CLI are its own copies (``pipelines.gassemble``,
``cli.gassembler``); the JAX package runs here only as the reference. The
read indexes are built by the JAX package's ``gmer_counter
--compile_index`` host route in a subprocess, so neither the C reference
nor jax on the device is needed."""

import contextlib
import io
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import reference_cli
from genometester4_tpu.cli import gassembler as jax_cli
from genometester4_tpu.ops import swalign as jax_sw
from genometester4_tpu.ops import swalign_pallas as jax_pallas
from genometester4_tpu.pipelines import gassemble as jax_gas
from genometester4_tpu_torch.cli import gassembler as port_cli
from genometester4_tpu_torch.ops import swalign_cuda
from genometester4_tpu_torch.pipelines import gassemble as port_gas
from genometester4_tpu_torch.tools import katk_fixture as kf

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
BASES = "ACGT"
ARGS = ["--dbi", "db.idx", "--region_file", "regions.txt", "--num_threads",
        "1"]


def _rc(s):
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


def _write_fixture(tmp, reads, dblines, regions):
    """reads.fq, db.txt and regions.txt, then db.idx through the JAX
    package's gmer_counter --compile_index host route (no jax import)."""
    with open(tmp / "reads.fq", "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@rd{i}\n{r}\n+\n{'J' * len(r)}\n")
    (tmp / "db.txt").write_text("\n".join(dblines) + "\n")
    (tmp / "regions.txt").write_text("\n".join(regions) + "\n")
    r, _ = reference_cli(tmp, "gmer_counter", kf.INDEX_ARGS,
                         GT4_TPU_COUNT_IMPL="host")
    assert r.returncode == 0, r.stderr


@pytest.fixture(scope="module")
def katk(tmp_path_factory):
    """The scenario of tests/test_gassembler.py:27-76: chr 1, 2 and X with
    a het SNV, a het 2 bp deletion, a hom SNV and a het insertion, 720
    reads of 100 bp, 15 overlapping 150 bp regions."""
    tmp = tmp_path_factory.mktemp("torch_katk")
    rng = np.random.default_rng(77)
    L = 600
    genome = {c: "".join(BASES[i] for i in rng.integers(0, 4, L))
              for c in ("1", "2", "X")}
    hap = {}
    g = genome["1"]
    hap[("1", 0)] = g
    hap[("1", 1)] = (g[:100] + ("G" if g[100] != "G" else "T")
                     + g[101:300] + g[302:])
    g = genome["2"]
    g2 = g[:150] + ("C" if g[150] != "C" else "A") + g[151:]
    hap[("2", 0)] = g2
    hap[("2", 1)] = g2[:400] + "TT" + g2[400:]
    g = genome["X"]
    hap[("X", 0)] = g[:200] + ("T" if g[200] != "T" else "G") + g[201:]
    hap[("X", 1)] = hap[("X", 0)]
    reads = []
    for seq in hap.values():
        for _ in range(120):
            start = int(rng.integers(0, len(seq) - 100 + 1))
            r = list(seq[start:start + 100])
            for _ in range(rng.poisson(0.4)):
                r[int(rng.integers(len(r)))] = BASES[int(rng.integers(4))]
            r = "".join(r)
            reads.append(_rc(r) if rng.random() < 0.5 else r)
    dblines, regions = [], []
    for chrom in ("1", "2", "X"):
        g = genome[chrom]
        for rs in range(0, L - 150 + 1, 100):
            re_ = rs + 150
            kms = [g[p:p + 25] for p in range(rs + 5, re_ - 30, 35)]
            for km in kms:
                dblines.append(f"{chrom}_{rs}_{len(dblines)}\t1\t{km}")
            regions.append(f"{chrom}\t{1000 + rs}\t{1000 + re_}\t"
                           f"{g[rs:re_]}\t" + "\t".join(kms))
    _write_fixture(tmp, reads, dblines, regions)
    yield tmp
    (tmp / "db.idx").unlink()   # 2 GiB, mostly zeros


@pytest.fixture(scope="module")
def dense_katk(tmp_path_factory):
    """An oversized region (250 bp > max_reference_length) between two
    regions of more than 200 unique reads, and a third dense region after
    them: every dense region draws glibc rand() to subsample its reads.
    No k-mer is in more than 200 reads (MAX_READS_PER_KMER: such a k-mer
    would be dropped)."""
    tmp = tmp_path_factory.mktemp("torch_katk_dense")
    rng = np.random.default_rng(99)
    L = 1100
    g = "".join(BASES[i] for i in rng.integers(0, 4, L))
    hap2 = g[:660] + ("A" if g[660] != "A" else "C") + g[661:]
    reads = []
    for seq in (g, hap2):
        for _ in range(950):
            start = int(rng.integers(0, L - 100 + 1))
            r = seq[start:start + 100]
            reads.append(_rc(r) if rng.random() < 0.5 else r)
    dblines, regions = [], []
    for rs, re_ in ((100, 250), (300, 550), (600, 750), (800, 950)):
        kms = [g[p:p + 25] for p in range(rs + 5, re_ - 30, 30)]
        for km in kms:
            dblines.append(f"1_{rs}_{len(dblines)}\t1\t{km}")
        regions.append(f"1\t{1000 + rs}\t{1000 + re_}\t{g[rs:re_]}\t"
                       + "\t".join(kms))
    _write_fixture(tmp, reads, dblines, regions)
    yield tmp
    (tmp / "db.idx").unlink()


@contextlib.contextmanager
def _in_dir(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def _run(main, tmp, args, **kw):
    """Run a CLI main in-process in ``tmp``; return (rc, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with _in_dir(tmp), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        rc = main(args, **kw)
    return rc, out.getvalue(), err.getvalue()


def run_jax_host(monkeypatch, tmp, args):
    monkeypatch.setenv("GT4_TPU_DEVICE_SW", "0")
    try:
        return _run(jax_cli.main, tmp, args)
    finally:
        monkeypatch.delenv("GT4_TPU_DEVICE_SW")


def run_port(monkeypatch, tmp, args):
    monkeypatch.delenv("GT4_TPU_DEVICE_SW", raising=False)
    return _run(port_cli.main, tmp, args, device="cpu")


@pytest.fixture
def route_counts(monkeypatch):
    """Counts of the port's device fills: multi-region launches, regions
    they held, and per-region fills (align_reads without prefetch)."""
    counts = Counter()
    multi = swalign_cuda.sw_matrices_batch_device_multi

    def counting_multi(inputs, device=None):
        counts["launches"] += 1
        counts["regions"] += len(inputs)
        return multi(inputs, device=device)

    def counting_single(ref, reads, device=None):
        counts["per_region"] += 1
        return multi([(ref, reads)], device=device)[0]

    monkeypatch.setattr(swalign_cuda, "sw_matrices_batch_device_multi",
                        counting_multi)
    monkeypatch.setattr(swalign_cuda, "sw_matrices_batch_device",
                        counting_single)
    return counts


@pytest.mark.parametrize("flags", [
    ["--coverage", "40", "--sex", "female"],
    ["--coverage", "40", "--sex", "male"],
    ["--coverage", "median", "--sex", "auto"],
    ["--coverage", "40", "--sex", "female", "--output", "all", "--counts"],
    ["--coverage", "40", "--sex", "female", "--output", "best", "--extra"],
    ["--coverage", "40", "--sex", "male", "--exome"],
    ["--coverage", "ignore", "--sex", "female"],
    ["--coverage", "40", "--sex", "female", "--alternatives"],
    ["--coverage", "40", "--sex", "female", "--min_group_size", "2",
     "--min_p", "0.5"],
])
def test_port_stdout_equals_jax_host_route(katk, monkeypatch, route_counts,
                                           flags):
    """The flag sets of tests/test_gassembler.py:94-105; every region's
    matrices come from the port's batched fill, in fewer launches than
    regions."""
    want = run_jax_host(monkeypatch, katk, ARGS + flags)
    got = run_port(monkeypatch, katk, ARGS + flags)
    assert want[0] == 0 and got == want
    n_regions = len((katk / "regions.txt").read_text().splitlines())
    assert 0 < route_counts["launches"] < n_regions
    assert route_counts["per_region"] == 0


def test_port_equals_jax_device_route_interpret(katk, monkeypatch,
                                                route_counts):
    """The JAX device route (make_sw_pallas_lanes in interpret mode) and
    the port give the same stdout, as tests/test_gassembler.py:450-479."""
    orig = jax_pallas.make_sw_pallas_lanes

    def interp(n_cap, m_cap, interpret=False):
        return orig(n_cap, m_cap, interpret=True)

    monkeypatch.setattr(jax_pallas, "make_sw_pallas_lanes", interp)
    jax_pallas._lanes_cached.cache_clear()
    args = ARGS + ["--coverage", "40", "--sex", "female", "--max_regions",
                   "3"]
    monkeypatch.setenv("GT4_TPU_DEVICE_SW", "1")
    try:
        want = _run(jax_cli.main, katk, args)
    finally:
        jax_pallas._lanes_cached.cache_clear()
    got = run_port(monkeypatch, katk, args)
    assert want[0] == 0 and got == want
    assert route_counts["regions"] >= 2
    assert route_counts["launches"] < route_counts["regions"]


@pytest.mark.parametrize("debug", [1, 2, 3])
def test_debug_stderr_parity(katk, monkeypatch, route_counts, debug):
    """-D, -D -D and -D -D -D: stdout and stderr byte-identical to the JAX
    host route. The prefetch is off under -D, so every region is filled
    by the port's per-region route (-DDD uses the JAX host fill)."""
    args = ARGS + ["--coverage", "median", "--sex", "auto"] + ["-D"] * debug
    want = run_jax_host(monkeypatch, katk, args)
    got = run_port(monkeypatch, katk, args)
    assert want[0] == 0 and got == want
    assert route_counts["launches"] == 0
    assert (route_counts["per_region"] > 0) == (debug < 3)


def test_num_threads_2_forked_workers(katk, monkeypatch):
    """--num_threads 2 forks workers, which align on the host: the port's
    stdout equals the JAX host route's single-threaded stdout."""
    want = run_jax_host(monkeypatch, katk, ARGS + ["--coverage", "40",
                                                   "--sex", "female"])
    args = ["--dbi", "db.idx", "--region_file", "regions.txt",
            "--num_threads", "2", "--coverage", "40", "--sex", "female"]
    code = ("import sys; from genometester4_tpu_torch.cli.gassembler "
            "import main; sys.exit(main(sys.argv[1:], device='cpu'))")
    env = {k: v for k, v in os.environ.items() if k != "GT4_TPU_DEVICE_SW"}
    r = subprocess.run([sys.executable, "-c", code] + args, cwd=katk,
                       capture_output=True, text=True, timeout=300,
                       env={**env, "PYTHONPATH": str(REPO)})
    assert r.returncode == 0, r.stderr
    assert r.stdout == want[1]


def _count_gathers(monkeypatch, gas):
    """Count ``gas.get_unique_reads`` calls per region (keyed by its
    k-mers); ``gas`` is the port's or the JAX package's gassemble."""
    counts = Counter()
    orig = gas.get_unique_reads

    def counting(db, files, kmers, params, max_rpk):
        counts[tuple(kmers)] += 1
        return orig(db, files, kmers, params, max_rpk)

    monkeypatch.setattr(gas, "get_unique_reads", counting)
    return counts


def test_prefetch_skips_cached_regions(dense_katk, monkeypatch,
                                       route_counts):
    """Regression: a prefetch called for an oversized region must not
    gather the cached regions after it again. The port gathers every
    region exactly once and equals the JAX host route; the JAX device
    route (its fill swapped for the native one) gathers the regions after
    the oversized one twice, so this fixture does reach the fault."""
    tmp = dense_katk
    lines = (tmp / "regions.txt").read_text().splitlines()
    kmers = [tuple(ln.split("\t")[4:]) for ln in lines]
    oversized = [int(ln.split("\t")[2]) - int(ln.split("\t")[1]) > 200
                 for ln in lines]
    assert oversized == [False, True, False, False]
    from genometester4_tpu.formats.gmerdb_binary import load_binary_db
    db = load_binary_db(str(tmp / "db.idx"), lazy=True)
    for km, big in zip(kmers, oversized):
        if not big:   # more than 200 unique reads: rand() subsampling
            assert jax_gas.region_rand_consumption(
                db, list(km), jax_gas.MAX_READS_PER_KMER) == \
                jax_gas.MAX_READS_PER_REGION

    args = ARGS + ["--coverage", "40", "--sex", "female"]
    want = run_jax_host(monkeypatch, tmp, args)
    gathers = _count_gathers(monkeypatch, port_gas)
    got = run_port(monkeypatch, tmp, args)
    assert want[0] == 0 and got == want
    assert gathers == Counter({km: 1 for km, big in zip(kmers, oversized)
                               if not big})
    assert route_counts["launches"] == 1 and route_counts["regions"] == 3

    # the fault the port avoids, in the JAX device route
    def native_multi(inputs, interpret=False):
        return [jax_sw.sw_matrices_batch(r, b) for r, b in inputs]

    monkeypatch.setattr(jax_pallas, "sw_matrices_batch_device_multi",
                        native_multi)
    monkeypatch.setenv("GT4_TPU_DEVICE_SW", "1")
    gathers = _count_gathers(monkeypatch, jax_gas)
    _run(jax_cli.main, tmp, args)
    assert [gathers[km] for km in kmers] == [1, 0, 2, 2]


def test_cli_module_usage_and_no_silent_cpu(katk):
    """``python -m genometester4_tpu_torch.cli.gassembler`` prints the JAX
    CLI's usage screen, and without CUDA it stops with an error instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    cmd = [sys.executable, "-m", "genometester4_tpu_torch.cli.gassembler"]
    r = subprocess.run(cmd + ["-h"], capture_output=True, text=True,
                       timeout=120, env=env)
    want = subprocess.run(
        [sys.executable, "-m", "genometester4_tpu.cli.gassembler", "-h"],
        capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == want.returncode == 0
    assert r.stdout == want.stdout and "Usage" in r.stdout
    r = subprocess.run(cmd + ARGS + ["--coverage", "40"], cwd=katk,
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode != 0 and "CUDA" in r.stderr and r.stdout.count(
        "\n") <= 1


def test_cli_imports_torch_only_to_build_an_assembler(katk, monkeypatch):
    """The port's CLI in a fresh process: ``-h`` and a bad flag leave torch
    out of ``sys.modules``; a run on the CPU imports it and prints the JAX
    host route's stdout."""
    code = ("import sys\n"
            "from genometester4_tpu_torch.cli.gassembler import main\n"
            "rc = main(sys.argv[1:], device='cpu')\n"
            "sys.stderr.write('torch imported: %s\\n'"
            " % ('torch' in sys.modules))\n"
            "sys.exit(rc)\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    env.pop("GT4_TPU_DEVICE_SW", None)

    def port(args):
        return subprocess.run([sys.executable, "-c", code, *args], cwd=katk,
                              capture_output=True, text=True, timeout=300,
                              env=env)

    r = port(["-h"])
    assert r.returncode == 0 and "Usage" in r.stdout
    assert r.stderr.endswith("torch imported: False\n")
    r = port(["--dbi"])
    assert r.returncode == 1 and "Usage" in r.stderr
    assert r.stderr.endswith("torch imported: False\n")
    args = ARGS + ["--coverage", "40"]
    want = run_jax_host(monkeypatch, katk, args)
    r = port(args)
    assert want[0] == r.returncode == 0 and r.stdout == want[1]
    assert r.stderr.endswith("torch imported: True\n")


def test_smoke_katk_fixture_small(tmp_path, monkeypatch, route_counts):
    """The KATK fixture of chip_smoke.py's katk phase at 12 regions,
    through the same set-up and oracle, with the port on the CPU: the two
    dense regions subsample, the oversized one is skipped, stdout and
    stderr equal the JAX host route's."""
    inputs = kf.write_katk_fixture(str(tmp_path), seed=3, n_regions=12)
    assert len(inputs) == 12
    r, _ = reference_cli(
        str(tmp_path), "gmer_counter", kf.INDEX_ARGS,
        GT4_TPU_COUNT_IMPL="host")
    assert r.returncode == 0, r.stderr
    try:
        lines = (tmp_path / "regions.txt").read_text().splitlines()
        from genometester4_tpu.formats.gmerdb_binary import load_binary_db
        db = load_binary_db(str(tmp_path / "db.idx"), lazy=True)
        cons = [jax_gas.region_rand_consumption(
            db, ln.split("\t")[4:], jax_gas.MAX_READS_PER_KMER)
            for ln in lines]
        assert cons[0] == cons[2] == jax_gas.MAX_READS_PER_REGION
        assert int(lines[1].split("\t")[2]) - int(lines[1].split("\t")[1]) \
            > 200
        want, wall = reference_cli(
            str(tmp_path), "gassembler", kf.ARGS,
            GT4_TPU_DEVICE_SW="0")
        assert want.returncode == 0 and wall > 0
        got = run_port(monkeypatch, tmp_path, kf.ARGS)
        assert got == (0, want.stdout.decode(), want.stderr.decode())
        assert b"too big" in want.stderr
        assert 0 < route_counts["launches"] < len(lines)
    finally:
        (tmp_path / "db.idx").unlink()


@pytest.mark.parametrize("flags", [
    ["--coverage", "40", "--sex", "female"],
    ["--coverage", "median", "--sex", "auto", "--output", "all", "--extra"],
])
def test_port_host_route_equals_jax_host_route(katk, monkeypatch,
                                               route_counts, flags):
    """GT4_TPU_DEVICE_SW=0 through the port's CLI: its own host route (the
    native C fill, traceback and filters per region) prints what the JAX
    host route prints, and no device fill runs."""
    want = run_jax_host(monkeypatch, katk, ARGS + flags)
    monkeypatch.setenv("GT4_TPU_DEVICE_SW", "0")
    got = _run(port_cli.main, katk, ARGS + flags, device="cpu")
    assert want[0] == 0 and got == want
    assert route_counts["launches"] == route_counts["per_region"] == 0


def _print_finished(gas, cli, output, second_block):
    """What OutputQueue.flush prints for one finished block on chr 1 over
    [100, 103) with calls at 100, 101 and 103; with ``second_block`` an
    empty finished block on chr 2 sits beside it, so the block goes
    through the general loop instead of the single-block fast path."""
    def call(pos):
        return gas.Call(pos=pos, ref=gas.A, cov=12,
                        counts=np.zeros(gas.GAP + 1, np.int64),
                        nucl=(gas.A, gas.C), poly=1, p=0.9, q=0.99,
                        p_det=0.99)

    out = io.StringIO()
    oq = cli.OutputQueue(out, gas.Params(output=output))
    oq.finished = [gas.CallBlock(1, 100, 103, False,
                                 calls=[call(100), call(101), call(103)])]
    if second_block:
        oq.finished.append(gas.CallBlock(2, 0, 1, False))
    oq.flush()
    assert oq.finished == []
    return out.getvalue()


@pytest.mark.parametrize("output", [0, 1])
def test_single_block_fast_path_skips_calls_past_end(output):
    """The port's single-block fast path of ``_print_poly_best`` prints what
    its general loop prints for a block holding a call at pos >= end: the
    two calls inside [start, end), not the one at 103.

    The JAX package (``genometester4_tpu/cli/gassembler.py:246-298``) walks
    ``cb_f.calls`` in that fast path without the bound its general loop
    keeps, so on the same input its fast path prints three lines and its
    general loop two; this test shows that too."""
    port = [_print_finished(port_gas, port_cli, output, second)
            for second in (False, True)]
    jax = [_print_finished(jax_gas, jax_cli, output, second)
           for second in (False, True)]
    assert port[0] == port[1] == jax[1]
    assert port[0].count("\n") == 2 and "\t103\t" not in port[0]
    assert jax[0].count("\n") == 3 and "\t103\t" in jax[0]


@pytest.fixture(scope="module")
def long_reads(tmp_path_factory):
    """The long-read fixture of chip_smoke.py's longread phase at three
    regions: reads of 1,500-1,700 bp, those past --max_read_length 1,600
    cut with a WARNING, so the fill sees reads past the 1,472 columns a
    lane of 32 x 46 once covered."""
    tmp = tmp_path_factory.mktemp("torch_long_reads")
    kf.write_long_read_fixture(str(tmp), seed=1600, n_regions=3)
    r, _ = reference_cli(tmp, "gmer_counter", kf.INDEX_ARGS,
                         GT4_TPU_COUNT_IMPL="host")
    assert r.returncode == 0, r.stderr
    yield tmp
    (tmp / "db.idx").unlink()


def test_long_reads_past_old_lane_width(long_reads, monkeypatch,
                                        route_counts):
    """--max_read_length 1,600 on reads of up to 1,700 bp: the port's
    batched fill (sw_fill here, kernel C on the card) takes reads 1,600
    columns wide, and stdout and stderr (the truncation WARNINGs included)
    equal the JAX host route's. Windows of at least 16 reads keep the
    plain fill's memory small; the port's own host route agrees too."""
    args = kf.LONG_ARGS
    want = run_jax_host(monkeypatch, long_reads, args)
    assert want[0] == 0 and "WARNING: Read is longer" in want[2]
    assert want[1].count("\n") >= 3
    monkeypatch.setenv("GT4_TPU_SW_BATCH_LANES", "16")
    got = run_port(monkeypatch, long_reads, args)
    assert got == want
    assert 0 < route_counts["launches"] and route_counts["per_region"] == 0
    monkeypatch.setenv("GT4_TPU_DEVICE_SW", "0")
    assert _run(port_cli.main, long_reads, args, device="cpu") == want
