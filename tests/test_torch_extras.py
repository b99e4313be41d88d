"""Port vs JAX: the six extra CLIs (gdistribution, kmer_predictor,
make_union/make_intersection, generate_vcf, katk2vcf and the five stages
of repeats) on the same seeded inputs, each package's ``main`` in its own
empty directory: exit codes, stdout, stderr and every file written must be
equal. The inputs are those of ``tests/test_gdistribution.py``,
``tests/test_kmer_predictor.py``, ``tests/test_scripts.py`` and
``tests/fuzz_patterns/fuzz_scripts.py``; the JAX CLIs are the oracle, not
the reference programs or Perl scripts. ``make_union`` runs the port's
glistcompare with ``device="cpu"`` (its PyTorch ops), the JAX package's
its host route; ``generate_vcf`` runs with ``time.localtime`` fixed."""

import contextlib
import io
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from tests.test_kmer_predictor import DELTA, _make_inputs
from genometester4_tpu.cli import gdistribution as jax_gdist
from genometester4_tpu.cli import generate_vcf as jax_gvcf
from genometester4_tpu.cli import katk2vcf as jax_katk
from genometester4_tpu.cli import kmer_predictor as jax_kpred
from genometester4_tpu.cli import make_union as jax_union
from genometester4_tpu.cli import repeats as jax_repeats
from genometester4_tpu_torch.cli import gdistribution as port_gdist
from genometester4_tpu_torch.cli import generate_vcf as port_gvcf
from genometester4_tpu_torch.cli import katk2vcf as port_katk
from genometester4_tpu_torch.cli import kmer_predictor as port_kpred
from genometester4_tpu_torch.cli import make_union as port_union
from genometester4_tpu_torch.cli import repeats as port_repeats
from genometester4_tpu_torch.formats.list_format import write_list

REPO = Path(__file__).resolve().parent.parent
B = "ACGT"


def _run(fn, args, cwd, **kw):
    out, err = io.StringIO(), io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = fn(list(args), **kw)
    finally:
        os.chdir(old)
    return rc, out.getvalue(), err.getvalue()


def _tree(d):
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def _both(tmp_path, jax_fn, port_fn, args, **port_kw):
    """(rc, stdout, stderr) and the files written, of both packages."""
    jd, pd = tmp_path / "jax", tmp_path / "port"
    jd.mkdir(parents=True)
    pd.mkdir(parents=True)
    rj = _run(jax_fn, args, jd)
    rp = _run(port_fn, args, pd, **port_kw)
    return rj, _tree(jd), rp, _tree(pd)


def _assert_same(tmp_path, jax_fn, port_fn, args, rc=0, **port_kw):
    rj, fj, rp, fp = _both(tmp_path, jax_fn, port_fn, args, **port_kw)
    assert rj[0] == rc
    assert rp == rj and fp == fj
    return rj, fj


# ------------------------------------------------------------ gdistribution

def _gdist_lists(tmp_path, seed):
    rng = np.random.default_rng(seed)
    paths = []
    for name, n in (("a", 800), ("b", 600)):
        w = np.unique(rng.integers(0, 4000, size=n).astype(np.uint64))
        c = rng.integers(1, 50, size=len(w)).astype(np.uint32)
        paths.append(str(tmp_path / f"{name}_6.list"))
        write_list(paths[-1], 6, w, c)
    return paths


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_gdistribution_equal(tmp_path, seed):
    a, b = _gdist_lists(tmp_path, seed)
    (rc, out, _), _ = _assert_same(tmp_path, jax_gdist.main, port_gdist.main,
                                   [a, b])
    assert out.count("\n") > 5


@pytest.mark.parametrize("case", ["above", "list2 only", "usage",
                                  "missing", "not a list"])
def test_gdistribution_edges_equal(tmp_path, case):
    """LIST1 above max(LIST2) (Size 0, no sort), words of LIST2 alone, the
    usage error, a missing file and a file that is no list."""
    p1, p2 = str(tmp_path / "a_6.list"), str(tmp_path / "b_6.list")
    if case == "above":
        write_list(p1, 6, np.array([100, 101], np.uint64),
                   np.array([1, 1], np.uint32))
        write_list(p2, 6, np.array([5, 7], np.uint64),
                   np.array([3, 4], np.uint32))
    else:
        write_list(p1, 6, np.array([10], np.uint64), np.array([1], np.uint32))
        write_list(p2, 6, np.array([5, 10, 20], np.uint64),
                   np.array([3, 7, 9], np.uint32))
    (tmp_path / "junk").write_bytes(b"\0" * 64)
    args, rc = {"above": ([p1, p2], 0), "list2 only": ([p1, p2], 0),
                "usage": ([p1], 1),
                "missing": ([p1, str(tmp_path / "nope.list")], 1),
                "not a list": ([str(tmp_path / "junk"), p2], 1)}[case]
    _assert_same(tmp_path, jax_gdist.main, port_gdist.main, args, rc)


# ----------------------------------------------------------- kmer_predictor

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kmer_predictor_equal(tmp_path, seed):
    rng = np.random.default_rng(seed)
    n_lists = int(rng.integers(DELTA + 2, DELTA + 12))
    inputs = tmp_path / "in"
    inputs.mkdir()
    _make_inputs(inputs, rng, n_lists)
    (rc, _, err), files = _assert_same(
        tmp_path, jax_kpred.main, port_kpred.main,
        ["--kmers", str(inputs / "panel_8.list"), "--lists",
         str(inputs / "lists.txt"), "--write_coefficients", "coeffs.txt"])
    assert err.count("\n") == n_lists and "coeffs.txt" in files


@pytest.mark.parametrize("extra,rc", [
    (["--max_kmers", "37", "--write_coefficients", "c.txt"], 0),
    (["-D"], 0), (["-v"], 0), (["-h"], 0), (["--bogus"], 1),
    (["--max_kmers"], 1), (["--max_kmers", "x"], 1), (None, 1),
    ("missing list", 1)])
def test_kmer_predictor_options_equal(tmp_path, extra, rc):
    rng = np.random.default_rng(7)
    inputs = tmp_path / "in"
    inputs.mkdir()
    _make_inputs(inputs, rng, DELTA + 5)
    args = ["--kmers", str(inputs / "panel_8.list"), "--lists",
            str(inputs / "lists.txt")]
    if extra is None:
        args = args[:2]
    elif extra == "missing list":
        (inputs / "lists.txt").write_text(
            "x\t%s\t10.0\n" % (inputs / "nope_8.list"))
    else:
        args += extra
    _assert_same(tmp_path, jax_kpred.main, port_kpred.main, args, rc)


# ---------------------------------------------- make_union/make_intersection

@pytest.fixture
def jax_host_setops(monkeypatch):
    """The JAX CLIs' glistcompare on its host route (no jax); the port's
    runs its device route with device="cpu"."""
    def run(fn):
        def wrapped(args):
            monkeypatch.setenv("GT4_TPU_SETOPS_IMPL", "host")
            try:
                return fn(args)
            finally:
                monkeypatch.delenv("GT4_TPU_SETOPS_IMPL")
        return wrapped
    monkeypatch.delenv("GT4_TPU_SETOPS_IMPL", raising=False)
    return run


@pytest.mark.parametrize("n_lists", [2, 3, 4, 5])
@pytest.mark.parametrize("which", ["union", "intersection"])
def test_make_union_tree_equal(tmp_path, jax_host_setops, n_lists, which):
    """The pairwise tree: round directories, copy_ carry-overs, the
    glistcompare lines on stderr and the final list."""
    rng = np.random.default_rng(n_lists)
    inputs = tmp_path / "in"
    inputs.mkdir()
    base = np.unique(rng.integers(0, 1 << 20, 3000).astype(np.uint64))
    names = []
    for i in range(n_lists):
        w = base[rng.random(len(base)) < 0.7]
        names.append(str(inputs / f"l{i}_10.list"))
        write_list(names[-1], 10, w,
                   rng.integers(1, 9, len(w)).astype(np.uint32))
    jax_fn = (jax_union.main_union if which == "union"
              else jax_union.main_intersection)
    port_fn = (port_union.main_union if which == "union"
               else port_union.main_intersection)
    _, files = _assert_same(tmp_path, jax_host_setops(jax_fn), port_fn,
                            names, device="cpu")
    op = "union" if which == "union" else "intrsec"
    # two lists take one round and stay in its directory
    final = f"{op}_10_{op}.list" if n_lists > 2 else f"{op}_1/0_1_10_{op}.list"
    assert len(files[final]) > 48


def test_make_union_usage_equal(tmp_path, jax_host_setops):
    _assert_same(tmp_path, jax_host_setops(jax_union.main_union),
                 port_union.main_union, ["-u", "only_10.list"], 1,
                 device="cpu")


# ------------------------------------------------------------- generate_vcf

@pytest.fixture
def fixed_clock(monkeypatch):
    t = time.struct_time((2024, 2, 29, 12, 0, 0, 3, 60, 0))
    monkeypatch.setattr(time, "localtime", lambda *a: t)


CALLS = {
    "male": ("#gmer_counter version 4.2.16 (stable)\n#Sex\tM\n"
             "1:12345:rs111:A/G\tAB\t0.99\t10\t12\n"
             "2:777:rs222:C/T\tAA\t1.00\t20\t0\n"
             "X:5555:rs333:G/C\tB\t0.98\t1\t15\n"
             "Y:123:rs444:T/A\tA\t0.97\t9\t0\n"),
    "female": ("#Sex\tF\n#comment\n"
               "X:5555:rs333:G/C\tAB\t0.98\t7\t15\n"
               "3:1:rs5:G/T\tBB\t0.91\t0\t30\n"
               "MT:16:rs6:A/C\tAA\t0.5\t3\t0\n"),
}


@pytest.mark.parametrize("case", sorted(CALLS))
def test_generate_vcf_equal(tmp_path, fixed_clock, case):
    calls = tmp_path / "calls.txt"
    calls.write_text(CALLS[case])
    (_, out, _), _ = _assert_same(tmp_path, jax_gvcf.main, port_gvcf.main,
                                  [str(calls)])
    assert "##fileDate=20240229\n" in out


def test_generate_vcf_usage_equal(tmp_path, fixed_clock):
    _assert_same(tmp_path, jax_gvcf.main, port_gvcf.main, [], 1)


# ----------------------------------------------------------------- katk2vcf

def _chrdir(path, seqs):
    path.mkdir()
    for name, seq in seqs.items():
        (path / f"{name}.fa").write_text(
            f">{name}\n" + "\n".join(seq[i:i + 60]
                                     for i in range(0, len(seq), 60)) + "\n")


def _alt(b):
    return "G" if b != "G" else "T"


HEAD = ["#KATK version: 4.2.16",
        "CHR\tPOS\tSUB\tREF\tCOV\tCALL\tCLASS\tP\tPMUT"]


def _katk_case(case, rng):
    """(chromosome sequences, call lines) of the test_scripts.py cases."""
    if case == "identical":
        seq = "".join(B[i] for i in rng.integers(0, 4, 2000))
        alt = "G" if seq[149] != "G" else "T"
        return {"1": seq}, HEAD + [
            f"1\t100\t0\t{seq[99]}\t30\tNC\t0\t0.5\t0.4",
            f"1\t150\t0\t{seq[149]}\t30\t{seq[149]}{alt}\tS\t0.99\t0.97",
            "1\t200\t1\t-\t28\t-A\tI\t0.98\t0.9",
            "1\t200\t2\t-\t28\t-A\tI\t0.98\t0.9",
            f"1\t300\t0\t{seq[299]}\t30\t{seq[299]}-\tD\t0.97\t0.9",
            f"1\t400\t0\t{seq[399]}\t25\t{seq[399]}{seq[399]}\t0\t0.99"
            "\t0.99"]
    if case == "cross chromosome flush":
        seqs = {cn: "".join(B[i] for i in rng.integers(0, 4, 1500))
                for cn in ("1", "2")}
        s1, s2 = seqs["1"], seqs["2"]
        return seqs, HEAD + [
            f"2\t600\t0\t{s2[599]}\t30\t{s2[599]}-\tD\t0.9\t0.9",
            f"1\t300\t0\t{s1[299]}\t30\t{s1[299]}{_alt(s1[299])}\tS"
            "\t0.9\t0.9",
            f"1\t500\t0\t{s1[499]}\t30\t{s1[499]}{_alt(s1[499])}\tS"
            "\t0.9\t0.9"]
    if case == "degenerate positions":
        seq = "".join(B[i] for i in rng.integers(0, 4, 200))
        return {"1": seq}, HEAD + [
            "1\t12x\t0\t-\t28\t-A\tI\t0.98\t0.9",
            "1\t12x\t0\t-\t28\t-A\tI\t0.98\t0.9",
            f"1\t30\t0\t{seq[29]}\t30\t{seq[29]}{_alt(seq[29])}\tS\t0.9\t0.9",
            f"1\t0junk\t0\t{seq[199]}\t30\t{seq[199]}{_alt(seq[199])}\tS"
            "\t0.9\t0.9",
            f"1\t80\t0\t{seq[79]}\t30\t{seq[79]}{_alt(seq[79])}\tS\t0.9\t0.9"]
    if case == "stale ajut":
        seq = "".join(B[i] for i in rng.integers(0, 4, 100))
        return {"1": seq}, HEAD + [
            f"1\t1\t0\t{seq[0]}\t30\t{seq[0]}-\tD\t0.9\t0.9",
            f"1\t60\t0\t{seq[59]}\t30\t{seq[59]}{_alt(seq[59])}\tS\t0.9\t0.9",
            f"1\t80\t0\t{seq[79]}\t30\t{seq[79]}{_alt(seq[79])}\tS\t0.9\t0.9"]
    # fuzz_scripts.trial_katk2vcf's grammar: every class at random sites
    names = ["1", "2", "X"][:1 + case % 3]
    seqs = {cn: "".join(B[i] for i in rng.integers(0, 4, int(
        rng.integers(600, 2500)))) for cn in names}
    lines = list(HEAD)
    for cn, seq in seqs.items():
        for pos in sorted(rng.choice(np.arange(100, len(seq) - 100),
                                     int(rng.integers(1, 9)),
                                     replace=False)):
            base = seq[pos - 1]
            alt = _alt(base)
            cov, p = int(rng.integers(5, 60)), "%.2f" % rng.uniform(0.5, 1)
            kind = ["NC", "S", "I", "D", "HOM"][int(rng.integers(0, 5))]
            if kind == "NC":
                lines.append(f"{cn}\t{pos}\t0\t{base}\t{cov}\tNC\t0\t{p}\t0.4")
            elif kind == "S":
                lines.append(f"{cn}\t{pos}\t0\t{base}\t{cov}\t{base}{alt}"
                             f"\tS\t{p}\t0.5")
            elif kind == "I":
                for sub in range(1, int(rng.integers(2, 4))):
                    lines.append(f"{cn}\t{pos}\t{sub}\t-\t{cov}\t-"
                                 f"{B[int(rng.integers(0, 4))]}\tI\t{p}\t0.6")
            elif kind == "D":
                lines.append(f"{cn}\t{pos}\t0\t{base}\t{cov}\t{base}-\tD"
                             f"\t{p}\t0.7")
            else:
                lines.append(f"{cn}\t{pos}\t0\t{base}\t{cov}\t{base}{base}"
                             f"\t0\t{p}\t0.8")
    return seqs, lines


@pytest.mark.parametrize("case", ["identical", "cross chromosome flush",
                                  "degenerate positions", "stale ajut",
                                  0, 1, 2, 3, 4, 5])
def test_katk2vcf_equal(tmp_path, rng, case):
    seqs, lines = _katk_case(case, rng)
    _chrdir(tmp_path / "chr", seqs)
    (tmp_path / "calls.txt").write_text("\n".join(lines) + "\n")
    (_, out, _), _ = _assert_same(
        tmp_path, jax_katk.main, port_katk.main,
        ["--chr_dir", str(tmp_path / "chr"), str(tmp_path / "calls.txt")])
    assert out.startswith("##fileformat=VCFv4.0\n")


def test_katk2vcf_usage_equal(tmp_path):
    _assert_same(tmp_path, jax_katk.main, port_katk.main, ["calls.txt"], 1)


# ------------------------------------------------------------------ repeats

def _repeat_inputs(path, seed):
    """fuzz_scripts.trial_repeats' inputs: a genome with a planted repeat
    motif, its over-represented 16-mer table, and (after find_regions) a
    BLAST table over the regions and a chromosome hit table."""
    rng = np.random.default_rng(seed)

    def bases(n):
        return "".join(B[i] for i in rng.integers(0, 4, n))
    motif = bases(int(rng.integers(40, 200)))
    parts = []
    for _ in range(int(rng.integers(3, 9))):
        parts.append(bases(int(rng.integers(100, 800))))
        if rng.random() < 0.75:
            parts.append(motif)
    parts.append(motif)
    seq = "".join(parts)
    (path / "g.fa").write_text(f">g{seed} extra tokens\n{seq}\n")
    counts = {}
    for i in range(len(seq) - 16):
        counts[seq[i:i + 16]] = counts.get(seq[i:i + 16], 0) + 1
    (path / "over.txt").write_text("".join(
        f"{w}\t{c}\n" for w, c in counts.items()
        if c >= 2 or rng.random() < 0.001))
    return rng


def _blast_tables(path, rng, regions_text):
    rids, rlens = [], {}
    for ln in regions_text.splitlines():
        if ln.startswith(">"):
            rids.append(ln[1:].split()[0])
        elif rids:
            rlens[rids[-1]] = len(ln)
    rows = []
    for _ in range(int(rng.integers(0, 4 * len(rids) + 4)) if rids else 0):
        a, b = rng.choice(rids), rng.choice(rids)
        la, lb = rlens[a], rlens[b]
        if rng.random() < 0.7:
            lb = max(1, int(la * (0.9 + 0.2 * rng.random())))
        rows.append("%s\t%d\t%s\t%d\t%.1f\t%d\n" % (
            a, la, b, lb, 80 + 20 * rng.random(),
            max(1, int(la * (0.85 + 0.3 * rng.random())))))
    (path / "blast.txt").write_text("".join(rows))
    chrom = []
    for rid in rids:
        for _ in range(int(rng.integers(0, 4))):
            chrom.append(f"{rid}\t{rng.choice(['chr1', 'chr2', 'chrX'])}"
                         "\textra\tcols\n")
    chrom.append("lonely_token\n")
    (path / "chroms.txt").write_text("".join(chrom))
    return len(rids)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_repeats_stages_equal(tmp_path, seed):
    """The five stages in a chain, each stage on the JAX stage's output:
    stdout, stderr and rc equal."""
    inp = tmp_path / "in"
    inp.mkdir()
    rng = _repeat_inputs(inp, seed)
    max_len = ["3000"] if seed % 2 else []
    (_, regions, _), _ = _assert_same(
        tmp_path / "find", jax_repeats.main, port_repeats.main,
        ["find_regions", str(inp / "over.txt"), str(inp / "g.fa"),
         str(20 + 30 * seed), ["1", "1.5", "2", "2.0"][seed]] + max_len)
    assert regions.startswith(">Repeat_1 ")
    (inp / "regions.fa").write_text(regions)
    _blast_tables(inp, rng, regions)
    (_, groups, _), _ = _assert_same(
        tmp_path / "collate", jax_repeats.main, port_repeats.main,
        ["collate_repeats", str(inp / "blast.txt"), str(inp / "regions.fa")])
    (inp / "groups.txt").write_text(groups)
    for stage, args in (
            ("filter_collated", [str(inp / "groups.txt"), str(seed % 3)]),
            ("unique", [str(inp / "regions.fa"), str(inp / "blast.txt")]),
            ("filter_final", [str(inp / "regions.fa"),
                              str(inp / "chroms.txt"), "chr1"])):
        _assert_same(tmp_path / stage, jax_repeats.main, port_repeats.main,
                     [stage, *args])


def test_repeats_usage_equal(tmp_path):
    for i, args in enumerate(([], ["no_such_stage"])):
        _assert_same(tmp_path / str(i), jax_repeats.main, port_repeats.main,
                     args, 1)


# ---------------------------------------------------------------- python -m

@pytest.mark.parametrize("tool", ["gdistribution", "kmer_predictor",
                                  "make_union", "generate_vcf", "katk2vcf",
                                  "repeats"])
def test_runs_as_a_module(tmp_path, tool):
    """``python -m genometester4_tpu_torch.cli.<tool>`` with no arguments:
    the JAX CLI's usage error, exit code and streams."""
    runs = [subprocess.run([sys.executable, "-m", f"{pkg}.cli.{tool}"],
                           capture_output=True, timeout=120, cwd=tmp_path,
                           env={**os.environ, "PYTHONPATH": str(REPO)})
            for pkg in ("genometester4_tpu", "genometester4_tpu_torch")]
    assert runs[0].returncode != 0
    assert ((runs[1].returncode, runs[1].stdout, runs[1].stderr)
            == (runs[0].returncode, runs[0].stdout, runs[0].stderr))
