"""The port stands alone: ``genometester4_tpu_torch`` imports torch and its
own modules, never jax and nothing of the JAX package ``genometester4_tpu``.

Statically: every ``.py`` under the package is walked with ``ast`` for an
import of either (at the top or inside a function) and for a string that
runs one with ``-m`` or ``-c``. At run time: a fresh process imports every
module of the port, runs its ``make_list`` on a small FASTA and its
gassembler CLI on a small KATK fixture, its glistmaker CLI (``.list`` and
``--index``), its glistcompare CLI (two sources and three), its glistquery
CLI (a dump, ``-s``, ``-l``), its gmer_caller CLI and its six extra CLIs
(gdistribution, kmer_predictor, make_union and make_intersection,
generate_vcf, katk2vcf, repeats), all on the CPU, and then finds neither
package in ``sys.modules``; two more form a process group
(``parallel.multihost``) and run glistmaker and glistcompare on it, with
the same finding. Subprocesses check that the argument errors of
the list CLIs, glistcompare's numpy-free fast paths, glistquery's
statistics and host routes, gmer_caller's host route and five of the
extra CLIs (all but make_union, which runs glistcompare's device route)
import no torch. The read index of the fixture is the
one set-up step that runs the JAX package (its ``gmer_counter
--compile_index`` host route, in a subprocess of its own)."""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "genometester4_tpu_torch"
FORBIDDEN = ("genometester4_tpu", "jax", "jaxlib")
# a module name run by ``python -m`` or imported by ``python -c`` code
RUNS_FORBIDDEN = re.compile(
    r"(-m\s+|import\s+|from\s+)(genometester4_tpu|jax)(\.|\s|$)")


def _port_files():
    return sorted(p for p in PORT.rglob("*.py")
                  if "_build" not in p.parts)


def _module_names():
    return [".".join(p.relative_to(REPO).with_suffix("").parts)
            .removesuffix(".__init__") for p in _port_files()]


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _violations(path: Path) -> list:
    tree = ast.parse(path.read_text(), str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names
                      if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and _forbidden(node.module or ""):
                found.append((node.lineno, node.module))
        elif isinstance(node, ast.Call):
            # importlib.import_module("...") / __import__("...")
            fn = node.func
            name = getattr(fn, "attr", getattr(fn, "id", ""))
            if (name in ("import_module", "__import__") and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                    and _forbidden(node.args[0].value)):
                found.append((node.lineno, node.args[0].value))
    # strings handed to a subprocess: "-m", "<module>" argument pairs, and
    # code for -c (any string but a docstring that imports one)
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef))
            and n.body and isinstance(n.body[0], ast.Expr)}
    consts = [n for n in ast.walk(tree)
              if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    for a, b in zip(consts, consts[1:]):
        if a.value == "-m" and _forbidden(b.value):
            found.append((b.lineno, f"-m {b.value}"))
    found += [(c.lineno, c.value.strip()[:60]) for c in consts
              if id(c) not in docs and RUNS_FORBIDDEN.search(c.value)]
    return found


def test_static_walk_finds_every_kind_of_forbidden_import(tmp_path):
    """The walker itself: each form it must catch, and none of the forms
    a docstring or the port's own imports take."""
    bad = tmp_path / "bad.py"
    bad.write_text(
        "import jax\n"
        "import genometester4_tpu.ops.encode as e\n"
        "from genometester4_tpu.cli import gassembler\n"
        "def f():\n"
        "    from jax import numpy\n"
        "    import importlib\n"
        "    importlib.import_module('genometester4_tpu.io.fasta')\n"
        "    subprocess.run([sys.executable, '-m',\n"
        "                    'genometester4_tpu.cli.gmer_counter'])\n"
        "    code = 'import sys\\n'\n"
        "    code += 'from genometester4_tpu.cli.x import main\\n'\n")
    assert len(_violations(bad)) == 7
    good = tmp_path / "good.py"
    good.write_text(
        '"""Port of ``genometester4_tpu/ops/encode.py`` (the JAX package\n'
        'imports jax there)."""\n'
        "import genometester4_tpu_torch.ops.encode\n"
        "from genometester4_tpu_torch.utils import native\n"
        "x = 'genometester4_tpu/pipelines/gassemble.py:657'\n")
    assert _violations(good) == []


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 20
    bad = {str(p.relative_to(REPO)): v for p in files
           if (v := _violations(p))}
    assert bad == {}


_RUN = r'''
import contextlib, importlib, io, json, os, sys
names = json.loads(sys.argv[1])
for name in names:
    importlib.import_module(name)
from genometester4_tpu_torch.pipelines.listmaker import make_list
hdr = make_list([sys.argv[2]], 11, sys.argv[3], device="cpu")
from genometester4_tpu_torch.cli.gassembler import main
from genometester4_tpu_torch.tools import katk_fixture as kf
out, err = io.StringIO(), io.StringIO()
os.chdir(sys.argv[4])
with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
    rc = main(kf.ARGS, device="cpu")
from genometester4_tpu_torch.cli.glistcompare import main as glistcompare
from genometester4_tpu_torch.cli.glistmaker import main as glistmaker
fa = sys.argv[2]
with contextlib.redirect_stdout(io.StringIO()), \
        contextlib.redirect_stderr(io.StringIO()):
    rcs = [glistmaker([fa, "-w", "11", "-o", "a"], device="cpu"),
           glistmaker([fa, "-w", "11", "-o", "b", "--index"], device="cpu"),
           glistcompare(["a_11.list", "b_11.index", "-u", "-i", "-d"],
                        device="cpu"),
           glistcompare(["a_11.list", "a_11.list", "b_11.index", "-u"],
                        device="cpu")]
from genometester4_tpu_torch.cli.glistquery import main as glistquery
from genometester4_tpu_torch.cli.gmer_caller import main as gmer_caller
with open("calls.txt", "w") as f:
    f.write("".join(f"{1 + i % 22}_m{i}\t2\t{30 - i % 31}\t{i % 29}\n"
                    for i in range(600)))
q = io.StringIO()
with contextlib.redirect_stdout(q), \
        contextlib.redirect_stderr(io.StringIO()):
    rcs += [glistquery(["a_11.list"], device="cpu"),
            glistquery(["a_11.list", "-s", fa], device="cpu"),
            glistquery(["b_11.index", "-l", "a_11.list"], device="cpu"),
            gmer_caller(["--runs", "0", "--coverage", "30", "calls.txt"],
                        device="cpu")]
from genometester4_tpu_torch.cli import (gdistribution, generate_vcf,
                                         katk2vcf, kmer_predictor,
                                         make_union, repeats)
with open("lists.txt", "w") as f:
    f.write("".join(f"s{i}\ta_11.list\t{i}\n" for i in range(22)))
with open("calls.vcf.txt", "w") as f:
    f.write("#Sex\tF\n1:5:rs1:A/G\tAB\t0.9\t3\t4\n")
os.makedirs("chr", exist_ok=True)
with open("chr/1.fa", "w") as f:
    f.write(">1\n" + "ACGT" * 100 + "\n")
with open("katk.txt", "w") as f:
    f.write("1\t10\t0\tG\t30\tGA\tS\t0.9\t0.9\n"
            "1\t20\t0\tA\t30\tAC\tS\t0.9\t0.9\n")
with open("over.txt", "w") as f:
    f.write("ACGTACGTACGTACGT\t5\n")
x = io.StringIO()
with contextlib.redirect_stdout(x), \
        contextlib.redirect_stderr(io.StringIO()):
    rcs += [gdistribution.main(["a_11.list", "b_11.index"]),
            kmer_predictor.main(["--kmers", "a_11.list", "--lists",
                                 "lists.txt"]),
            make_union.main_union(["a_11.list", "a_11.list", "a_11.list"],
                                  device="cpu"),
            make_union.main_intersection(["a_11.list", "a_11.list"],
                                         device="cpu"),
            generate_vcf.main(["calls.vcf.txt"]),
            katk2vcf.main(["--chr_dir", "chr", "katk.txt"]),
            repeats.main(["find_regions", "over.txt", fa, "20", "1"])]
rc = (rc or any(rcs) or not os.path.exists("out_11_union.list")
      or not os.path.exists("union_11_union.list")
      or q.getvalue().count("\n") < 10000 or x.getvalue().count("\n") < 10)
mods = sorted(m for m in sys.modules
              if m.split(".")[0] in ("genometester4_tpu", "jax", "jaxlib"))
print(json.dumps({"n_words": hdr.n_words, "rc": rc,
                  "lines": out.getvalue().count("\n"), "modules": mods}))
'''


def test_port_runs_without_the_jax_package(tmp_path):
    """Every module imported, make_list, the gassembler CLI, the list CLIs,
    gmer_caller and the six extra CLIs run on the CPU in a fresh process:
    no module of jax or of the JAX package is loaded at the end."""
    from chip_smoke import reference_cli
    from genometester4_tpu_torch.tools import katk_fixture as kf
    rng = np.random.default_rng(12)
    fa = tmp_path / "in.fa"
    seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), 5000,
                     p=[0.24, 0.25, 0.25, 0.25, 0.01])
    fa.write_bytes(b">a\n" + seq.tobytes() + b"\n")
    katk = tmp_path / "katk"
    katk.mkdir()
    kf.write_katk_fixture(str(katk), seed=5, n_regions=6)
    r, _ = reference_cli(katk, "gmer_counter", kf.INDEX_ARGS,
                         GT4_TPU_COUNT_IMPL="host")
    assert r.returncode == 0, r.stderr
    env = {k: v for k, v in os.environ.items() if k != "GT4_TPU_DEVICE_SW"}
    try:
        r = subprocess.run(
            [sys.executable, "-c", _RUN, json.dumps(_module_names()),
             str(fa), str(tmp_path / "out.list"), str(katk)],
            capture_output=True, text=True, timeout=600,
            env={**env, "PYTHONPATH": str(REPO)})
    finally:
        (katk / "db.idx").unlink()
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.splitlines()[-1])
    assert got["rc"] == 0 and got["lines"] > 4 and got["n_words"] > 1000
    assert got["modules"] == []


@pytest.mark.parametrize("module", _module_names())
def test_each_module_imports_alone(module):
    """Each module of the port in a fresh process: it imports, and brings
    in nothing of jax or of the JAX package."""
    code = ("import importlib, sys\n"
            f"importlib.import_module({module!r})\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('genometester4_tpu', 'jax', 'jaxlib')))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": str(REPO)})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


_NO_TORCH = r'''
import contextlib, io, json, sys
from genometester4_tpu_torch.cli.glistcompare import main as glistcompare
from genometester4_tpu_torch.cli.glistmaker import main as glistmaker
runs = json.loads(sys.argv[1])
rcs = []
for tool, argv in runs:
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        rcs.append((glistmaker if tool == "m" else glistcompare)(argv))
print(json.dumps({"rcs": rcs, "torch": "torch" in sys.modules}))
'''


def test_list_clis_import_torch_only_on_a_device_route(tmp_path):
    """-h, -v, a bad flag and every argument error of glistmaker, and
    glistcompare's chrome, -ss and N-list union on plain .lists (its
    numpy-free fast paths), run in one fresh process without importing
    torch; the files the fast paths write are there."""
    from genometester4_tpu_torch.formats.list_format import write_list
    rng = np.random.default_rng(4)
    lists = []
    for i in range(3):
        w = np.unique(rng.integers(0, 1 << 20, 500).astype(np.uint64))
        write_list(str(tmp_path / f"l{i}.list"), 10, w,
                   rng.integers(1, 5, len(w)).astype(np.uint32))
        lists.append(str(tmp_path / f"l{i}.list"))
    fa = tmp_path / "in.fa"
    fa.write_text(">a\nACGTACGTTGCA\n")
    runs = [("m", a) for a in (
        ["-h"], ["-v"], ["--bogus"], [], [str(fa), "-w", "0"],
        [str(fa), "-w", "40"], [str(fa), "-w", "x"],
        [str(fa), "-w", "9", "-c", "0"], [str(fa), "-w", "9", "-c", "5",
                                          "--max", "3"],
        [str(fa), "-w", "9", "-o", "o" * 201], ["missing.fa", "-w", "9"],
        [str(fa), "-w"])]
    runs += [("c", a) for a in (
        ["-h"], [], ["--bogus"], [lists[0]], [lists[0], lists[1], "-r",
                                              "min", "-u"],
        [lists[0], "-ss", "rand_unique", "50", "--seed", "3", "-o",
         str(tmp_path / "s")],
        lists + ["-u", "-i", "-o", str(tmp_path / "m")])]
    r = subprocess.run([sys.executable, "-c", _NO_TORCH, json.dumps(runs)],
                       capture_output=True, text=True, timeout=120,
                       cwd=str(tmp_path),
                       env={**os.environ, "PYTHONPATH": str(REPO)})
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.splitlines()[-1])
    assert got["torch"] is False
    assert got["rcs"][:2] == [0, 0] and all(got["rcs"][2:12])
    assert got["rcs"][12:] == [0, 1, 1, 1, 1, 0, 0]
    assert (tmp_path / "s_subset_10.list").stat().st_size > 48
    assert (tmp_path / "m_10_union.list").stat().st_size > 48
    assert (tmp_path / "m_10_intrsec.list").exists()


_NO_TORCH_QUERY = r'''
import contextlib, io, json, os, sys
from genometester4_tpu_torch.cli.glistquery import main as glistquery
from genometester4_tpu_torch.cli.gmer_caller import main as gmer_caller
runs = json.loads(sys.argv[1])
rcs = []
for tool, env, argv in runs:
    os.environ.pop("GT4_TPU_LINK", None)
    os.environ.pop("GT4_TPU_CALLER_IMPL", None)
    os.environ.update(env)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rcs.append([(glistquery if tool == "q" else gmer_caller)(argv),
                    len(out.getvalue())])
print(json.dumps({"rcs": rcs, "torch": "torch" in sys.modules}))
'''


def test_query_and_caller_import_torch_only_on_a_device_route(tmp_path):
    """glistquery's -h, -v, argument errors, numpy-free statistics, -D
    statistics, single queries and its host routes (GT4_TPU_LINK=slow:
    -s, -l, a two-list dump), and gmer_caller's -v, --no_genotypes and
    host route (GT4_TPU_CALLER_IMPL=host), run in one fresh process
    without importing torch, and print."""
    from genometester4_tpu_torch.formats.list_format import write_list
    rng = np.random.default_rng(6)
    w = np.unique(rng.integers(0, 1 << 20, 6000).astype(np.uint64))
    write_list(str(tmp_path / "l.list"), 10, w,
               rng.integers(1, 5, len(w)).astype(np.uint32))
    write_list(str(tmp_path / "m.list"), 10, w[::2],
               rng.integers(1, 5, len(w[::2])).astype(np.uint32))
    seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), 6000,
                     p=[0.24, 0.25, 0.25, 0.25, 0.01])
    (tmp_path / "in.fa").write_bytes(b">a\n" + seq.tobytes() + b"\n")
    (tmp_path / "calls.txt").write_text("".join(
        f"{1 + i % 22}_m{i}\t2\t{30 - i % 31}\t{i % 29}\n"
        for i in range(300)))
    slow, host = {"GT4_TPU_LINK": "slow"}, {"GT4_TPU_CALLER_IMPL": "host"}
    runs = [("q", {}, a) for a in (
        ["-h"], ["-v"], ["--bogus"], [], ["l.list", "-mm", "17"],
        ["l.list", "--stat"], ["l.list", "--median"],
        ["l.list", "--distribution", "4"], ["l.list", "--gc"],
        ["l.list", "--median", "-D"], ["l.list", "-q", "ACGTACGTAC"],
        ["l.list", "-q", "ACGTACGTAC", "-mm", "1", "--all"])]
    runs += [("q", slow, a) for a in (
        ["l.list", "-s", "in.fa"], ["l.list", "-l", "l.list"],
        ["l.list", "m.list"])]
    runs += [("c", {}, ["-v"]),
             ("c", {}, ["--no_genotypes", "--info", "--runs", "0",
                        "calls.txt"]),
             ("c", host, ["--runs", "0", "--coverage", "30", "calls.txt"])]
    r = subprocess.run(
        [sys.executable, "-c", _NO_TORCH_QUERY, json.dumps(runs)],
        capture_output=True, text=True, timeout=120, cwd=str(tmp_path),
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.splitlines()[-1])
    assert got["torch"] is False
    rcs = [rc for rc, _ in got["rcs"]]
    assert rcs == [0, 0, 1, 1, 1] + [0] * 13
    assert all(n > 0 for _, n in got["rcs"][5:])


_NO_TORCH_EXTRAS = r'''
import contextlib, io, json, sys
from genometester4_tpu_torch.cli import (gdistribution, generate_vcf,
                                         katk2vcf, kmer_predictor, repeats)
tools = {"gdistribution": gdistribution.main, "generate_vcf":
         generate_vcf.main, "katk2vcf": katk2vcf.main, "kmer_predictor":
         kmer_predictor.main, "repeats": repeats.main}
rcs = []
for tool, argv in json.loads(sys.argv[1]):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rcs.append([tools[tool](argv), len(out.getvalue())])
print(json.dumps({"rcs": rcs, "torch": "torch" in sys.modules}))
'''


def test_extra_clis_import_no_torch(tmp_path):
    """gdistribution, kmer_predictor, generate_vcf, katk2vcf and every
    stage of repeats run in one fresh process, print, and import no
    torch."""
    from genometester4_tpu_torch.formats.list_format import write_list
    rng = np.random.default_rng(8)
    w = np.unique(rng.integers(0, 1 << 16, 3000).astype(np.uint64))
    write_list(str(tmp_path / "a_8.list"), 8, w,
               rng.integers(1, 9, len(w)).astype(np.uint32))
    write_list(str(tmp_path / "b_8.list"), 8, w[::3],
               rng.integers(1, 9, len(w[::3])).astype(np.uint32))
    (tmp_path / "lists.txt").write_text("".join(
        f"s{i}\tb_8.list\t{i}\n" for i in range(25)))
    (tmp_path / "calls.txt").write_text(
        "#Sex\tM\n1:5:rs1:A/G\tAB\t0.9\t3\t4\nX:9:rs2:C/T\tB\t0.9\t0\t7\n")
    (tmp_path / "chr").mkdir()
    (tmp_path / "chr" / "1.fa").write_text(">1\n" + "ACGTTGCA" * 50 + "\n")
    (tmp_path / "katk.txt").write_text(
        "1\t10\t0\tG\t30\tGA\tS\t0.9\t0.9\n"
        "1\t30\t0\tT\t30\tT-\tD\t0.9\t0.9\n"
        "1\t60\t0\tC\t30\tCA\tS\t0.9\t0.9\n")
    motif = "ACGGTCATTGCAGTCCA" * 4
    (tmp_path / "g.fa").write_text(">g\n" + "T" * 50 + motif + "G" * 60
                                   + motif + "C" * 40 + "\n")
    (tmp_path / "over.txt").write_text("".join(
        f"{motif[i:i + 16]}\t4\n" for i in range(len(motif) - 16)))
    (tmp_path / "regions.fa").write_text(">r1 x\nACGT\n>r2 y\nACGA\n")
    (tmp_path / "blast.txt").write_text("r1\t4\tr2\t4\t99\t4\n")
    (tmp_path / "chroms.txt").write_text("r1\tchr1\nr2\tchr2\n")
    runs = [["gdistribution", ["a_8.list", "b_8.list"]],
            ["kmer_predictor", ["--kmers", "a_8.list", "--lists",
                                "lists.txt"]],
            ["kmer_predictor", ["-v"]],
            ["generate_vcf", ["calls.txt"]],
            ["katk2vcf", ["--chr_dir", "chr", "katk.txt"]],
            ["repeats", ["find_regions", "over.txt", "g.fa", "20", "3"]],
            ["repeats", ["collate_repeats", "blast.txt", "regions.fa"]],
            ["repeats", ["filter_collated", "regions.fa", "0"]],
            ["repeats", ["unique", "regions.fa", "blast.txt"]],
            ["repeats", ["filter_final", "regions.fa", "chroms.txt",
                         "chr1"]]]
    r = subprocess.run(
        [sys.executable, "-c", _NO_TORCH_EXTRAS, json.dumps(runs)],
        capture_output=True, text=True, timeout=120, cwd=str(tmp_path),
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.splitlines()[-1])
    assert got["torch"] is False
    assert [rc for rc, _ in got["rcs"]] == [0] * len(runs)
    printed = [n > 0 for _, n in got["rcs"]]
    assert printed == [True, False, True, True, True, True, True, False,
                       True, True]


_GROUP = r'''
import contextlib, io, json, sys
from genometester4_tpu_torch.parallel import multihost
from genometester4_tpu_torch.cli.glistcompare import main as glistcompare
from genometester4_tpu_torch.cli.glistmaker import main as glistmaker
fa = sys.argv[1]
with contextlib.redirect_stdout(io.StringIO()), \
        contextlib.redirect_stderr(io.StringIO()):
    rcs = [glistmaker([fa, "-w", "11", "-o", "a"], device="cpu"),
           glistcompare(["a_11.list", "a_11.list", "-u", "-o", "u"],
                        device="cpu")]
mods = sorted(m for m in sys.modules
              if m.split(".")[0] in ("genometester4_tpu", "jax", "jaxlib"))
print(json.dumps({"rcs": rcs, "transport": multihost.transport(),
                  "modules": mods}))
'''


def test_group_runs_without_the_jax_package(tmp_path):
    """Two fresh processes form a gloo group (``parallel.multihost``) and
    run the glistmaker and glistcompare CLIs on it: neither loads a module
    of jax or of the JAX package, and process 0 writes."""
    from genometester4_tpu_torch.tools.group_run import free_port
    rng = np.random.default_rng(13)
    seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), 5000,
                     p=[0.24, 0.25, 0.25, 0.25, 0.01])
    (tmp_path / "in.fa").write_bytes(b">a\n" + seq.tobytes() + b"\n")
    coord = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GROUP, str(tmp_path / "in.fa")],
        cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env={**os.environ, "PYTHONPATH": str(REPO),
                        "GT4_DIST_COORD": coord, "GT4_DIST_NPROCS": "2",
                        "GT4_DIST_PROC_ID": str(i),
                        "GT4_DIST_TIMEOUT": "60"}) for i in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs[0][1] + outs[1][1]
    for out, _ in outs:
        assert json.loads(out.splitlines()[-1]) == {
            "rcs": [0, 0], "transport": "gloo", "modules": []}
    assert (tmp_path / "a_11.list").exists()
    assert (tmp_path / "u_11_union.list").exists()
