"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names; a run without its cards exits with no
result."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from gt4bench import manifest, run
from gt4bench.tests import tiny

HERE = Path(manifest.HERE)
REPO = HERE.parent


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not top_level_imports(path) & set(run.FORBIDDEN), path


@pytest.mark.parametrize("name,flagged", [
    ("genometester4_tpu_torch_like", False), ("jaxlike.core", False),
    ("genometester4_tpu.io", True), ("jax.numpy", True), ("flax", True)])
def test_whole_names_are_compared(name, flagged):
    assert name not in sys.modules
    sys.modules[name] = sys
    try:
        assert (name.split(".")[0] in run.forbidden_modules()) == flagged
    finally:
        del sys.modules[name]


def test_a_dry_run_loads_neither():
    """A CPU run of every cell in a fresh process, then ``sys.modules``."""
    code = ("import json, sys\n"
            "from gt4bench.tests import tiny\n"
            "from gt4bench.run import forbidden_modules\n"
            "for n in tiny.OVERRIDES:\n"
            "    r = tiny.run(n, trace=n.endswith('chr22'), seconds=0.05)\n"
            "    assert r['correct'], n\n"
            "print(json.dumps(forbidden_modules()))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def cli(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m", "gt4bench.run"] + args,
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


ARGS = ["--workload", "glistmaker.chr22", "--seed", "5", "--seconds", "1",
        "--trace", "0"]


def test_no_cuda_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = cli(ARGS, REPO)
    assert out.returncode != 0 and "{" not in out.stdout


def test_other_card_count_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert run.main(ARGS) != 0
    assert "{" not in capsys.readouterr().out


def test_benchmark_files_alone_fail(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "gt4bench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    out = cli(ARGS, tmp_path)
    assert out.returncode != 0 and "{" not in out.stdout


@pytest.mark.cuda
def test_small_cells_on_the_card():
    """Every cell's small copy on the card: the kernels, the spans and the
    trace reader, judged by the reference."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gt4bench.run import run_cell
    for name, over in tiny.OVERRIDES.items():
        cell = manifest.cell(name)
        if cell.chips > torch.cuda.device_count():
            continue
        over = {k: v for k, v in over.items() if k != "mesh_devices"}
        r = run_cell(cell, 9, 0.2, True, overrides=over, log=lambda s: None)
        assert r["correct"] and r["device"]["busy_s"] > 0, name
