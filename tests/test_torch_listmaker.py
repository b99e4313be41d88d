"""Port vs JAX: glistmaker's device counting route end to end. The port
runs on the CPU (its kernels' plain versions); the JAX package runs its
device route (``GT4_TPU_COUNT_IMPL=device``) without the mesh
(``GT4_TPU_MESH=0``). The .list files must be byte-identical."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.conftest import random_fasta, random_fastq
from genometester4_tpu.pipelines import listmaker as jax_listmaker
from genometester4_tpu_torch.pipelines import listmaker as port

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SMALL_CHUNK = 1 << 12   # several chunks, so the weighted merge runs


@pytest.fixture
def jax_device_route(monkeypatch):
    monkeypatch.setenv("GT4_TPU_COUNT_IMPL", "device")
    monkeypatch.setenv("GT4_TPU_MESH", "0")


def _both(tmp_path, paths, k, **kw):
    """Run both packages with the same arguments; return both files' bytes."""
    paths = [str(p) for p in paths]
    jax_listmaker.make_list(paths, k, str(tmp_path / "jax.list"), **kw)
    port.make_list(paths, k, str(tmp_path / "port.list"), device="cpu", **kw)
    return ((tmp_path / "jax.list").read_bytes(),
            (tmp_path / "port.list").read_bytes())


def _repeat_fasta(rng, n_records=4, length=3000):
    """Records assembled from a few shared segments: counts well above 1."""
    segs = [rng.choice(list("ACGT"), 120) for _ in range(6)]
    out = []
    for i in range(n_records):
        parts = [segs[j] for j in rng.integers(0, len(segs), length // 120)]
        seq = "".join("".join(p) for p in parts)
        out.append(f">r{i}\n" + "\n".join(
            seq[j:j + 70] for j in range(0, len(seq), 70)) + "\n")
    return "".join(out)


@pytest.mark.parametrize("k", [4, 16, 17, 25, 32])
def test_multi_chunk_fasta_byte_identical(tmp_path, jax_device_route, k):
    rng = np.random.default_rng(k)
    fa = tmp_path / "in.fa"
    fa.write_text(random_fasta(rng, n_records=5, min_len=200, max_len=6000,
                               n_prob=0.01))
    a, b = _both(tmp_path, [fa], k, chunk_bases=SMALL_CHUNK)
    assert len(b) > 48 and a == b


def test_multi_file_and_fastq_byte_identical(tmp_path, jax_device_route):
    rng = np.random.default_rng(11)
    fq = tmp_path / "in.fq"
    fq.write_text(random_fastq(rng, n_records=150, read_len=100,
                               n_prob=0.02))
    fa = tmp_path / "in.fa"
    fa.write_text(random_fasta(rng, n_records=3, min_len=500, max_len=3000))
    a, b = _both(tmp_path, [fq], 25, chunk_bases=SMALL_CHUNK)
    assert len(b) > 48 and a == b
    a, b = _both(tmp_path, [fa, fq], 25, chunk_bases=SMALL_CHUNK)
    assert a == b


def test_spill_path_byte_identical(tmp_path, jax_device_route, monkeypatch,
                                   capfd):
    """A tiny spill budget sends counted shards through tmp .list files;
    the env knob GT4_SPILL_BYTES does the same. Debug phase lines report
    the same words and uniques as the JAX package's."""
    rng = np.random.default_rng(5)
    fa = tmp_path / "in.fa"
    fa.write_text(random_fasta(rng, n_records=3, min_len=8000,
                               max_len=12000, n_prob=0.005))
    a, b = _both(tmp_path, [fa], 16, chunk_bases=SMALL_CHUNK,
                 spill_bytes=1 << 14, debug=1)
    assert a == b
    err = capfd.readouterr().err.splitlines()
    words_lines = [ln for ln in err if ln.startswith("Words ")]
    assert len(words_lines) == 2 and words_lines[0] == words_lines[1]
    monkeypatch.setenv("GT4_SPILL_BYTES", str(1 << 14))
    port.make_list([str(fa)], 16, str(tmp_path / "env.list"),
                   chunk_bases=SMALL_CHUNK, device="cpu")
    assert (tmp_path / "env.list").read_bytes() == a


@pytest.mark.parametrize("min_count,max_count", [(2, 0xFFFFFFFF), (2, 5),
                                                 (1, 3)])
def test_cutoffs_byte_identical(tmp_path, jax_device_route, min_count,
                                max_count):
    rng = np.random.default_rng(min_count * 10 + max_count % 7)
    fa = tmp_path / "in.fa"
    fa.write_text(_repeat_fasta(rng))
    a, b = _both(tmp_path, [fa], 12, chunk_bases=SMALL_CHUNK,
                 min_count=min_count, max_count=max_count)
    assert len(b) > 48 and a == b


def test_non_canonical_byte_identical(tmp_path, jax_device_route):
    rng = np.random.default_rng(21)
    fa = tmp_path / "in.fa"
    fa.write_text(random_fasta(rng, n_records=2, min_len=2000, max_len=5000,
                               n_prob=0.01))
    a, b = _both(tmp_path, [fa], 21, chunk_bases=SMALL_CHUNK,
                 canonical=False)
    assert len(b) > 48 and a == b


def test_device_resolution():
    from genometester4_tpu_torch.utils.device import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)


def test_port_never_imports_jax(tmp_path):
    rng = np.random.default_rng(3)
    fa = tmp_path / "in.fa"
    fa.write_text(random_fasta(rng, n_records=2, min_len=300, max_len=900))
    out = tmp_path / "o.list"
    code = (
        "import sys\n"
        "from genometester4_tpu_torch.pipelines.listmaker import make_list\n"
        "import genometester4_tpu_torch.ops.extract_cuda\n"
        "import genometester4_tpu_torch.ops.runmarks_cuda\n"
        "import genometester4_tpu_torch.ops.merge_runs_cuda\n"
        "from genometester4_tpu_torch.parallel.sharding import make_mesh\n"
        f"h = make_list([{str(fa)!r}], 16, {str(out)!r}, device='cpu')\n"
        "assert h.n_words > 0\n"
        f"m = make_list([{str(fa)!r}], 16, {str(out)!r}, device='cpu',\n"
        "              mesh=make_mesh(4, devices=['cpu'] * 4))\n"
        "assert m == h\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert r.returncode == 0, r.stderr
    assert out.stat().st_size > 48
