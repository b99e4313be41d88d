"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one.

This file imports neither jax nor the test conftest, so on a machine
with a GPU and no JAX it runs as
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from genometester4_tpu_torch.ops import encode as tenc
from genometester4_tpu_torch.ops.extract_cuda import extract_kmers_cuda
from genometester4_tpu_torch.ops.kmers import extract_kmers
from genometester4_tpu_torch.ops.runmarks_cuda import run_marks_cuda
from genometester4_tpu_torch.ops.sortcount import count_unique, run_marks

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _codes(seed, n):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    codes[rng.integers(0, max(n, 1), size=n // 50)] = 255
    return torch.from_numpy(codes)


@pytest.mark.parametrize("n", [1, 31, 257, 100_003])
@pytest.mark.parametrize("k", [1, 5, 16, 17, 25, 31, 32])
def test_extract_kernel_equals_plain(cuda, k, n):
    codes = _codes(k * 7 + n, n)
    for canonical in (True, False):
        keys_c, valid_c = extract_kmers_cuda(codes.to(cuda), k, canonical)
        keys_p, valid_p = extract_kmers(codes, k, canonical)
        torch.cuda.synchronize()
        assert torch.equal(keys_c.cpu(), keys_p)
        assert (valid_c is None) == (valid_p is None) == (k < 32)
        if valid_c is not None:
            assert torch.equal(valid_c.cpu(), valid_p)


@pytest.mark.parametrize("n", [1, 2, 255, 256, 257, 1_000_003])
def test_run_marks_kernel_equals_plain(cuda, n):
    rng = np.random.default_rng(n)
    words = np.sort(rng.integers(0, 2 ** 64 - 1, n, dtype=np.uint64,
                                 endpoint=True))
    dup = rng.random(n) < 0.3
    words[dup] = words[np.maximum(np.flatnonzero(dup) - 1, 0)]
    keys = tenc.keys_from_u64(np.sort(words))
    for n_valid in sorted({0, 1, n // 2, n - 1, n}):
        h_c, t_c, s_c = run_marks_cuda(keys.to(cuda), n_valid)
        h_p, t_p, s_p = run_marks(keys, n_valid)
        torch.cuda.synchronize()
        assert torch.equal(h_c.cpu(), h_p)
        assert torch.equal(t_c.cpu(), t_p)
        assert torch.equal(s_c.cpu(), s_p)


@pytest.mark.parametrize("weighted", [False, True])
def test_count_unique_cuda_equals_cpu(cuda, weighted):
    rng = np.random.default_rng(9)
    n = 300_000
    words = rng.integers(0, 2 ** 50, n, dtype=np.uint64)
    words[rng.random(n) < 0.4] = words[0]
    keys = tenc.keys_from_u64(words)
    keys[rng.random(n) < 0.1] = tenc.flag_key(50)
    w = (torch.from_numpy(rng.integers(0, 2 ** 32, n, dtype=np.int64))
         if weighted else None)
    got = count_unique(keys.to(cuda), None if w is None else w.to(cuda), 50)
    want = count_unique(keys, w, 50)
    for a, b in zip(got[:4], want[:4]):
        assert (a is None and b is None) or torch.equal(a.cpu(), b)
    assert got[4] == want[4]


def test_make_list_cuda_equals_cpu(cuda, tmp_path):
    from genometester4_tpu_torch.pipelines.listmaker import make_list
    rng = np.random.default_rng(4)
    seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), 50_000,
                     p=[0.24, 0.25, 0.25, 0.25, 0.01])
    fa = tmp_path / "in.fa"
    fa.write_bytes(b">a\n" + seq[:30_000].tobytes() + b"\n>b\n"
                   + seq[30_000:].tobytes() + b"\n")
    for k in (16, 25, 32):
        before = (extract_kmers_cuda.launches, run_marks_cuda.launches)
        make_list([str(fa)], k, str(tmp_path / "g.list"), chunk_bases=1 << 14,
                  device="cuda")
        make_list([str(fa)], k, str(tmp_path / "c.list"), chunk_bases=1 << 14,
                  device="cpu")
        assert ((tmp_path / "g.list").read_bytes()
                == (tmp_path / "c.list").read_bytes())
        assert extract_kmers_cuda.launches > before[0]
        assert run_marks_cuda.launches > before[1]


def test_wrappers_reject_bad_tensors(cuda):
    codes = torch.zeros(64, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        extract_kmers_cuda(codes[::2], 5)
    with pytest.raises(ValueError, match="uint8"):
        extract_kmers_cuda(codes.to(torch.int32), 5)
    keys = torch.zeros(64, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        run_marks_cuda(keys[::2], 1)
    with pytest.raises(ValueError, match="int64"):
        run_marks_cuda(keys.to(torch.int32), 1)
    with pytest.raises(ValueError, match="n_valid"):
        run_marks_cuda(keys, 65)
