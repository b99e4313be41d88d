"""Kernel B wrapper: run marks on the GPU (``csrc/runmarks.cu``).

Replaces ``genometester4_tpu/ops/runmarks_pallas.py:make_run_marks``.
Its plain PyTorch version, with the same contract, is
``ops.sortcount.run_marks``; ``ops.sortcount.count_unique`` picks between
the two by the tensor's device. This wrapper only launches: a tensor that
is not on a CUDA device raises.
"""

from __future__ import annotations

import torch

from genometester4_tpu_torch.ops import _build


def run_marks_cuda(keys: torch.Tensor, n_valid: int):
    """Sorted keys int64[n] (CUDA, contiguous), valid prefix length ->
    (head bool[n], tail bool[n], stats int32[3]).

    ``stats`` holds (n_unique, total, checksum) as 32-bit words on the
    device; see ``ops.sortcount.run_marks`` for their definition.
    """
    if not keys.is_cuda:
        raise ValueError(f"run_marks_cuda needs a CUDA tensor, got "
                         f"{keys.device}")
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise ValueError(f"keys must be a 1-D int64 tensor, got "
                         f"{keys.dtype} of shape {tuple(keys.shape)}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    n = keys.numel()
    if not 0 <= n_valid <= n:
        raise ValueError(f"n_valid={n_valid} outside 0..{n}")
    head = torch.empty(n, dtype=torch.uint8, device=keys.device)
    tail = torch.empty(n, dtype=torch.uint8, device=keys.device)
    stats = torch.zeros(3, dtype=torch.int32, device=keys.device)
    if n:
        lib = _build.load_library()
        with torch.cuda.device(keys.device):
            err = lib.gt4_run_marks(
                keys.data_ptr(), head.data_ptr(), tail.data_ptr(),
                stats.data_ptr(), n, int(n_valid),
                torch.cuda.current_stream().cuda_stream)
        _build.check_launch(lib, err, "run marks")
        run_marks_cuda.launches += 1
    return head.view(torch.bool), tail.view(torch.bool), stats


run_marks_cuda.launches = 0
