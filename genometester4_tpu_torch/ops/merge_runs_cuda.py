"""Kernel E wrapper: merge-path merge of sorted run pairs on the GPU
(``csrc/merge_runs.cu``).

Replaces ``genometester4_tpu/ops/bitonic_merge_pallas.py:make_block_merge``.
Its plain PyTorch version, with the same contract, is
``ops.merge_runs.merge_runs``; ``ops.merge_runs.merge_sorted_runs`` picks
between the two by the tensor's device and checks that the runs are
sorted. This wrapper only launches: a tensor that is not on a CUDA device
raises.
"""

from __future__ import annotations

import torch

from genometester4_tpu_torch.ops import _build
from genometester4_tpu_torch.ops.merge_runs import check_runs
from genometester4_tpu_torch.utils import trace


def merge_runs_cuda(keys: torch.Tensor, L: int):
    """keys int64[n] (CUDA, contiguous; sorted length-L runs, n % 2L == 0)
    -> (merged int64[n], pos int32[n]), as ``ops.merge_runs.merge_runs``."""
    if not keys.is_cuda:
        raise ValueError(f"merge_runs_cuda needs a CUDA tensor, got "
                         f"{keys.device}")
    check_runs(keys, L)
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    n = keys.numel()
    merged = torch.empty_like(keys)
    pos = torch.empty(n, dtype=torch.int32, device=keys.device)
    if n:
        lib = _build.load_library()
        splits = torch.empty(-(-n // lib.gt4_merge_runs_tile()),
                             dtype=torch.int64, device=keys.device)
        with torch.cuda.device(keys.device):
            err = lib.gt4_merge_runs(
                keys.data_ptr(), merged.data_ptr(), pos.data_ptr(),
                splits.data_ptr(), n, int(L),
                torch.cuda.current_stream().cuda_stream)
        _build.check_launch(lib, err, "merge runs")
        trace.count("launch.merge_runs")
    return merged, pos
