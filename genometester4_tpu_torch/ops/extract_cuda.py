"""Kernel A wrapper: k-mer extraction on the GPU (``csrc/extract.cu``).

Replaces ``genometester4_tpu/ops/extract_pallas.py:make_extract_pallas``.
Its plain PyTorch version, with the same contract, is
``ops.kmers.extract_kmers``; ``ops.kmers.extract_kmers_best`` picks
between the two by the tensor's device. This wrapper only launches: a
tensor that is not on a CUDA device raises.
"""

from __future__ import annotations

import torch

from genometester4_tpu_torch.ops import _build
from genometester4_tpu_torch.ops.kmers import check_codes


def extract_kmers_cuda(codes: torch.Tensor, k: int, canonical: bool = True):
    """codes uint8[n] (CUDA, contiguous) -> (keys int64[n], valid).

    ``valid`` is None for k <= 31 and a bool[n] mask for k = 32, as for
    ``ops.kmers.extract_kmers``.
    """
    if not codes.is_cuda:
        raise ValueError(f"extract_kmers_cuda needs a CUDA tensor, got "
                         f"{codes.device}")
    check_codes(codes, k)
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous")
    n = codes.numel()
    keys = torch.empty(n, dtype=torch.int64, device=codes.device)
    valid = (torch.empty(n, dtype=torch.uint8, device=codes.device)
             if k == 32 else None)
    if n:
        lib = _build.load_library()
        with torch.cuda.device(codes.device):
            err = lib.gt4_extract(
                codes.data_ptr(), keys.data_ptr(),
                valid.data_ptr() if valid is not None else None, n, k,
                int(canonical), torch.cuda.current_stream().cuda_stream)
        _build.check_launch(lib, err, "extract")
        extract_kmers_cuda.launches += 1
    return keys, (valid.view(torch.bool) if valid is not None else None)


extract_kmers_cuda.launches = 0
