"""k-mer window extraction (port of ``genometester4_tpu/ops/kmers.py``).

Both functions follow the contract of the Pallas kernel
(``genometester4_tpu/ops/extract_pallas.py:15-20``), not of the XLA
build: n codes give n outputs, and the trailing k-1 windows, which would
cross the end of the array, come out invalid. Keys and validity are as in
``ops.encode``: for k <= 31 validity is the flag bit 2k of the key and
no mask is returned; for k = 32 a bool mask is returned beside the keys.
Invalid windows carry the word 0 so that the kernel and its plain version
agree on every bit.
"""

from __future__ import annotations

import torch

from genometester4_tpu_torch.ops.encode import SIGN, canonical as _canonical

INVALID = 255


def check_codes(codes: torch.Tensor, k: int) -> None:
    if not 1 <= k <= 32:
        raise ValueError("word length must be 1..32")
    if codes.dtype != torch.uint8 or codes.dim() != 1:
        raise ValueError(f"codes must be a 1-D uint8 tensor, got "
                         f"{codes.dtype} of shape {tuple(codes.shape)}")


def extract_kmers(codes: torch.Tensor, k: int, canonical: bool = True):
    """Plain PyTorch extraction: codes uint8[n] -> (keys int64[n], valid).

    ``valid`` is None for k <= 31 (the flag bit is in the key) and a
    bool[n] mask for k = 32. This is the plain version of the CUDA kernel
    in ``ops.extract_cuda``; it runs on any device.
    """
    check_codes(codes, k)
    n = codes.numel()
    m = max(n - k + 1, 0)          # windows that end inside the array
    bad = codes == INVALID
    c = (codes & 3).to(torch.int64)
    word = torch.zeros(m, dtype=torch.int64, device=codes.device)
    bad_w = torch.zeros(m, dtype=torch.bool, device=codes.device)
    for j in range(k):
        word = (word << 2) | c[j:j + m]
        bad_w |= bad[j:j + m]
    if canonical:
        word = _canonical(word, k)
    valid = torch.zeros(n, dtype=torch.bool, device=codes.device)
    valid[:m] = ~bad_w
    words = torch.zeros(n, dtype=torch.int64, device=codes.device)
    words[:m] = word.masked_fill(bad_w, 0)
    if k == 32:
        return words ^ SIGN, valid
    return (words | ((~valid).to(torch.int64) << (2 * k))) ^ SIGN, None


def extract_kmers_best(codes: torch.Tensor, k: int, canonical: bool = True):
    """Kernel A for a CUDA tensor; the plain version for a CPU tensor."""
    if codes.is_cuda:
        from genometester4_tpu_torch.ops.extract_cuda import \
            extract_kmers_cuda
        return extract_kmers_cuda(codes, k, canonical)
    if codes.device.type != "cpu":
        raise ValueError(f"unsupported device {codes.device}")
    return extract_kmers(codes, k, canonical)
