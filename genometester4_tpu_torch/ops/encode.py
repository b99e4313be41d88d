"""k-mer words and keys on int64 tensors (device half of
``genometester4_tpu/ops/encode.py``).

The JAX package carries a k-mer on the device as an ``(hi, lo)`` uint32
pair, because a TPU has no 64-bit integer datapath. A GPU has one, so the
port carries it as one int64:

* a *word* is the 2k-bit big-endian base string in the low bits of an
  int64, exactly the reference's u64 reinterpreted as signed (k = 32
  words use bit 63);
* a *key* is a word with bit 63 flipped (``word ^ SIGN``). Signed int64
  order of keys is unsigned order of words, so ``torch.sort`` sorts keys
  in the reference's order. For k <= 31 an invalid window sets the flag
  bit 2k of its word (``flag_key``), which sorts it after every valid
  key; k = 32 has no free bit, so there validity travels as a mask.

``pair_less`` becomes ``word_less`` (or plain ``<`` on keys) and
``pair_eq`` is plain ``==`` on words or keys.

The numpy conversions below are how the differential tests give the JAX
package and the port the same state: JAX's ``(hi, lo)`` pairs and the
host's u64 word arrays both map one to one onto keys.
"""

from __future__ import annotations

import numpy as np
import torch

from genometester4_tpu.ops.encode import join_u64, split_u64

SIGN = -(1 << 63)             # int64 with only bit 63 set
_SIGN_U64 = np.uint64(1 << 63)


def word_mask(k: int) -> int:
    """The low 2k bits, as an int64-representable Python int (-1 for k=32)."""
    return -1 if k == 32 else (1 << (2 * k)) - 1


def flag_key(word_bits: int) -> int:
    """Key of the word ``1 << word_bits``: every key below it has no bit at
    or above ``word_bits`` set (word_bits < 64)."""
    return (1 << word_bits) ^ SIGN


def reverse_complement(words: torch.Tensor, k: int) -> torch.Tensor:
    """Element-wise reverse complement of int64 k-mer words."""
    x = ~words
    # reverse the 32 2-bit groups of the full 64-bit value; every shift
    # right is masked because int64 ``>>`` is arithmetic
    for s, m in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                 (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF),
                 (32, 0x00000000FFFFFFFF)):
        x = ((x & m) << s) | ((x >> s) & m)
    if k < 32:
        x = (x >> (64 - 2 * k)) & word_mask(k)
    return x


def word_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned 64-bit ``a < b`` on int64 words."""
    return (a ^ SIGN) < (b ^ SIGN)


def canonical(words: torch.Tensor, k: int) -> torch.Tensor:
    """Unsigned min(word, reverse complement), element-wise."""
    rc = reverse_complement(words, k)
    return torch.minimum(words ^ SIGN, rc ^ SIGN) ^ SIGN


def keys_from_u64(words) -> torch.Tensor:
    """Host u64 words -> int64 keys (CPU tensor)."""
    w = np.asarray(words, dtype=np.uint64) ^ _SIGN_U64
    return torch.from_numpy(w.view(np.int64))


def u64_from_keys(keys: torch.Tensor) -> np.ndarray:
    """int64 keys (any device) -> host u64 words."""
    return keys.cpu().numpy().view(np.uint64) ^ _SIGN_U64


def keys_from_pair(hi, lo) -> torch.Tensor:
    """JAX's (hi, lo) uint32 pair -> int64 keys (CPU tensor)."""
    return keys_from_u64(join_u64(hi, lo))


def pair_from_keys(keys: torch.Tensor):
    """int64 keys -> JAX's (hi, lo) uint32 pair (numpy)."""
    return split_u64(u64_from_keys(keys))
