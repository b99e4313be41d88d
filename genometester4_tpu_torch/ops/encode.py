"""k-mer words and keys on int64 tensors, and the host u64 helpers (port
of ``genometester4_tpu/ops/encode.py``).

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

torch is imported by the one function that makes a tensor
(``keys_from_u64``), so the host helpers serve the CLIs' host routes
without it.
"""

from __future__ import annotations

import sys

import numpy as np

SIGN = -(1 << 63)             # int64 with only bit 63 set
_SIGN_U64 = np.uint64(1 << 63)

_B2S = np.frombuffer(b"ACGT", dtype=np.uint8)

# 256-entry byte -> 2-bit code table; 255 marks invalid characters
# (reference src/sequence.c:43-86: A=0 C=1 G=2 T=U=3, case-insensitive)
NUCL_CODES = np.full(256, 255, dtype=np.uint8)
for _ch, _v in (("A", 0), ("C", 1), ("G", 2), ("T", 3), ("U", 3)):
    NUCL_CODES[ord(_ch)] = _v
    NUCL_CODES[ord(_ch.lower())] = _v


# ---------------------------------------------------------------- host u64

def get_nucl_value(ch: int) -> int:
    """Bit-trick char->code used for ANY byte, valid or not
    (src/sequence.c:45-53) -- lenient paths depend on its garbage values."""
    if ch & 4:
        return ((ch >> 4) | 2) & 3
    return (ch & 6) >> 1


def string_to_word(s: str, strict: bool = True) -> int:
    """Pack a nucleotide string (len <= 32) into a u64
    (src/sequence.c:118-130).

    ``strict=False`` mirrors the reference: warn on stderr for invalid
    characters but keep packing their bit-trick values.
    """
    w = 0
    for ch in s[:32]:
        v = NUCL_CODES[ord(ch) & 0xFF]
        if v == 255:
            if strict:
                raise ValueError(f"invalid character {ch!r} in k-mer string")
            sys.stderr.write(f"Invalid character {ch} in string!\n")
            v = get_nucl_value(ord(ch) & 0xFF)
        w = ((w << 2) | int(v)) & 0xFFFFFFFFFFFFFFFF
    return w


def word_to_string(word: int, k: int) -> str:
    """Unpack a u64 into its k-character string (src/sequence.c:88-99)."""
    out = bytearray(k)
    w = int(word)
    for i in range(k):
        out[k - 1 - i] = _B2S[w & 3]
        w >>= 2
    return out.decode()


def words_to_strings(words: np.ndarray, k: int) -> list[str]:
    """Vectorized word -> string for arrays (used by list dumps)."""
    words = np.asarray(words, dtype=np.uint64)
    shifts = np.arange(2 * (k - 1), -1, -2, dtype=np.uint64)
    codes = (words[:, None] >> shifts[None, :]) & np.uint64(3)
    chars = _B2S[codes.astype(np.intp)]
    return chars.view(f"S{k}").ravel().astype(str).tolist()


def reverse_complement_u64(words: np.ndarray, k: int) -> np.ndarray:
    """Vectorized reverse complement on u64 host arrays
    (src/sequence.c:65-79)."""
    w = (~np.asarray(words, dtype=np.uint64))  # complement every base
    # reverse 2-bit groups of the full 64-bit value via butterfly swaps
    w = ((w & np.uint64(0x3333333333333333)) << np.uint64(2)) | (
        (w >> np.uint64(2)) & np.uint64(0x3333333333333333))
    w = ((w & np.uint64(0x0F0F0F0F0F0F0F0F)) << np.uint64(4)) | (
        (w >> np.uint64(4)) & np.uint64(0x0F0F0F0F0F0F0F0F))
    w = w.byteswap()
    return w >> np.uint64(64 - 2 * k)


def canonical_u64(words: np.ndarray, k: int) -> np.ndarray:
    """Host u64 min(word, reverse complement), element-wise."""
    rc = reverse_complement_u64(words, k)
    return np.minimum(np.asarray(words, dtype=np.uint64), rc)


def split_u64(words: np.ndarray):
    """u64 host array -> JAX's (hi, lo) uint32 pair."""
    w = np.asarray(words, dtype=np.uint64)
    return (w >> np.uint64(32)).astype(np.uint32), w.astype(np.uint32)


def join_u64(hi, lo) -> np.ndarray:
    """JAX's (hi, lo) uint32 pair -> u64 host array."""
    return (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(
        lo, dtype=np.uint64)


# ------------------------------------------------------------ int64 tensors


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
    return (words ^ SIGN).minimum(rc ^ SIGN) ^ SIGN


def keys_from_u64(words) -> torch.Tensor:
    """Host u64 words -> int64 keys (CPU tensor)."""
    import torch
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
