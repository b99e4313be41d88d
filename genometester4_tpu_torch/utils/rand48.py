"""Exact drand48/srand48 emulation (the port's copy of
``genometester4_tpu/utils/rand48.py``).

glistcompare's random subsetting draws from drand48 seeded with
``--seed`` (src/glistcompare.c:237-241, :719-787). Byte-identical subset
output therefore requires reproducing the exact POSIX drand48 stream:

    X_{n+1} = (a * X_n + c) mod 2^48,  a = 0x5DEECE66D, c = 0xB
    srand48(s):  X_0 = (s << 16) | 0x330E
    drand48():   advance, return X / 2^48

The bulk generator vectorizes the affine recurrence with a Hillis-Steele
prefix composition of affine maps ((a1,c1)∘(a2,c2) = (a1·a2, a1·c2+c1)),
giving the whole stream in O(log n) numpy passes.
"""

from __future__ import annotations

import numpy as np

_A = np.uint64(0x5DEECE66D)
_C = np.uint64(0xB)
_MASK = np.uint64((1 << 48) - 1)


class Rand48:
    def __init__(self, seed: int):
        self.x = np.uint64(((seed & 0xFFFFFFFF) << 16) | 0x330E)

    def drand(self) -> float:
        # python ints: u64 wraparound is intended, avoid numpy warnings
        self.x = np.uint64((0x5DEECE66D * int(self.x) + 0xB) & ((1 << 48) - 1))
        return float(self.x) / float(1 << 48)

    def drand_array(self, n: int) -> np.ndarray:
        """Next n drand48 values as float64, advancing the state."""
        if n == 0:
            return np.empty(0, np.float64)
        with np.errstate(over="ignore"):
            a = np.full(n, _A, np.uint64)
            c = np.full(n, _C, np.uint64)
            shift = 1
            # inclusive prefix composition: element i ends up as the map
            # that advances the state by i+1 steps
            while shift < n:
                a2, c2 = a[:-shift], c[:-shift]
                c[shift:] = (a[shift:] * c2 + c[shift:]) & _MASK
                a[shift:] = (a[shift:] * a2) & _MASK
                shift <<= 1
            xs = (a * self.x + c) & _MASK
        self.x = xs[-1]
        return xs.astype(np.float64) / float(1 << 48)
