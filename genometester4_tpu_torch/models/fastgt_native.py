"""gmer_caller's exact model in the host C library (the port's counterpart
of ``genometester4_tpu/models/fastgt_native.py:285-332``).

``native/fastgt_exact.c`` reproduces the reference's numerics bit for
bit: the glibc ``rand()`` training subsample (``srand``, ``rand_skip``),
the float32 Nelder-Mead simplex (``train_model``) and the mixed
float/double 15-genotype posterior (``genotype_batch``). The library and
its signatures are ``utils.native``'s; this is host code, not a GPU
kernel. ``models.genotype.genotype_batch_device`` is the posterior batch
on the device, bit-equal to ``genotype_batch``.
"""

from __future__ import annotations

import ctypes

import numpy as np

from genometester4_tpu_torch.utils.native import get_lib, rand_skip, srand

__all__ = ["N_GENOTYPES", "allele_freq", "genotype_batch", "get_lib",
           "poisson", "rand_skip", "srand", "train_model"]

N_GENOTYPES = 15


def poisson(k: int, lam: float) -> float:
    return get_lib().fgx_poisson(k, lam)


def allele_freq(counts: np.ndarray) -> float:
    counts = np.ascontiguousarray(counts, np.uint16)
    return get_lib().fgx_allele_freq(counts, len(counts) // 2)


def train_model(counts: np.ndarray, max_training: int, nruns: int,
                params: np.ndarray, mul: int, nthreads: int,
                debug: int = 0):
    """Train 7 params in place; returns (trained_ok, pB).

    ``counts`` is a flat uint16 [a0,b0,a1,b1,...] array; ``params`` a
    float32[7] updated in place like the reference's v[]
    (src/gmer_caller.c:225-347).
    """
    counts = np.ascontiguousarray(counts, np.uint16)
    if params.dtype != np.float32 or not params.flags.c_contiguous:
        raise ValueError("params must be a contiguous float32 array")
    pb = ctypes.c_float(0)
    ok = get_lib().fgx_train_model(counts, len(counts) // 2, max_training,
                                   nruns, params, ctypes.byref(pb), mul,
                                   nthreads, debug)
    return bool(ok), pb.value


def genotype_batch(counts: np.ndarray, pB: float, params: np.ndarray):
    """Posterior for every (a,b) pair: returns (a[n,15], sum[n], best[n])."""
    counts = np.ascontiguousarray(counts, np.uint16)
    n = len(counts) // 2
    out_a = np.empty((n, N_GENOTYPES), np.float64)
    out_sum = np.empty(n, np.float64)
    out_best = np.empty(n, np.uint32)
    get_lib().fgx_genotype_batch(counts, n, pB,
                                 np.ascontiguousarray(params, np.float32),
                                 out_a, out_sum, out_best)
    return out_a, out_sum, out_best
