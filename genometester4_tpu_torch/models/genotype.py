"""FastGT 15-genotype posterior in PyTorch (port of
``genometester4_tpu/models/genotype.py``).

The model (src/genotypes.c:10-125): per marker, the posterior over
{X,A,B,AA,AB,BB,AAA..BBBB} is prior(genotype; p0,p1,p2,pB) x
NegBin(count_a; mu_a, size_a) x NegBin(count_b; mu_b, size_b), with the
five coverage levels {error, lambda/2, lambda, 1.5 lambda, 2 lambda}.

Two parts, both on an explicit device:

(a) The model's functions (``genotype_log_posteriors``,
    ``genotype_calls``, ``neg_log_likelihood``, ``genotype_calls_batch``)
    in the lgamma form, float64, as plain functions on tensors: JAX's
    float32 functions in higher precision (tests/test_torch_gmercaller.py
    holds them to JAX's at a stated tolerance).

(b) ``genotype_batch_device``: the contract of
    ``models.fastgt_native.genotype_batch`` (uint16 [a0,b0,a1,b1,...] ->
    a[n,15], sum[n], best[n]) and bit-equal to it. The native code
    multiplies per marker two negative-binomial terms and a prior
    (``native/fastgt_exact.c:182-243``). A negative-binomial term depends
    only on (count, coverage level) and the prior only on the parameters,
    so the host computes them with the native functions themselves
    (``fgx_dnbinom_mu`` for each count present, ``fgx_dbinom`` and the
    reference's float ``sqrtf`` for the prior) and the device does the
    fan-out in the native order: ``a[g] = (q[lvlA(g), ca] * q[lvlB(g),
    cb]) * p[g]``, the sum ``a[0] + a[1] + ... + a[14]`` left to right and
    ``best`` by strict ``>`` in genotype order (``:262-272``; a NaN never
    wins). Each is one IEEE double operation per element, so the bits are
    the native ones: no ``torch.sum`` (a tree), no ``torch.argmax`` (NaN
    wins there) and nothing fused into an FMA. JAX computes this batch in
    plain ``jnp`` in float32 (not bit-exact); here it is plain PyTorch,
    as no Pallas kernel is involved. ``genotype_best_device`` copies back
    only a[i, best[i]], sum and best, all gmer_caller prints without
    ``--alternatives``.
"""

from __future__ import annotations

import numpy as np
import torch

from genometester4_tpu_torch.utils.device import resolve_device

N_GENOTYPES = 15

# (mu level for allele-A counts, for allele-B counts) per genotype;
# levels: 0=error 1=lambda/2 2=lambda 3=1.5*lambda 4=2*lambda
GT_MU = np.array([
    [0, 0],  # X
    [1, 0],  # A
    [0, 1],  # B
    [2, 0],  # AA
    [1, 1],  # AB
    [0, 2],  # BB
    [3, 0],  # AAA
    [2, 1],  # AAB
    [1, 2],  # BBA
    [0, 3],  # BBB
    [4, 0],  # AAAA
    [3, 1],  # AAAB
    [1, 3],  # BBBA
    [2, 2],  # AABB
    [0, 4],  # BBBB
], np.int64)

GENOTYPES = ["-", "A", "B", "AA", "AB", "BB", "AAA", "AAB", "BBA", "BBB",
             "AAAA", "AAAB", "BBBA", "AABB", "BBBB"]

# (x, n) of the native prior's fgx_dbinom(x, n, pA) for genotypes 6..14
_POLY_BINOM = ((3, 3), (2, 3), (1, 3), (0, 3),
               (4, 4), (3, 4), (1, 4), (2, 4), (0, 4))

F64 = torch.float64


# ------------------------------------------------- (a) the model's functions

def _log_dnbinom_mu(x, size, mu):
    """log NegBin(x; size, mu) with the mu/(size+mu) parameterization
    (src/binomial.c:219-244). Invalid (size<=0 or mu<=0) -> -inf."""
    p = mu / (size + mu)
    logpmf = (torch.lgamma(x + size) - torch.lgamma(size)
              - torch.lgamma(x + 1.0)
              + torch.log(p) * x + torch.log1p(-p) * size)
    ok = (size > 0) & (mu > 0)
    return torch.where(ok, logpmf, -torch.inf)


def _binom_pmf(k: float, n: float, p):
    k = torch.as_tensor(k, dtype=F64, device=p.device)
    n = torch.as_tensor(n, dtype=F64, device=p.device)
    return torch.exp(torch.lgamma(n + 1.0) - torch.lgamma(k + 1.0)
                     - torch.lgamma(n - k + 1.0)
                     + torch.where(k > 0, torch.log(p) * k, 0.0)
                     + torch.where(n - k > 0, torch.log1p(-p) * (n - k), 0.0))


def genotype_log_posteriors(count_a, count_b, pB, l_error, p0, p1, p2,
                            lam, size, size2):
    """Unnormalized log posterior for each marker x genotype.

    count_a/count_b: float64 tensors [N] (their device is the device of
    the computation); params: Python or 0-d tensor scalars.
    Returns log_post float64 [N, 15].
    """
    dev = count_a.device

    def t(v):
        return torch.as_tensor(v, dtype=F64, device=dev)

    pB, l_error, p0, p1, p2, lam, size, size2 = (
        t(v) for v in (pB, l_error, p0, p1, p2, lam, size, size2))
    pA = 1.0 - pB
    prior = torch.stack([
        p0,
        pA * p1,
        pB * p1,
        pA * pA * p2,
        2 * pA * pB * p2,
        pB * pB * p2,
    ])
    p_extra = torch.clamp(1.0 - p0 - p1 - p2, min=0.0)
    pl1 = (-1.0 + torch.sqrt(1.0 + 4.0 * p_extra)) / 2.0
    pl2 = pl1 * pl1
    tri = torch.stack([_binom_pmf(3.0 - i, 3.0, pA) for i in range(4)])
    quad = torch.stack([_binom_pmf(4.0 - i, 4.0, pA)
                        for i in (0, 1, 3, 2, 4)])
    # order AAA, AAB, BBA, BBB then AAAA, AAAB, BBBA, AABB, BBBB
    prior = torch.cat([prior, tri * pl1, quad * pl2])
    mus = torch.stack([l_error, lam / 2, lam, lam * 1.5, lam * 2])
    sizes = size + size2 * mus
    la = _log_dnbinom_mu(count_a.to(F64)[:, None], sizes[None, :],
                         mus[None, :])
    lb = _log_dnbinom_mu(count_b.to(F64)[:, None], sizes[None, :],
                         mus[None, :])
    gt = torch.from_numpy(GT_MU).to(dev)
    return (la[:, gt[:, 0]] + lb[:, gt[:, 1]]
            + torch.log(torch.clamp(prior, min=1e-300))[None, :])


def _posteriors(count_a, count_b, pB, params):
    p = [float(v) for v in np.asarray(params, np.float32)]
    return genotype_log_posteriors(count_a, count_b, pB, *p)


def genotype_calls(count_a, count_b, pB, params):
    """Best genotype + normalized probability per marker.

    params: [error, p0, p1, p2, lambda, size, size2] (the gmer_caller
    v[] vector). Returns (best int32[N], prob float64[N], post [N,15]).
    """
    lp = _posteriors(count_a, count_b, pB, params)
    m = lp.max(dim=1, keepdim=True).values
    w = torch.exp(lp - m)
    post = w / w.sum(dim=1, keepdim=True)
    best = lp.argmax(dim=1)
    prob = post.gather(1, best[:, None])[:, 0]
    return best.to(torch.int32), prob, post


def neg_log_likelihood(count_a, count_b, pB, params):
    """Training objective (sum over markers of -log marginal), the twin of
    mlogL3 (src/gmer_caller.c:783-806)."""
    lp = _posteriors(count_a, count_b, pB, params)
    m = lp.max(dim=1).values
    marginal = m + torch.log(torch.exp(lp - m[:, None]).sum(dim=1))
    return -marginal.sum()


def genotype_calls_batch(counts: np.ndarray, pB: float, params: np.ndarray,
                         chunk: int = 1 << 20, device=None):
    """Host wrapper: flat uint16 [a0,b0,a1,b1,...] like the native path;
    returns (best int32[n], prob float64[n]) as numpy arrays."""
    dev = resolve_device(device)
    counts = np.asarray(counts).reshape(-1, 2)
    n = len(counts)
    best = np.empty(n, np.int32)
    prob = np.empty(n, np.float64)
    for s in range(0, n, chunk):
        c = torch.from_numpy(counts[s:s + chunk].astype(np.float64)).to(dev)
        bb, pp, _ = genotype_calls(c[:, 0], c[:, 1], pB, params)
        best[s:s + len(c)] = bb.cpu().numpy()
        prob[s:s + len(c)] = pp.cpu().numpy()
    return best, prob


# ------------------------------------ (b) the posterior batch, bit-exact

def posterior_tables(counts: np.ndarray, pB: float, params: np.ndarray):
    """The host half of ``genotype_batch_device``: (q float64[5, M + 1],
    p float64[15]), M the largest count. ``q[l, c]`` is the native
    ``fgx_dnbinom_mu(c, size_l, mu_l)`` for every count c present in
    ``counts`` (0 elsewhere, never read); ``p`` is the native prior of
    ``fgx_genotype_probabilities`` (native/fastgt_exact.c:182-232), its
    groupings kept, in double arithmetic but for the reference's float
    ``sqrtf`` expression."""
    from genometester4_tpu_torch.utils.native import get_lib
    lib = get_lib()
    counts = np.asarray(counts, np.uint16).reshape(-1)
    pb = float(np.float32(pB))     # the C float argument
    pa = 1 - pb
    l_viga, p_0, p_1, p_2, lam, size, size2 = (
        float(v) for v in np.asarray(params, np.float32))
    p = [p_0, pa * p_1, pb * p_1, pa * pa * p_2, 2 * pa * pb * p_2,
         pb * pb * p_2]
    p_lisa = 1 - p_0 - p_1 - p_2
    if p_lisa >= 0:
        # (-1 + sqrtf (1 + 4 * p_lisa)) / 2: the double argument rounded
        # to float, then float arithmetic, widened on assignment
        f = np.float32
        pl1 = float((f(-1) + np.sqrt(f(1 + 4 * p_lisa))) / f(2))
        pl2 = pl1 * pl1
    else:
        pl1 = pl2 = 0.0
    for i, (x, n) in enumerate(_POLY_BINOM):
        p.append(lib.fgx_dbinom(x, n, pa) * (pl1 if i < 4 else pl2))
    mu = (l_viga, lam / 2, lam, lam * 1.5, lam * 2)
    sz = (size + size2 * l_viga, size + size2 * lam / 2,
          size + size2 * lam, size + size2 * lam * 1.5,
          size + size2 * lam * 2)
    present = np.unique(counts)
    q = np.zeros((5, int(present[-1]) + 1 if len(present) else 1),
                 np.float64)
    for lvl in range(5):
        for c in present.tolist():
            q[lvl, c] = lib.fgx_dnbinom_mu(c, sz[lvl], mu[lvl])
    return q, np.array(p, np.float64)


def _fan_out(counts: np.ndarray, pB: float, params: np.ndarray, device,
             chunk: int):
    """Yields (a float64[15, m], sum[m], best int64[m], a[best] [m]) on
    the device for each chunk of m markers, in the native order of
    operations."""
    dev = resolve_device(device)
    q, p = posterior_tables(counts, pB, params)
    q = torch.from_numpy(q).to(dev)
    p = torch.from_numpy(p).to(dev)[:, None]
    lvl_a = torch.from_numpy(np.ascontiguousarray(GT_MU[:, 0])).to(dev)
    lvl_b = torch.from_numpy(np.ascontiguousarray(GT_MU[:, 1])).to(dev)
    pairs = np.asarray(counts, np.uint16).reshape(-1, 2)
    for s in range(0, len(pairs), chunk):
        c = torch.from_numpy(pairs[s:s + chunk].astype(np.int32)).to(dev)
        c = c.to(torch.int64)
        qa = q[:, c[:, 0]]                    # [5, m]
        qb = q[:, c[:, 1]]
        a = (qa[lvl_a] * qb[lvl_b]) * p       # [15, m], two roundings
        total = a[0].clone()
        best = torch.zeros(a.shape[1], dtype=torch.int64, device=dev)
        top = a[0].clone()
        for j in range(1, N_GENOTYPES):
            total = total + a[j]
            win = a[j] > top                  # NaN never wins
            best = torch.where(win, j, best)
            top = torch.where(win, a[j], top)
        yield a, total, best, top


def genotype_batch_device(counts: np.ndarray, pB: float, params: np.ndarray,
                          device=None, chunk: int = 1 << 20):
    """The posterior batch on ``device`` (None: CUDA): flat uint16
    [a0,b0,a1,b1,...] -> (a float64[n,15], sum float64[n], best
    uint32[n]), bit-equal to ``models.fastgt_native.genotype_batch``."""
    n = np.asarray(counts).size // 2
    out_a = np.empty((n, N_GENOTYPES), np.float64)
    out_sum = np.empty(n, np.float64)
    out_best = np.empty(n, np.uint32)
    s = 0
    for a, total, best, _ in _fan_out(counts, pB, params, device, chunk):
        e = s + a.shape[1]
        out_a[s:e] = a.T.cpu().numpy()
        out_sum[s:e] = total.cpu().numpy()
        out_best[s:e] = best.cpu().numpy()
        s = e
    return out_a, out_sum, out_best


def genotype_best_device(counts: np.ndarray, pB: float, params: np.ndarray,
                         device=None, chunk: int = 1 << 20):
    """``genotype_batch_device`` copying back only what gmer_caller prints
    without ``--alternatives``: (a[i, best[i]] float64[n], sum float64[n],
    best uint32[n]), 20 bytes a marker instead of 132."""
    n = np.asarray(counts).size // 2
    out_top = np.empty(n, np.float64)
    out_sum = np.empty(n, np.float64)
    out_best = np.empty(n, np.uint32)
    s = 0
    for _, total, best, top in _fan_out(counts, pB, params, device, chunk):
        e = s + len(total)
        out_top[s:e] = top.cpu().numpy()
        out_sum[s:e] = total.cpu().numpy()
        out_best[s:e] = best.cpu().numpy()
        s = e
    return out_top, out_sum, out_best
