"""Port vs JAX: gmer_caller (``pipelines.gmercall``, the CLI, and
``models.genotype``) on the CPU.

* The CLI: the port's ``main(argv, device="cpu")`` on its default route
  (the posterior fan-out in PyTorch) and on ``GT4_TPU_CALLER_IMPL=host``
  (the native batch) against the JAX CLI's ``GT4_TPU_CALLER_IMPL=host``,
  in-process: stdout, stderr and the exit code equal (tolerance 0). The
  cases are those of ``tests/test_gmercaller.py:65-155`` on its
  ``synth_counts`` inputs (numpy seeds), without the reference binary.
* The posterior batch: ``genotype_batch_device`` on the CPU against the
  native ``genotype_batch``, bit for bit on all three arrays (float64
  compared as uint64 bits), at counts 0 and 65,535, size <= 0, p0 + p1 +
  p2 > 1, pB 0 and 1.
* The model's functions: float64 PyTorch against JAX's float32 at the
  tolerances stated in each test, with the best calls equal off ties.
"""

import contextlib
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_cli_chrome import CASES as CHROME_CASES
from tests.test_gmercaller import synth_counts
from genometester4_tpu.cli import gmer_caller as jax_cli
from genometester4_tpu.models import genotype as jax_gt
from genometester4_tpu_torch.cli import gmer_caller as port_cli
from genometester4_tpu_torch.models import fastgt_native as native
from genometester4_tpu_torch.models import genotype as port_gt

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PARAMS = np.array([0.0547219, 4.2603e-05, 0.014934, 0.985023, 30.0, 65.48,
                   -0.6792684], np.float32)


def _run(main, args, cwd, **kw):
    out, err = io.StringIO(), io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(list(args), **kw)
    finally:
        os.chdir(old)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(params=["device", "host"])
def route(request):
    """The port's route: ``device`` (the default, GT4_TPU_CALLER_IMPL
    unset) or ``host``."""
    return request.param


def _both(tmp_path, text, flags, route, name="counts.txt"):
    """JAX's host route and the port's ``route`` on the same file."""
    if text is not None:
        (tmp_path / name).write_text(text)
    args = list(flags) + [name]
    old = os.environ.pop("GT4_TPU_CALLER_IMPL", None)
    try:
        os.environ["GT4_TPU_CALLER_IMPL"] = "host"
        rj = _run(jax_cli.main, args, tmp_path)
        if route == "device":
            del os.environ["GT4_TPU_CALLER_IMPL"]
        rp = _run(port_cli.main, args, tmp_path, device="cpu")
    finally:
        os.environ.pop("GT4_TPU_CALLER_IMPL", None)
        if old is not None:
            os.environ["GT4_TPU_CALLER_IMPL"] = old
    return rj, rp


@pytest.mark.parametrize("flags", [
    ["--runs", "0", "--coverage", "30"],
    ["--runs", "0", "--coverage", "30", "--header", "--info",
     "--alternatives"],
    ["--runs", "0", "--coverage", "30", "--prob_cutoff", "0.9"],
    ["--runs", "0", "--coverage", "30", "--non_canonical"],
    ["--runs", "0", "--coverage", "30", "--model", "diploid"],
    ["--runs", "0", "--coverage", "15", "--model", "haploid"],
    ["--runs", "0", "--coverage", "30", "--no_genotypes", "--info"],
    ["--runs", "0", "--coverage", "30", "-D", "--alternatives",
     "--prob_cutoff", "0.5"],
], ids=lambda f: " ".join(f))
def test_no_training_equal(tmp_path, route, flags):
    rng = np.random.default_rng(12345)
    rj, rp = _both(tmp_path, synth_counts(rng, n_a=1500, male=True), flags,
                   route)
    assert rj == rp and rj[0] == 0
    assert "--no_genotypes" in flags or rj[1].count("\n") > 1500


def test_trained_male_equal(tmp_path, route):
    rng = np.random.default_rng(1)
    rj, rp = _both(tmp_path, synth_counts(rng, male=True),
                   ["--header", "--info"], route)
    assert rj == rp and "#Sex\tM" in rj[1]


def test_trained_female_equal(tmp_path, route):
    rng = np.random.default_rng(2)
    rj, rp = _both(tmp_path, synth_counts(rng, male=False), ["--info"],
                   route)
    assert rj == rp and "#Sex\tF" in rj[1]


def test_trained_diploid_and_haploid_equal(tmp_path, route):
    """Node names that name no chromosome (gmer_counter's text database)
    under --model diploid, and a haploid run, both trained."""
    rng = np.random.default_rng(3)
    text = synth_counts(rng, n_a=2500, n_x=0, n_y=0)
    text = "".join(f"n{i:07d}\t" + line.split("\t", 1)[1] + "\n"
                   for i, line in enumerate(text.splitlines()))
    for flags in (["--model", "diploid", "--runs", "1", "--training_size",
                   "800", "--info"],
                  ["--model", "haploid", "--runs", "1", "--coverage",
                   "15"]):
        rj, rp = _both(tmp_path, text, flags, route)
        assert rj == rp and rj[1].count("\n") >= 2500


def test_params_pinned_equal(tmp_path, route):
    rng = np.random.default_rng(4)
    rj, rp = _both(tmp_path, synth_counts(rng, n_a=1200),
                   ["--runs", "0", "--params", "0.05", "4e-05", "0.015",
                    "0.985", "28.5", "65.48", "-0.6792684"], route)
    assert rj == rp


def test_training_size_subset_equal(tmp_path, route):
    rng = np.random.default_rng(5)
    rj, rp = _both(tmp_path, synth_counts(rng, n_a=3000),
                   ["--training_size", "1000", "--info"], route)
    assert rj == rp


def test_counter_to_caller_chain_equal(tmp_path, route):
    """FastGT's chain: the port's gmer_counter (CPU route) then both
    callers on its output."""
    from tests.test_gmercounter import make_db, make_reads
    from genometester4_tpu_torch.cli.gmer_counter import main as counter
    rng = np.random.default_rng(6)
    w = 14
    db_text, kmers = make_db(rng, n_nodes=40, kmers_per_node=2, w=w)
    (tmp_path / "db.txt").write_text(db_text)
    (tmp_path / "reads.fa").write_text(make_reads(
        rng, kmers, w, n_reads=2000, read_len=80, hit_prob=0.9))
    rc, out, _ = _run(counter, ["-db", "db.txt", "reads.fa"], tmp_path,
                      device="cpu")
    assert rc == 0
    rj, rp = _both(tmp_path, out, ["--runs", "0", "--coverage", "10",
                                   "--model", "diploid"],
                   route)
    assert rj == rp and rj[1].count("\n") >= 40


def test_short_marker_lines_equal(tmp_path, route):
    """Marker lines with fewer than 4 tokens (src/gmer_caller.c:148,157),
    among autosomes and X and Y markers."""
    rng = np.random.default_rng(7)
    lines = ["#gmer_counter version 4.2.16 (stable)", "#TextDatabase\tdb"]
    for i in range(36):
        a, b = int(rng.integers(0, 9)), int(rng.integers(0, 9))
        c = "1" if i < 30 else ("X" if i < 33 else "Y")
        lines.append(f"{c}_{i}\t1\t{a}" if i % 7 == 3
                     else f"{c}_{i}\t2\t{a}\t{b}")
    rj, rp = _both(tmp_path, "\n".join(lines) + "\n", [], route)
    assert rj == rp


def test_large_counts_equal(tmp_path, route):
    """Counts past 65,535 wrap to 16 bits, zero pairs are not called."""
    lines = [f"{c}_m{i}\t2\t{a}\t{b}" for i, (c, a, b) in enumerate(
        [(1, 0, 0), (2, 65535, 0), (3, 70000, 12), (4, 30, 30),
         (5, 65536, 65537), (6, 1, 200), ("X", 15, 0), ("Y", 14, 1)]
        * 20)]
    rj, rp = _both(tmp_path, "\n".join(lines) + "\n",
                   ["--runs", "0", "--coverage", "30", "--alternatives"],
                   route)
    assert rj == rp


@pytest.mark.parametrize("args,text", [
    ([], ""),
    ([], "no newline at all"),
    (["--runs", "0", "--model", "haploid"], "X_1\t2\t3\t4\n"),
    (["nofile.txt"], None),
], ids=["empty", "unterminated", "one_x_marker", "missing"])
def test_errors_equal(tmp_path, route, args, text):
    if text is None:
        rj, rp = _both(tmp_path, None, args[:-1], route, name=args[-1])
    else:
        rj, rp = _both(tmp_path, text, args, route)
    assert rj == rp


@pytest.mark.parametrize("args", [a for t, a in CHROME_CASES
                                  if t == "gmer_caller"],
                         ids=lambda a: " ".join(a) or "noargs")
def test_chrome_equal(tmp_path, args):
    rj = _run(jax_cli.main, args, tmp_path)
    rp = _run(port_cli.main, args, tmp_path, device="cpu")
    assert rj == rp


def test_debug_trained_run_equal_in_subprocesses(tmp_path):
    """-D with training, each CLI in a fresh process: the native
    library's own stderr lines are compared too."""
    rng = np.random.default_rng(8)
    (tmp_path / "c.txt").write_text(synth_counts(rng, n_a=800, n_x=100,
                                                 n_y=40))
    outs = []
    for pkg, env in (("genometester4_tpu", {"GT4_TPU_CALLER_IMPL": "host",
                                            "JAX_PLATFORMS": "cpu"}),
                     ("genometester4_tpu_torch", {})):
        code = ("import sys\n"
                f"from {pkg}.cli.gmer_caller import main\n"
                "kw = {} if 'torch' not in main.__module__ else "
                "{'device': 'cpu'}\n"
                "sys.exit(main(sys.argv[1:], **kw))\n")
        base = {k: v for k, v in os.environ.items()
                if k != "GT4_TPU_CALLER_IMPL"}
        r = subprocess.run(
            [sys.executable, "-c", code, "-D", "--info", "--runs", "1",
             "c.txt"], cwd=tmp_path, capture_output=True, timeout=300,
            env={**base, "PYTHONPATH": str(REPO), **env})
        outs.append((r.returncode, r.stdout, r.stderr))
    assert outs[0] == outs[1] and outs[0][0] == 0
    assert b"Training autosome" in outs[0][2]


# ----------------------------------------------------- the posterior batch

def _bits_equal(x, y):
    return (x.dtype == y.dtype and x.shape == y.shape
            and np.array_equal(x.view(np.uint64), y.view(np.uint64)))


def _params(**kw):
    p = PARAMS.copy()
    for i, name in enumerate(("err", "p0", "p1", "p2", "lam", "size",
                              "size2")):
        if name in kw:
            p[i] = kw[name]
    return p


@pytest.mark.parametrize("pB", [0.0, 1.0, 0.29, 0.123456789, 0.5])
@pytest.mark.parametrize("case", [
    {}, {"size": -100.0}, {"size": 0.0, "size2": 0.0},
    {"size": 2.0, "size2": -0.5},
    {"p0": 0.5, "p1": 0.4, "p2": 0.3},        # p0 + p1 + p2 > 1
    {"p0": 0.0, "p1": 0.0, "p2": 0.0},
    {"lam": 2.5}, {"lam": 0.0}, {"err": 0.0}, {"lam": 300.0},
], ids=lambda c: ",".join(f"{k}={v}" for k, v in c.items()) or "default")
def test_genotype_batch_device_bit_equal(pB, case):
    rng = np.random.default_rng(int(pB * 1000) + len(case))
    counts = rng.integers(0, 120, 6000).astype(np.uint16)
    counts[:8] = [0, 0, 65535, 0, 0, 65535, 65535, 65535]
    counts[8:400] = rng.integers(0, 65536, 392).astype(np.uint16)
    params = _params(**case)
    a, s, b = native.genotype_batch(counts, pB, params)
    a2, s2, b2 = port_gt.genotype_batch_device(counts, pB, params,
                                               device="cpu", chunk=1111)
    assert _bits_equal(a, a2) and _bits_equal(s, s2)
    assert b2.dtype == np.uint32 and np.array_equal(b, b2)
    top, s3, b3 = port_gt.genotype_best_device(counts, pB, params,
                                               device="cpu")
    assert _bits_equal(top, a[np.arange(len(b)), b])
    assert _bits_equal(s, s3) and np.array_equal(b, b3)


def test_genotype_batch_device_nan_and_empty():
    """NaN parameters: the native loop never picks a NaN (best 0); no
    markers at all."""
    counts = np.arange(40, dtype=np.uint16)
    params = _params(lam=float("nan"))
    a, s, b = native.genotype_batch(counts, 0.3, params)
    a2, s2, b2 = port_gt.genotype_batch_device(counts, 0.3, params,
                                               device="cpu")
    assert np.isnan(a).any()
    assert _bits_equal(a, a2) and _bits_equal(s, s2)
    assert np.array_equal(b, b2)
    empty = np.empty(0, np.uint16)
    a, s, b = port_gt.genotype_batch_device(empty, 0.3, PARAMS,
                                            device="cpu")
    assert a.shape == (0, 15) and len(s) == len(b) == 0


def test_posterior_tables_are_the_native_terms():
    """q is fgx_dnbinom_mu at each count present; one marker's a[g] is
    q[lvlA, ca] * q[lvlB, cb] * p[g] bit for bit."""
    counts = np.array([3, 41, 41, 0], np.uint16)
    q, p = port_gt.posterior_tables(counts, 0.37, PARAMS)
    assert q.shape == (5, 42) and len(p) == 15
    assert not q[:, 1:3].any()
    a, _, _ = native.genotype_batch(counts, 0.37, PARAMS)
    for i, (ca, cb) in enumerate(counts.reshape(-1, 2)):
        want = (q[port_gt.GT_MU[:, 0], ca] * q[port_gt.GT_MU[:, 1], cb]) * p
        assert _bits_equal(want, a[i])


# -------------------------------------------------------- the model (a)

def _jax_lp(ca, cb, pB, params):
    import jax.numpy as jnp
    return np.asarray(jax_gt.genotype_log_posteriors(
        jnp.asarray(ca, jnp.float32), jnp.asarray(cb, jnp.float32), pB,
        *[float(v) for v in params]), np.float64)


# p0 + p1 + p2 well below 1: the trained defaults (PARAMS) leave
# 1 - p0 - p1 - p2 ~ 4e-7, which float32 cancels to a few ulps, so JAX's
# polyploid priors (genotypes 6-14) carry an error of ~0.1 in log there
WELL = dict(p0=0.01, p1=0.1, p2=0.8)


@pytest.mark.parametrize("pB,lam,conditioned", [
    (0.37, 31.2, True), (0.05, 12.0, True), (0.5, 60.0, True),
    (0.29, 28.7, False)])
def test_log_posteriors_close_to_jax(pB, lam, conditioned):
    """Tolerance: |port - JAX| <= 2e-3 + 1e-4 |JAX| on every entry finite
    in JAX (float32 lgamma of values near 900 carries ~1e-4 relative);
    with the trained defaults' ill-conditioned 1 - p0 - p1 - p2, on
    genotypes 0-5 only. Where JAX's float32 prior floor underflows to 0
    (log = -inf), the port's float64 floor gives log(1e-300) or below."""
    rng = np.random.default_rng(int(lam))
    ca = rng.integers(0, 100, 500)
    cb = rng.integers(0, 100, 500)
    params = _params(lam=lam, **(WELL if conditioned else {}))
    want = _jax_lp(ca, cb, pB, params)
    got = port_gt._posteriors(torch.from_numpy(ca.astype(np.float64)),
                              torch.from_numpy(cb.astype(np.float64)), pB,
                              params).numpy()
    if not conditioned:
        want, got = want[:, :6], got[:, :6]
    fin = np.isfinite(want)
    assert fin.mean() > 0.5
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4, atol=2e-3)
    assert (got[~fin] <= np.log(1e-300) + 1e-9).all()


@pytest.mark.parametrize("conditioned", [True, False])
def test_genotype_calls_batch_close_to_jax(conditioned):
    """Best calls equal on every marker whose two best log posteriors
    (port, float64) are more than 1e-3 apart, against JAX and against the
    exact native calls; with well-conditioned priors also probabilities
    within 1e-3 there and neg_log_likelihood within 1e-5 relative."""
    rng = np.random.default_rng(9)
    params = _params(lam=28.7, **(WELL if conditioned else {}))
    pB = 0.29
    counts = rng.integers(0, 90, 2 * 5000).astype(np.uint16)
    best_j, prob_j = jax_gt.genotype_calls_batch(counts, pB, params)
    best_p, prob_p = port_gt.genotype_calls_batch(counts, pB, params,
                                                  chunk=1700, device="cpu")
    assert best_p.dtype == np.int32 and prob_p.dtype == np.float64
    c = torch.from_numpy(counts.reshape(-1, 2).astype(np.float64))
    lp = port_gt._posteriors(c[:, 0], c[:, 1], pB, params).numpy()
    top2 = np.sort(lp, axis=1)[:, -2:]
    off_tie = top2[:, 1] - top2[:, 0] > 1e-3
    assert off_tie.mean() > 0.99
    assert np.array_equal(best_p[off_tie], best_j[off_tie])
    _, _, best_n = native.genotype_batch(counts, pB, params)
    assert np.array_equal(best_p[off_tie], best_n[off_tie].astype(np.int32))
    if not conditioned:
        return
    np.testing.assert_allclose(prob_p[off_tie], prob_j[off_tie], atol=1e-3)
    import jax.numpy as jnp
    nll_j = float(jax_gt.neg_log_likelihood(
        jnp.asarray(c[:, 0].numpy(), jnp.float32),
        jnp.asarray(c[:, 1].numpy(), jnp.float32), pB, params))
    nll_p = float(port_gt.neg_log_likelihood(c[:, 0], c[:, 1], pB, params))
    assert abs(nll_p - nll_j) <= 1e-5 * abs(nll_j)


def test_genotype_calls_post_sums_to_one():
    c = torch.arange(0, 60, dtype=torch.float64)
    best, prob, post = port_gt.genotype_calls(c, c.flip(0), 0.3, PARAMS)
    assert post.shape == (60, 15) and best.dtype == torch.int32
    assert torch.allclose(post.sum(1), torch.ones(60, dtype=torch.float64))
    assert torch.equal(prob, post[torch.arange(60), best.long()])
