"""kmer_predictor CLI — trait prediction from per-sample k-mer counts
(reference: src/kmer-predictor.c).
The port's copy of ``genometester4_tpu/cli/kmer_predictor.py``.

NOTE: the reference program is bit-rotted — it does not compile against
its own tree (accesses pre-refactor GT4WordSArrayInstance fields like
``all_inst->idx``, src/kmer-predictor.c:141-218), so no differential
oracle exists; this implements the source's documented semantics.

Model (src/kmer-predictor.c:140-230): over the first n-20 training
samples, each panel k-mer gets a[w] = mean trait of samples WITHOUT the
k-mer and b[w] = count-weighted mean trait of samples WITH it; a
sample's raw prediction is the sum of a/b over the panel, rescaled by a
linear regression of raw predictions onto true traits. Results print to
stderr as NAME TRUE PREDICTED.

Vectorization: the reference zipper-walks N list streams per panel word;
here every sample list is joined against the panel once (batched
searchsorted) and the per-word accumulators run vectorized over words
while looping samples in order — keeping the reference's left-to-right
double summation order (accumulation order i is the rounding order).
Per-sample prediction sums use cumsum to preserve sequential rounding.
"""

from __future__ import annotations

import sys

import numpy as np

REF_VERSION = "4.2.16 (stable)"
DELTA = 20
MAX_LISTS = 1024

HELP = f"""kmer_predictor version {REF_VERSION}
Usage: kmer_predictor OPTIONS
Options:
    -v, --version            - print version information and exit
    -h, --help               - print this usage screen and exit
    --kmers FILENAME         - panel k-mer list (.list)
    --lists FILENAME         - table of NAME LIST_FILE TRAIT lines
    --write_coefficients F   - write per-kmer coefficients
    --max_kmers NUM          - use at most NUM panel k-mers
    -D                       - increase debug level
"""


def _seq_sum(values: np.ndarray) -> float:
    """Left-to-right double summation (C loop rounding order)."""
    if len(values) == 0:
        return 0.0
    return float(np.cumsum(values.astype(np.float64))[-1])


def linear_regression(x: np.ndarray, y: np.ndarray):
    """src/kmer-predictor.c:241-266 (note: r is never assigned on the
    success path in the reference — uninitialized; we return 0)."""
    n = len(x)
    sx = _seq_sum(x)
    sy = _seq_sum(y)
    sx2 = _seq_sum(x * x)
    sy2 = _seq_sum(y * y)
    sxy = _seq_sum(x * y)
    d = n * sx2 - sx * sx
    if d == 0:
        return 0.0, 0.0, 0.0
    a = (sy * sx2 - sx * sxy) / d
    b = (n * sxy - sx * sy) / d
    d2 = (n * sx2 - sx * sx) * (n * sy2 - sy * sy)
    if d2 <= 0:
        return 0.0, 0.0, 0.0
    return a, b, 0.0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    kmers_name = lists_name = write_coeffs_name = None
    max_kmers = 1000000000
    i = 0
    try:
        while i < len(argv):
            a = argv[i]
            if a in ("-v", "--version"):
                print(f"kmer_predictor version {REF_VERSION}")
                return 0
            elif a in ("-h", "--help", "-?"):
                print(HELP)
                return 0
            elif a == "--kmers":
                i += 1
                kmers_name = argv[i]
            elif a == "--lists":
                i += 1
                lists_name = argv[i]
            elif a == "--write_coefficients":
                i += 1
                write_coeffs_name = argv[i]
            elif a == "--max_kmers":
                i += 1
                max_kmers = int(argv[i])
            elif a == "-D":
                pass
            else:
                sys.stderr.write(f"Unknown argument: {a}!\n" + HELP)
                return 1
            i += 1
    except (IndexError, ValueError):
        sys.stderr.write(HELP)
        return 1
    if not kmers_name or not lists_name:
        sys.stderr.write(HELP)
        return 1

    from genometester4_tpu_torch.formats.gmerdb import _split_line
    from genometester4_tpu_torch.formats.list_format import read_list

    with open(lists_name, "rb") as f:
        data = f.read()
    sample_names, list_names, ffs = [], [], []
    pos = 0
    while pos < len(data) and len(sample_names) < MAX_LISTS:
        end = data.find(b"\n", pos)
        if end < 0:
            end = len(data)
        toks = _split_line(data, pos, end, 4)
        if len(toks) == 3:
            sample_names.append(data[toks[0][0]:toks[0][1]].decode("latin1"))
            list_names.append(data[toks[1][0]:toks[1][1]].decode("latin1"))
            try:
                ffs.append(float(data[toks[2][0]:toks[2][1]]))
            except ValueError:
                ffs.append(0.0)
        pos = end + 1
    n_lists = len(sample_names)
    ffs = np.asarray(ffs, np.float64)
    avg_ff = _seq_sum(ffs) / n_lists
    ffs = ffs - avg_ff

    _, panel_words, _ = read_list(kmers_name)
    panel_words = np.asarray(panel_words)[:min(len(panel_words), max_kmers)]
    nw = len(panel_words)

    # per-sample count vectors aligned to the panel
    count_mat = np.zeros((n_lists, nw), np.float64)
    for si, ln in enumerate(list_names):
        try:
            _, w, c = read_list(ln)
        except OSError:
            sys.stderr.write(f"Cannot open list {ln}\n")
            return 1
        w = np.asarray(w)
        idx = np.searchsorted(w, panel_words)
        idx_c = np.minimum(idx, max(len(w) - 1, 0))
        hit = (len(w) > 0) & (w[idx_c] == panel_words)
        count_mat[si] = np.where(hit, np.asarray(c)[idx_c], 0)

    n_train = n_lists - DELTA
    avg0 = np.zeros(nw)
    avg1 = np.zeros(nw)
    cnt0 = np.zeros(nw)
    cnt1 = np.zeros(nw)
    nzero = np.zeros(nw)
    for si in range(n_train):  # sample order = reference summation order
        c = count_mat[si]
        has = c > 0
        avg1 = np.where(has, avg1 + c * ffs[si], avg1)
        cnt1 = np.where(has, cnt1 + c, cnt1)
        avg0 = np.where(has, avg0, avg0 + ffs[si])
        cnt0 = np.where(has, cnt0, cnt0 + 1)
        nzero = np.where(has, nzero, nzero + 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        a = np.where(cnt0 > 0, avg0 / cnt0, 0.0)
        b = np.where(cnt1 > 0, avg1 / cnt1, 0.0)
    scale = (nzero * (n_lists - nzero)) / float(n_lists * n_lists)

    pred_ffs = np.zeros(n_lists)
    for si in range(n_lists):
        vals = np.where(count_mat[si] > 0, b, a)
        pred_ffs[si] = _seq_sum(vals)

    pa, pb, pr = linear_regression(pred_ffs[:n_train], ffs[:n_train])

    if write_coeffs_name:
        with open(write_coeffs_name, "w") as f:
            f.write("AVG_FF\t%.3g\n" % avg_ff)
            f.write("SCALE\t%g\t%g\t%g\n" % (pa, pb, pr))
            for i in range(nw):
                f.write("%g\t%g\n" % (a[i], b[i]))

    for si in range(n_lists):
        pred = pa + pb * pred_ffs[si]
        sys.stderr.write("%s\t%.3f\t%.3f\n" % (sample_names[si],
                                               ffs[si] + avg_ff,
                                               pred + avg_ff))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
