"""gmer_caller CLI — flag-compatible with the reference
(src/gmer_caller.c:471-540); the port's copy of
``genometester4_tpu/cli/gmer_caller.py``.

Usage: gmer_caller ARGUMENTS COUNTS_FILE

    python -m genometester4_tpu_torch.cli.gmer_caller --model diploid counts.txt

The posterior fan-out runs on the device (CUDA by default, and no CUDA
raises; ``main(argv, device="cpu")`` runs it on the CPU);
``GT4_TPU_CALLER_IMPL=host`` takes the native batch. torch is imported
only for the device route.
"""

from __future__ import annotations

import sys

REF_VERSION = "4.2.16 (stable)"
MAX_THREADS = 32

HELP = f"""gmer_caller version {REF_VERSION}
Usage:
  gmer_caller ARGUMENTS COUNTS_FILE
Arguments:
    -v | --version      - Print version information and exit
    --training_size NUM - Use NUM markers for training (default 100000)
    --runs NUMBER       - Perfom NUMBER runs of model training (use 0 for no training)
    --num_threads NUM   - Use NUM threads (min 1, max {MAX_THREADS}, default {MAX_THREADS // 2})
    --header            - Print table header
    --non_canonical     - Output non-canonical genotypes
    --prob_cutoff       - probability cutoff for calling genotype (default 0)
    --alternatives      - Print probabilities of all alternative genotypes
    --info              - Print information about individual
    --no_genotypes      - Print only summary information, not actual genotypes
    --model TYPE        - Model type (full, diploid, haploid)
    --params PARAMS     - Model parameters (error, p0, p1, p2, coverage, size, size2)
    --coverage NUM      - Average coverage of reads
    -D                  - increase debug level
"""


def main(argv=None, device=None) -> int:
    """Run gmer_caller with ``argv`` (``sys.argv[1:]`` when None);
    ``device`` is where the posterior fan-out runs (None: CUDA)."""
    from genometester4_tpu_torch.pipelines.gmercall import (
        MODEL_DIPLOID, MODEL_FULL, MODEL_HAPLOID, DEFAULT_PARAMS, run_caller)

    from genometester4_tpu_torch.cli._cstrtol import atof, strtol_u32

    argv = list(sys.argv[1:] if argv is None else argv)
    call_fn = None
    nruns = 5
    max_training = 100000
    nthreads = MAX_THREADS // 2
    header = non_canonical = alternatives = info = 0
    print_gt = 1
    prob_cutoff = 0.0
    model = MODEL_FULL
    debug = 0
    params = DEFAULT_PARAMS.copy()
    params_specified = False
    # exact argv twin of src/gmer_caller.c:540-641: there is NO -h
    # flag (an unknown arg is the counts file; a second one errors),
    # numerics go through strtol/atof with no end-validation, and
    # every missing-value case prints usage to stderr with exit 1
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-v", "--version"):
            print(f"gmer_caller version {REF_VERSION}")
            return 0
        elif a == "-D":
            debug += 1
        elif a in ("--runs", "--training_size", "--num_threads",
                   "--prob_cutoff", "--coverage", "--model"):
            i += 1
            if i >= len(argv):
                sys.stderr.write(HELP)
                return 1
            v = argv[i]
            if a == "--runs":
                nruns = strtol_u32(v)[0]
            elif a == "--training_size":
                max_training = strtol_u32(v)[0]
            elif a == "--num_threads":
                nthreads = strtol_u32(v)[0]
            elif a == "--prob_cutoff":
                prob_cutoff = atof(v)
            elif a == "--coverage":
                params[4] = atof(v)
            else:
                model = {"full": MODEL_FULL, "diploid": MODEL_DIPLOID,
                         "haploid": MODEL_HAPLOID}.get(v)
                if model is None:
                    sys.stderr.write(HELP)
                    return 1
        elif a == "--header":
            header = 1
        elif a == "--non_canonical":
            non_canonical = 1
        elif a == "--params":
            # (aidx + 6) >= argc bound check, src/gmer_caller.c:608-611
            if i + 7 >= len(argv):
                sys.stderr.write(HELP)
                return 1
            for j in range(7):
                params[j] = atof(argv[i + 1 + j])
            params_specified = True
            i += 7
        elif a == "--alternatives":
            alternatives = 1
        elif a == "--info":
            info = 1
        elif a == "--no_genotypes":
            print_gt = 0
        else:
            if call_fn is not None:
                sys.stderr.write(HELP)
                return 1
            call_fn = a
        i += 1

    # neither warning exits (src/gmer_caller.c:641-650); the NULL
    # filename then dies inside gt4_mmap with EFAULT
    if call_fn is None:
        sys.stderr.write("No input file specified\n" + HELP)
    if nthreads < 1 or nthreads > MAX_THREADS:
        sys.stderr.write(f"Invalid number of threads {nthreads} - should be "
                         f"1-{MAX_THREADS}\n" + HELP)
        nthreads = min(max(nthreads, 1), MAX_THREADS)

    # "Reading %s..." precedes the mmap, so its (null)/%s form shows
    # even on the failure paths (src/gmer_caller.c:649-653)
    if debug:
        sys.stderr.write("Reading %s..."
                         % (call_fn if call_fn is not None else "(null)"))
    if call_fn is None:
        sys.stderr.write("gt4_mmap (stat): Bad address\n"
                         "Cannot read (null)\n")
        return 1
    from genometester4_tpu_torch.utils.gt4mmap import gt4_mmap_fail
    mf = gt4_mmap_fail(call_fn)
    if mf is not None:
        sys.stderr.write(mf)
        sys.stderr.write(f"Cannot read {call_fn}\n")
        return 1
    with open(call_fn, "rb") as f:
        data = f.read()

    return run_caller(data, sys.stdout, model=model, nruns=nruns,
                      max_training=max_training, nthreads=nthreads,
                      header=bool(header), non_canonical=bool(non_canonical),
                      prob_cutoff=prob_cutoff,
                      alternatives=bool(alternatives), info=bool(info),
                      print_gt=bool(print_gt), params0=params,
                      params_specified=params_specified,
                      debug=debug, version_str=REF_VERSION, device=device)


if __name__ == "__main__":
    raise SystemExit(main())
