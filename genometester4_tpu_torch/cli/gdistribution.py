"""gdistribution CLI — count-frequency histogram of LIST2 over LIST1's
words (reference: src/gdistribution.c).
The port's copy of ``genometester4_tpu/cli/gdistribution.py``.

NOTE: the reference program is bit-rotted — it includes ``wordmap.h``/
old-API ``wordmap_new`` which no longer exist in the tree and has no
Makefile rule, so no differential oracle exists; this implements the
source's complete semantics (the file IS complete, unlike gmasker whose
``main`` never calls its masking loop).

Semantics (src/gdistribution.c:81-142): zipper the two sorted lists;
for every word of LIST1 processed before LIST2 exhausts, record
``(float) count2`` when the word is present in LIST2 and ``0`` when it
is absent (LIST2-only words record nothing); sort the float array
ascending and print run-length groups as ``%g\t%u`` to stdout. The
``debug`` flag is compiled to 1 upstream (src/gdistribution.c:26), so
the stderr trace lines always print.

The zipper exits when EITHER list exhausts, so the recorded set is
exactly the LIST1 words ``<= max(LIST2)`` (src/gdistribution.c:97-115);
an empty intersection buffer returns before sorting
(src/gdistribution.c:117-119).
"""

from __future__ import annotations

import sys


def main(argv: list[str] | None = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if len(argv) < 2:
        # src/gdistribution.c:46-48,57-60: usage to stderr, exit 1
        sys.stderr.write("gdistribution LIST LIST2\n")
        return 1
    import numpy as np
    names = argv[:2]
    sys.stderr.write("%s %s\n" % (names[0], names[1]))

    from genometester4_tpu_torch.pipelines.listcompare import read_word_source
    try:
        h1, w1, c1 = read_word_source(names[0])
        h2, w2, c2 = read_word_source(names[1])
    except (OSError, ValueError) as e:
        # the reference would dereference a NULL wordmap here (no check
        # at src/gdistribution.c:67-68) — print a clean error instead
        sys.stderr.write("gdistribution: %s\n" % e)
        return 1

    sys.stderr.write("Total size %d\n" % (h1.n_words + h2.n_words))
    sys.stderr.write("Finding intersection\n")

    w1 = np.asarray(w1, np.uint64)
    w2 = np.asarray(w2, np.uint64)
    c2 = np.asarray(c2, np.uint32)
    if len(w1) and len(w2):
        # processed prefix: LIST1 words <= max(LIST2) (zipper exit rule)
        end = int(np.searchsorted(w1, w2[-1], side="right"))
        head = w1[:end]
        pos = np.searchsorted(w2, head)
        present = w2[np.minimum(pos, len(w2) - 1)] == head
        # freq = (float) count2, else 0 (src/gdistribution.c:101-111)
        freqs = np.where(present,
                         c2[np.minimum(pos, len(w2) - 1)].astype(np.float32),
                         np.float32(0))
    else:
        freqs = np.empty(0, np.float32)

    sys.stderr.write("Size %d\n" % len(freqs))
    if len(freqs) == 0:
        # src/gdistribution.c:117-119: return before sorting
        return 0

    sys.stderr.write("Sorting\n")
    freqs = np.sort(freqs, kind="stable")
    sys.stderr.write("Done\n")

    vals, counts = np.unique(freqs, return_counts=True)
    out = []
    for v, n in zip(vals.tolist(), counts.tolist()):
        # %g of the float32 value promoted to double
        out.append("%g\t%u\n" % (v, n))
    sys.stdout.write("".join(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
