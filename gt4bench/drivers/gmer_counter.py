"""gmer_counter's window: passes of one FASTQ lane through FastGT's count
mode against the whole marker database, then ``finalize``.

Set-up builds the database as ``formats.gmerdb`` holds it (``GmerDB`` and
``finalize_lookup``, from the generated marker words, in place of parsing a
1 GB ``db.txt``) and ``pipelines.gmercount.DBCounter(db, device=...)``, and
runs one pass. The window runs ``add_file(lane)`` until ``--seconds`` have
passed, then ``finalize()``: what ``cli/gmer_counter.py`` runs after its
database parse. ``format_counts`` (under 1% of a 30x sample) is left out.
The plain reference counts every marker word among the reads' canonical
windows and judges each database slot's clamped count.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from gt4bench.gen.genome import codes_of, genome_bases, rng_for
from gt4bench.gen.markers import canonical_np, draw_markers
from gt4bench.gen.reads import draw_reads, fastq_bytes, reads_for_lane
from gt4bench.reference.kmers import lane_counts


class MarkerNames:
    """The database's node names, made on demand (``rs<i>``): count mode
    needs only their number."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> bytes:
        if not 0 <= i < self.n:
            raise IndexError(i)
        return b"rs%d" % i


class Driver:
    kind = "count"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str,
                 workdir: str, over: dict):
        self.cfg = {**cfg, **over.get("config", {})}
        self.traffic = {**traffic, **over.get("traffic", {})}
        self.seed = seed
        self.device = device
        self.workdir = workdir
        self.k = int(self.cfg["word_length"])
        self.passes = 0
        self.stages: dict[str, float] = {}
        self.limit = (1 << int(self.cfg["count_bits"])) - 1

    def make_inputs(self):
        """The source genome, the lane (as a FASTQ file and as 2-bit
        reads) and the marker words, from the seed."""
        t = self.traffic
        src = genome_bases(rng_for(self.seed, 0), int(t["source"]["bases"]),
                           t["genome"])
        lane = t["lane"]
        n_reads = reads_for_lane(int(lane["bytes"]), int(lane["read_len"]))
        reads = draw_reads(rng_for(self.seed, 1), src, n_reads, lane)
        self.lane = os.path.join(self.workdir, "lane.fq")
        fastq_bytes(reads).tofile(self.lane)
        self.read_codes = codes_of(reads)
        del reads
        db_p = {**self.cfg["db"], "word_length": self.k}
        self.markers, self.n_on = draw_markers(
            rng_for(self.seed, 2), codes_of(src), db_p, self.device)

    def setup(self):
        t = time.perf_counter()
        self.make_inputs()
        self.stages["inputs"] = time.perf_counter() - t
        t = time.perf_counter()
        db = self._db()
        self.stages["database: GmerDB and finalize_lookup"] = \
            time.perf_counter() - t
        t = time.perf_counter()
        self.counter = self._counter(db)
        self.stages["DBCounter: decode and upload"] = time.perf_counter() - t
        t = time.perf_counter()
        self.counter.add_file(self.lane, int(self.cfg["slab_bytes"]))
        if self.device == "cuda":
            torch.cuda.synchronize()
        self.passes = 1   # the warm-up pass, judged with the window's
        self.stages["warm-up pass"] = time.perf_counter() - t

    def _db(self):
        from genometester4_tpu_torch.formats.gmerdb import GmerDB
        n, per = self.markers.shape
        words, dirs = canonical_np(self.markers.reshape(-1), self.k)
        db = GmerDB(wordsize=self.k, node_bits=(n + 1).bit_length(),
                    kmer_bits=per.bit_length(),
                    count_bits=int(self.cfg["count_bits"]),
                    names=MarkerNames(n),
                    node_kmers_start=np.arange(n, dtype=np.uint64)
                    * np.uint64(per),
                    node_nkmers=np.full(n, per, np.uint32),
                    kmer_words=words, kmer_dirs=dirs)
        db.finalize_lookup()
        return db

    def _counter(self, db):
        from genometester4_tpu_torch.pipelines.gmercount import DBCounter
        return DBCounter(db, chunk_bases=int(self.cfg["chunk_bases"]),
                         device=self.device)

    def window(self, seconds: float):
        from gt4bench.run import Job
        jobs = []
        bases = self.read_codes.size
        slab = int(self.cfg["slab_bytes"])
        t0 = time.perf_counter()
        end = t0
        while end - t0 < seconds:
            a = time.perf_counter()
            self.counter.add_file(self.lane, slab)
            end = time.perf_counter()
            jobs.append(Job(a, end, bases))
        self.counter.finalize()   # reads the counts back: the sync
        if self.device == "cuda":
            torch.cuda.synchronize()
        self.passes += len(jobs)
        return t0, time.perf_counter(), jobs

    def span_patches(self, spans):
        from genometester4_tpu_torch.io import fasta
        return [(fasta, "iter_code_slabs",
                 spans.gen(fasta.iter_code_slabs, "parse"))]

    def release(self):
        self.counts = self.counter.result.clamped(
            int(self.cfg["count_bits"]))
        self.counter = None

    def expected(self, passes: int, limit: int) -> np.ndarray:
        """The reference's count of each database slot after ``passes``
        passes of the lane, clamped at ``limit``."""
        per_lane = lane_counts(self.read_codes, self.markers.reshape(-1),
                               self.k, self.device)
        return np.minimum(per_lane.astype(np.uint64) * np.uint64(passes),
                          np.uint64(limit))

    def check(self, run):
        """Each database slot's count against the reference's: the
        occurrences among one lane's windows, times the passes, clamped as
        the configuration's counters clamp."""
        want = self.expected(self.passes, self.limit)
        wrong = int((np.asarray(self.counts, np.uint64) != want).sum())
        n_reads, L = self.read_codes.shape
        step = int(self.cfg["chunk_bases"]) - (self.k - 1)
        codes = n_reads * (L + 1)
        run.work.update(
            bases=len(run.jobs) * self.read_codes.size,
            windows=len(run.jobs) * n_reads * (L - self.k + 1),
            chunks=len(run.jobs) * -(-(codes - (self.k - 1)) // step),
            db_words=self.markers.size)
        return ({"count_slots_wrong": (wrong, 0)},
                len(run.jobs) if wrong else 0)

    def control(self, passes: int):
        """The control in the program's place: the reference's counts in
        the next precision below the configuration's counters (8 bits,
        clamped at 255), judged as ``check`` judges the program's."""
        want = self.expected(passes, self.limit)
        got = np.minimum(want, np.uint64(255))
        return {"count_slots_wrong": int((got != want).sum())}
