"""glistcompare's window: jobs of one sample lane through the port's two
CLIs, back to back, each to its end.

A job is what a user runs to split a sample against its reference genome,
in this process: ``glistmaker lane.fq -w 25 -o sample`` and then
``glistcompare sample_25.list genome_25.list -u -i -d -dd -o cmp``, each
through the CLI's ``main(argv, device=...)``. Set-up makes the inputs
(``gen.sample``), writes the reference genome's list once with the plain
reference (``genome_25.list``), and runs one job, which is judged with the
window's. Every job runs the same files: glistmaker's own ``ListWriter``
writes ``sample_25.list`` in the run's work directory, the hand-off between
the two commands, and the next job replaces it.

**The seam.** The four outputs go to ``drivers.glistmaker.ListSink``
instead of files: the driver replaces
``genometester4_tpu_torch.pipelines.listcompare.ListWriter`` alone, so the
program's ``listmaker.ListWriter`` stays real. A sink keeps its output's
header and the CRC-32 of its records.

``check`` reads one number: the outputs of every job (four a job, the
warm-up's included) whose header or record CRC differs from the plain
reference's (``reference.setops``: the lane's canonical list, then the
four operations against the genome's list). The union adds the sample
list's count to the genome's known one, so it pins every count of the
sample list: the outputs judge step 1 too.
"""

from __future__ import annotations

import contextlib
import io
import os
import time

import torch

from gt4bench.drivers.glistmaker import ListSink
from gt4bench.gen.sample import make_lane_sample
from gt4bench.reference import kmers
from gt4bench.reference import setops as ref

SUFFIXES = {"_union.list": "union", "_intrsec.list": "intrsec",
            "_diff1.list": "diff1", "_diff2.list": "diff2"}


def op_of(path: str) -> str | None:
    """The operation whose output ``path`` is, by glistcompare's file
    names."""
    return next((op for s, op in SUFFIXES.items() if path.endswith(s)),
                None)


class Driver:
    kind = "list"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str,
                 workdir: str, over: dict):
        self.cfg = {**cfg, **over.get("config", {})}
        self.traffic = {**traffic, **over.get("traffic", {})}
        self.seed = seed
        self.device = device
        self.workdir = workdir
        self.k = int(self.cfg["word_length"])
        self.stages: dict[str, float] = {}
        self.sinks: list[ListSink] = []
        self.ops: list = []           # the op of each sink of the job
        self.jobs_out: list[list] = []   # per job, its (op, sink) pairs

    def make_inputs(self):
        """The source, the lane and the genome's list, from the seed."""
        self.sample = make_lane_sample(self.seed, self.traffic, self.workdir)
        words, counts = kmers.genome_list(self.sample.source_codes, self.k,
                                          self.device)
        paths = {"lane.fq": self.sample.lane_fq,
                 "genome_25.list": os.path.join(self.workdir,
                                                "genome_25.list")}
        ref.write_list_file(paths["genome_25.list"], words, counts, self.k)
        self.genome = (words.cpu(), counts.cpu())   # for the reference
        del words, counts
        if self.device == "cuda":
            torch.cuda.empty_cache()
        for name in ("sample", "sample_25.list", "cmp"):
            paths[name] = os.path.join(self.workdir, name)
        self.make_argv = [paths.get(a, a) for a in self.cfg["make_args"]]
        self.compare_argv = [paths.get(a, a)
                             for a in self.cfg["compare_args"]]

    def setup(self):
        t = time.perf_counter()
        self.make_inputs()
        self.stages["inputs and the genome's list"] = time.perf_counter() - t
        t = time.perf_counter()
        from genometester4_tpu_torch.pipelines import listcompare
        from gt4bench.spans import patched
        self._seam = patched([(listcompare, "ListWriter", self._sink)])
        self._seam.__enter__()
        self.job()   # warm-up: every shape of the cell's jobs
        self.stages["program import and warm-up job"] = \
            time.perf_counter() - t

    def _sink(self, path, word_length, atomic=True):
        self.ops.append(op_of(str(path)))
        return ListSink(self, path, word_length, atomic)

    def job(self) -> None:
        from genometester4_tpu_torch.cli import glistcompare, glistmaker
        self.sinks, self.ops = [], []
        with contextlib.redirect_stdout(io.StringIO()):
            rc = glistmaker.main(self.make_argv, device=self.device)
            if rc:
                raise RuntimeError(f"glistmaker exited with {rc}")
            rc = glistcompare.main(self.compare_argv, device=self.device)
            if rc:
                raise RuntimeError(f"glistcompare exited with {rc}")
        if self.device == "cuda":
            torch.cuda.synchronize()
        self.jobs_out.append(list(zip(self.ops, self.sinks)))

    def window(self, seconds: float):
        from gt4bench.run import Job
        jobs = []
        bases = self.sample.read_codes.size
        t0 = time.perf_counter()
        end = t0
        while end - t0 < seconds:
            a = time.perf_counter()
            self.job()
            end = time.perf_counter()
            jobs.append(Job(a, end, bases))
        return t0, end, jobs

    def span_patches(self, spans):
        from genometester4_tpu_torch.pipelines import listcompare, listmaker
        return [(listmaker, "iter_code_slabs",
                 spans.gen(listmaker.iter_code_slabs, "parse")),
                (listmaker, "count_chunks",
                 spans.gen(listmaker.count_chunks, "count")),
                (listmaker, "merge_sorted_shards",
                 spans.gen(listmaker.merge_sorted_shards, "merge")),
                (listmaker, "make_list", spans.call(listmaker.make_list,
                                                    "make")),
                (listcompare, "compare_pair",
                 spans.call(listcompare.compare_pair, "compare"))]

    def release(self):
        self._seam.__exit__(None, None, None)

    def expected(self, canonical: bool = True) -> dict:
        """The reference's four outputs' ``.list`` (header, CRC-32) and
        sizes, from the lane's reads and the genome's list."""
        sw, sc = ref.reads_list(self.sample.read_codes, self.k, self.device,
                                canonical)
        self.sample_words = sw.numel()
        gw, gc = (t.to(self.device) for t in self.genome)
        outputs = ref.set_ops(sw, sc, gw, gc)
        del sw, sc
        return ref.expected_files(outputs, self.k)

    @staticmethod
    def outputs_wrong(pairs, want: dict) -> int:
        """A job's outputs whose header or CRC differs from ``want``'s,
        each output missing, and each output the job made twice."""
        got = {}
        extra = 0
        for op, sink in pairs:
            if op in got or op not in want:
                extra += 1
            got[op] = sink
        return extra + sum(op not in got or got[op].header is None
                           or (got[op].header, got[op].crc) != want[op][0]
                           for op in want)

    def check(self, run):
        want = self.expected()
        wrong = [self.outputs_wrong(pairs, want) for pairs in self.jobs_out]
        n = len(run.jobs)
        reads, length = self.sample.read_codes.shape
        # for the list step's rooflines: kernel A's windows, no window
        # spanning two reads, and the words of the sample's list
        run.work.update(bases=n * self.sample.read_codes.size,
                        windows=n * reads * max(length - self.k + 1, 0),
                        unique=n * self.sample_words,
                        words_out=n * sum(v[1] for v in want.values()))
        # the window's jobs are the last of jobs_out; the first is the
        # warm-up's, judged as well
        return ({"compare_outputs_wrong": (sum(wrong), 0)},
                sum(w > 0 for w in wrong[-n:]) if n else 0)

    def control(self, passes: int):
        """The control in the program's place: the reference with the
        canonical guarantee broken on the sample side (forward-strand
        windows only), judged as ``check`` judges a job."""
        want = self.expected()
        got = self.expected(canonical=False)
        return {"compare_outputs_wrong": sum(got[op][0] != want[op][0]
                                             for op in want)}
