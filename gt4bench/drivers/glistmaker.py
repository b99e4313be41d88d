"""glistmaker's window: whole ``make_list`` jobs, back to back.

Each job is ``pipelines.listmaker.make_list([fasta], k, out, ...)`` on one
genome of the traffic mix, in turn, as ``cli/glistmaker.py`` calls it. Its
``.list`` goes to ``ListSink`` instead of a file: the one seam the
benchmark replaces (``listmaker.ListWriter``), so that no run writes
gigabytes. The sink packs every record with the program's own
``pack_records`` and keeps the header and a CRC-32 of the record bytes;
the plain reference judges both for every job once the window has closed.
"""

from __future__ import annotations

import os
import time
import zlib

import numpy as np
import torch

from gt4bench.gen.genome import codes_of, fasta_bytes, genome_bases, rng_for
from gt4bench.reference.kmers import genome_list, list_file
from gt4bench.spans import patched


class ListSink:
    """The interface of ``formats.list_format.ListWriter`` that
    ``make_list`` uses, keeping no file: the header it would write at
    ``close`` and the CRC-32 of its record bytes."""

    def __init__(self, owner, path, word_length: int, atomic: bool = True):
        from genometester4_tpu_torch.formats import list_format
        self._fmt = list_format
        self.word_length = word_length
        self.n_words = 0
        self.total_count = 0
        self.crc = 0
        self.header = None
        owner.sinks.append(self)

    def append(self, words, counts):
        if len(words) == 0:
            return
        recs = self._fmt.pack_records(np.asarray(words, dtype=np.uint64),
                                      np.asarray(counts, dtype=np.uint32))
        self.crc = zlib.crc32(recs, self.crc)
        self.n_words += len(words)
        self.total_count += int(np.asarray(counts, dtype=np.uint64).sum())

    def append_records(self, rec_bytes, n_words: int, total_count: int):
        if n_words == 0:
            return
        self.crc = zlib.crc32(np.ascontiguousarray(rec_bytes), self.crc)
        self.n_words += n_words
        self.total_count += int(total_count)

    def close(self):
        hdr = self._fmt.ListHeader(self.word_length, self.n_words,
                                   self.total_count)
        self.header = hdr.pack()
        return hdr

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()


class Driver:
    kind = "list"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str,
                 workdir: str, over: dict):
        self.cfg = {**cfg, **over.get("config", {})}
        self.traffic = {**traffic, **over.get("traffic", {})}
        self.seed = seed
        self.device = device
        self.workdir = workdir
        self.mesh_devices = over.get("mesh_devices")
        self.k = int(self.cfg["word_length"])
        self.sinks: list[ListSink] = []
        self.stages: dict[str, float] = {}
        self.jobs_out: list[tuple[int, list]] = []   # (input, its sinks)

    def make_inputs(self):
        """The traffic mix's genomes from the seed, each as a FASTA file."""
        g = self.traffic["genomes"]
        self.bases = []
        self.paths = []
        for i in range(int(g["count"])):
            b = genome_bases(rng_for(self.seed, i), int(g["bases"]),
                             self.traffic["genome"])
            path = os.path.join(self.workdir, f"genome{i}.fa")
            with open(path, "wb") as f:
                f.write(fasta_bytes(b"g%d generated" % i, b,
                                    int(g["line_width"])))
            self.bases.append(b)
            self.paths.append(path)

    def setup(self):
        t = time.perf_counter()
        self.make_inputs()
        self.stages["inputs"] = time.perf_counter() - t
        t = time.perf_counter()
        from genometester4_tpu_torch.pipelines import listmaker
        self.lm = listmaker
        self.mesh = None
        if self.mesh_devices:
            from genometester4_tpu_torch.parallel.sharding import make_mesh
            self.mesh = make_mesh(devices=self.mesh_devices)
        self._seam = patched([(listmaker, "ListWriter",
                               lambda path, k, atomic=True:
                               ListSink(self, path, k, atomic))])
        self._seam.__enter__()
        self.job(0)   # warm-up: every shape of the cell's jobs
        self.stages["program import and warm-up job"] = \
            time.perf_counter() - t

    def job(self, i: int) -> None:
        self.sinks = []
        cfg = self.cfg
        self.lm.make_list([self.paths[i]], self.k,
                          os.path.join(self.workdir, "out.list"),
                          min_count=int(cfg["min_count"]),
                          max_count=int(cfg["max_count"]),
                          chunk_bases=int(cfg["chunk_bases"]),
                          slab_bytes=int(cfg["slab_bytes"]),
                          device=self.device, mesh=self.mesh)
        if self.device == "cuda":
            torch.cuda.synchronize()
        self.jobs_out.append((i, self.sinks))

    def window(self, seconds: float):
        from gt4bench.run import Job
        jobs = []
        n_in = len(self.paths)
        t0 = time.perf_counter()
        end = t0
        while end - t0 < seconds:
            i = len(jobs) % n_in
            a = time.perf_counter()
            self.job(i)
            end = time.perf_counter()
            jobs.append(Job(a, end, len(self.bases[i])))
        return t0, end, jobs

    def span_patches(self, spans):
        from genometester4_tpu_torch.parallel import sharding
        lm = self.lm
        return [(lm, "iter_code_slabs", spans.gen(lm.iter_code_slabs,
                                                  "parse")),
                (lm, "count_chunks", spans.gen(lm.count_chunks, "count")),
                (sharding, "count_kmers_sharded",
                 spans.call(sharding.count_kmers_sharded, "count")),
                (lm, "merge_sorted_shards",
                 spans.gen(lm.merge_sorted_shards, "merge")),
                (ListSink, "append", spans.call(ListSink.append, "write")),
                (ListSink, "close", spans.call(ListSink.close, "write"))]

    def release(self):
        self._seam.__exit__(None, None, None)
        self.lm = self.mesh = None

    def expected(self, inputs, canonical: bool = True):
        """Per input: the reference's .list (header, records' CRC-32) and
        its number of records."""
        out = {}
        for i in sorted(set(inputs)):
            words, counts = genome_list(codes_of(self.bases[i]), self.k,
                                        self.device, canonical)
            hdr, crc, n = list_file(words, counts, self.k)
            out[i] = ((hdr, crc), n)
            del words, counts
        return out

    def check(self, run):
        """Every job's ``.list`` against the reference's; the work the
        window's jobs did, for the rooflines."""
        want = self.expected(i for i, _ in self.jobs_out)
        bad = [len(sinks) != 1 or sinks[0].header is None
               or (sinks[0].header, sinks[0].crc) != want[i][0]
               for i, sinks in self.jobs_out]
        # the window's jobs are the last of jobs_out; the first is the
        # warm-up's, judged as well
        window_inputs = [i for i, _ in self.jobs_out[-len(run.jobs):]]
        run.work.update(
            bases=sum(len(self.bases[i]) for i in window_inputs),
            windows=sum(len(self.bases[i]) - self.k + 1
                        for i in window_inputs),
            unique=sum(want[i][1] for i in window_inputs))
        return ({"list_jobs_wrong": (sum(bad), 0)},
                sum(bad[-len(run.jobs):]))

    def control(self, passes: int):
        """The control in the program's place: every input listed by the
        reference with the canonical guarantee broken (forward-strand
        words), judged as ``check`` judges a job."""
        inputs = range(len(self.bases))
        want = self.expected(inputs)
        got = self.expected(inputs, canonical=False)
        return {"list_jobs_wrong": sum(got[i][0] != want[i][0]
                                       for i in inputs)}
