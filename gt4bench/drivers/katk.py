"""KATK's window: jobs of one sample stretch through the port's two CLIs,
back to back, each to its end.

A job is what a user runs for a sample, in this process:
``gmer_counter -db db.txt --compile_index sample.idx reads.fq`` and then
``gassembler --dbi sample.idx --region_file regions.txt --num_threads 1
--sex female``, each through the CLI's ``main(argv, device=...)``. Both
write their standard output into an in-memory sink of their own:
gmer_counter's count table is dropped, gassembler's calls are kept and
judged. Set-up makes the inputs (``gen.katk``) and runs one job, which is
judged with the window's.

**The tap.** The window wraps the program's
``ops.swalign_cuda.sw_matrices_batch_device_multi``, the entry of every
alignment fill of a job. It observes and substitutes nothing: the program
gets the very arrays its fill returned. Of the window's launches a seeded
one in ``tap_every`` (the first at a seeded offset) is kept: its inputs
(each region's reference and read codes) and a copy of its outputs. The
CRC-32 of each lane's three matrices is taken after the window, so no job
waits on it, and judged against the reference fill's.
The benchmark's other seam, glistmaker's ``.list`` sink, is unused here.

``check`` reads three numbers: the read index entries of every judged
job's ``.idx`` (read by ``reference.katk.gt4i_keys``) that differ from
the reference's, the tapped lanes whose CRC differs from the reference
fill's on the same inputs, and, largest over the judged jobs, the judged
planted variants called wrong plus the non-reference calls elsewhere in
judged regions.
"""

from __future__ import annotations

import contextlib
import io
import os
import time

import numpy as np
import torch

from gt4bench.gen.genome import rng_for
from gt4bench.gen.katk import make_sample
from gt4bench.reference import katk as ref


FILL = "sw_matrices_batch_device_multi"


def _room(a: np.ndarray) -> int:
    """Bytes of ``a``, rounded up to 8."""
    return -(-a.nbytes // 8) * 8


class _Arena:
    """Host memory written through before the window opens, which the tap
    copies launches' outputs into: a launch's ~63 MB into fresh pages took
    50-65 ms on the H100's host, 1.5-2.3% of a job at one launch in 32.
    Past its end a copy takes fresh memory."""

    def __init__(self, nbytes: int):
        self.buf = np.ones(nbytes, np.uint8)
        self.at = 0

    def copy(self, a: np.ndarray) -> np.ndarray:
        n = _room(a)
        if self.at + n > len(self.buf):
            return np.array(a)
        out = self.buf[self.at:self.at + a.nbytes].view(a.dtype).reshape(
            a.shape)
        self.at += n
        np.copyto(out, a)
        return out


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
        self.stages: dict[str, float] = {}
        self.judged: list = []      # (index keys, calls text) of each job
        self.taps: list = []        # (region inputs, outputs or CRCs)
        self.n_window = 0

    def make_inputs(self):
        self.sample = make_sample(self.seed, self.traffic, self.workdir)
        paths = {"reads.fq": self.sample.reads_fq,
                 "db.txt": self.sample.db_txt,
                 "regions.txt": self.sample.regions_txt,
                 "sample.idx": os.path.join(self.workdir, "sample.idx")}
        self.idx = paths["sample.idx"]
        self.index_argv = [paths.get(a, a) for a in self.cfg["index_args"]]
        self.asm_argv = [paths.get(a, a)
                         for a in self.cfg["gassembler_args"]]

    def setup(self):
        from gt4bench.spans import patched
        from genometester4_tpu_torch.ops import swalign_cuda
        t = time.perf_counter()
        self.make_inputs()
        self.stages["inputs"] = time.perf_counter() - t
        t = time.perf_counter()
        fill = swalign_cuda.sw_matrices_batch_device_multi
        sizes = []

        def sized(region_inputs, *args, **kwargs):
            out = fill(region_inputs, *args, **kwargs)
            sizes.append(sum(_room(a) for m in out for a in m))
            return out

        with patched([(swalign_cuda, FILL, sized)]):
            self._judge(self._job())
        self.warm = (time.perf_counter() - t, len(sizes), max(sizes))
        self.stages["warm-up job"] = self.warm[0]

    def _job(self) -> str:
        """One sample through both CLIs; gassembler's standard output."""
        from genometester4_tpu_torch.cli import gassembler, gmer_counter
        with contextlib.redirect_stdout(io.StringIO()):
            rc = gmer_counter.main(self.index_argv, device=self.device)
        if rc:
            raise RuntimeError(f"gmer_counter exited with {rc}")
        calls = io.StringIO()
        with contextlib.redirect_stdout(calls):
            rc = gassembler.main(self.asm_argv, device=self.device)
        if rc:
            raise RuntimeError(f"gassembler exited with {rc}")
        if self.device == "cuda":
            torch.cuda.synchronize()
        return calls.getvalue()

    def _judge(self, calls: str):
        """Keep what ``check`` judges of the job that just ended: its
        index's keys (read now: the next job overwrites the file) and its
        calls."""
        s = self.sample
        keys = ref.gt4i_keys(self.idx, s.record_bytes, len(s.read_codes))
        self.judged.append((keys, calls))

    def _tap(self, fill, arena=None):
        """``fill`` wrapped: a seeded one in ``tap_every`` of its launches
        keeps its inputs and its outputs, copied into ``arena`` for CRCs
        after the window, or its lanes' CRCs at once without one."""
        every = int(self.cfg["tap_every"])
        offset = int(rng_for(self.seed, 9).integers(0, every))
        launches = [0]

        def tapped(region_inputs, *args, **kwargs):
            out = fill(region_inputs, *args, **kwargs)
            i = launches[0]
            launches[0] += 1
            if i % every == offset:
                kept = [(np.array(r), np.array(b)) for r, b in region_inputs]
                self.taps.append((kept, self._crcs(out) if arena is None
                                  else [tuple(map(arena.copy, m))
                                        for m in out]))
            return out
        return tapped

    def _arena(self, seconds: float) -> "_Arena":
        """Room for the outputs of the tapped launches of twice the jobs
        that the warm-up's pace gives ``seconds``."""
        wall, launches, most = self.warm
        jobs = 2 + int(2 * seconds / wall)
        return _Arena(jobs * (launches // int(self.cfg["tap_every"]) + 1)
                      * most)

    @staticmethod
    def _crcs(out) -> list:
        return [ref.lane_crcs(m) for m in out]

    def window(self, seconds: float):
        from gt4bench.run import Job
        from gt4bench.spans import patched
        from genometester4_tpu_torch.ops import swalign_cuda
        tap = [(swalign_cuda, FILL, self._tap(
            swalign_cuda.sw_matrices_batch_device_multi,
            self._arena(seconds)))]
        jobs = []
        bases = self.sample.bases
        t0 = time.perf_counter()
        end = t0
        with patched(tap):
            while end - t0 < seconds:
                a = time.perf_counter()
                calls = self._job()
                end = time.perf_counter()
                jobs.append(Job(a, end, bases))
                self._judge(calls)
        self.n_window = len(jobs)
        return t0, end, jobs

    def span_patches(self, spans):
        from genometester4_tpu_torch.io import fasta
        return [(fasta, "iter_code_slabs",
                 spans.gen(fasta.iter_code_slabs, "parse"))]

    def release(self):
        pass

    def _want_keys(self, canonical: bool = True) -> np.ndarray:
        return ref.read_index(self.sample.read_codes, self.sample.db_words,
                              self.k, self.device, canonical)

    def _calls_wrong(self, calls: str) -> int:
        s = self.sample
        return ref.calls_wrong(calls, s.regions, s.judged, s.variants)

    def _lanes_wrong(self, taps) -> list:
        """Per tapped launch, its lanes whose CRC differs from the
        reference fill's."""
        out = []
        for kept, got in taps:
            crcs = got if isinstance(got[0], list) else self._crcs(got)
            want = [ref.lane_crcs(m)
                    for m in ref.fill_regions(kept, self.device)]
            out.append(sum(a != b for got, exp in zip(crcs, want)
                           for a, b in zip(got, exp)))
        return out

    def check(self, run):
        want = self._want_keys()
        index_wrong = [ref.entries_wrong(keys, want)
                       for keys, _ in self.judged]
        calls_wrong = [self._calls_wrong(c) for _, c in self.judged]
        lanes_wrong = self._lanes_wrong(self.taps)
        lim = self.cfg["limits"]
        # the window's jobs (the warm-up is the first judged) whose index
        # or calls are wrong; every one where a tapped lane is
        bad = (self.n_window if sum(lanes_wrong) > lim["sw_lanes_wrong"]
               else sum(i > lim["index_entries_wrong"]
                        or c > lim["calls_wrong"]
                        for i, c in zip(index_wrong[1:], calls_wrong[1:])))
        run.work.update(bases=len(run.jobs) * self.sample.bases,
                        tapped_launches=len(self.taps),
                        tapped_lanes=sum(len(b) for kept, _ in self.taps
                                         for _, b in kept))
        return ({"index_entries_wrong": (sum(index_wrong),
                                         lim["index_entries_wrong"]),
                 "sw_lanes_wrong": (sum(lanes_wrong),
                                    lim["sw_lanes_wrong"]),
                 "calls_wrong": (max(calls_wrong), lim["calls_wrong"])},
                bad)

    def control(self, passes: int):
        """The control in the program's place: the reference's index with
        only forward-strand windows, and one job whose every fill is the
        reference's in int8 scores, tapped at every launch; judged as
        ``check`` judges the program's."""
        from gt4bench.spans import patched
        from genometester4_tpu_torch.ops import swalign_cuda

        def int8_fill(region_inputs, device=None):
            return ref.fill_regions(region_inputs, self.device, score_bits=8)

        self.cfg["tap_every"] = 1
        self.taps = []
        with patched([(swalign_cuda, FILL, self._tap(int8_fill))]):
            calls = self._job()
        return {"index_entries_wrong": ref.entries_wrong(
                    self._want_keys(canonical=False), self._want_keys()),
                "sw_lanes_wrong": sum(self._lanes_wrong(self.taps)),
                "calls_wrong": self._calls_wrong(calls)}
