"""Runs one cell of the benchmark once and prints its result line.

    python3 -m gt4bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program
(``genometester4_tpu_torch``) and ``BENCHMARK.json``. Set-up makes the
cell's inputs from the seed, builds the program's state and runs one job to
warm every shape; the window then runs jobs back to back for ``--seconds``,
each to its end; the plain reference then judges every answer of the
window. ``--trace 1`` adds the benchmark's spans and ``torch.profiler`` and
reports the per-layer metrics instead of the end-to-end ones.

Without a CUDA card, or with another number of cards than the cell asks
for, the run exits with code 3 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
if __package__ in (None, ""):       # run as a script: make the checkout importable
    sys.path.insert(0, str(HERE.parent))

from gt4bench import manifest, peaks  # noqa: E402
from gt4bench.spans import Spans, patched  # noqa: E402

# top-level module names that no run may load: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "genometester4_tpu")
CACHE = HERE / "_cache"


@dataclass
class Job:
    t0: float
    t1: float
    bases: int


@dataclass
class Run:
    """What the metric readers read: the window, its jobs, the spans and
    the device trace of a traced run, and the work the window did."""
    kind: str
    t0: float
    t1: float
    jobs: list
    setup_s: float
    work: dict
    spans: Spans | None = None
    trace: object = None
    window_peak_bytes: int = 0

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def span_pct(self, name: str) -> float | None:
        if self.spans is None or name not in self.spans.names():
            return None
        return 100.0 * self.spans.seconds(name, self.t0, self.t1) \
            / self.window_s


def process_age() -> float:
    """Seconds since this process started (``/proc``), or since this
    module was loaded where there is no ``/proc``."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _LOADED


_LOADED = time.perf_counter()


def bytes_written() -> dict:
    out = {}
    try:
        with open("/proc/self/io") as f:
            for line in f:
                key, _, val = line.partition(":")
                if key in ("wchar", "write_bytes"):
                    out[key] = int(val)
    except OSError:
        pass
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def set_cache_dirs() -> None:
    """Every compiler cache the program could use, at fixed paths inside
    the checkout, so that only the first run of a cell there compiles."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict | None = None,
             log=print) -> dict:
    """One run of ``cell``: set-up, window, reference; the result line's
    object. ``device="cpu"`` and ``overrides`` (sizes, a mesh of CPU
    slots) serve the tests; a chip run passes neither."""
    import torch

    cuda = device == "cuda"
    drv_mod = manifest.driver(cell.config["driver"])
    workdir = tempfile.mkdtemp(prefix="gt4bench-")
    try:
        drv = drv_mod.Driver(cell.config, cell.traffic, seed, device,
                             workdir, overrides or {})
        drv.setup()
        if cuda:
            torch.cuda.synchronize()
        log("set-up stages (s): " + ", ".join(
            f"{k} {v!r}" for k, v in drv.stages.items()))
        setup_peak = _peak(torch, cell.chips) if cuda else 0
        if cuda:
            for d in range(cell.chips):
                torch.cuda.reset_peak_memory_stats(d)
        spans = Spans() if trace else None
        mark = contextlib.nullcontext()
        if trace:
            from torch.profiler import record_function

            from gt4bench import trace as tr
            prof = tr.profiler(cuda)
            prof.__enter__()
            mark = record_function(tr.MARK)
        setup_s = process_age()
        with patched(drv.span_patches(spans) if trace else []), mark:
            t0, t1, jobs = drv.window(seconds)
        dtrace = None
        if trace:
            prof.__exit__(None, None, None)
            tp = time.perf_counter()
            dtrace = tr.DeviceTrace(prof, t0, t1)
            log(f"trace read in {time.perf_counter() - tp:.3f} s; "
                f"{len(spans.rows)} spans")
            del prof
        window_peak = _peak(torch, cell.chips) if cuda else 0
        run = Run(drv.kind, t0, t1, jobs, setup_s, {}, spans, dtrace,
                  window_peak)
        drv.release()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        tr0 = time.perf_counter()
        checks, failed = drv.check(run)
        log(f"reference and comparison {time.perf_counter() - tr0:.3f} s")
        names = manifest.metrics(cell.name, trace)
        metrics = {}
        for m in names:
            value = manifest.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        for m in manifest.metrics(cell.name, False) if trace else []:
            value = manifest.metric_reader(m["name"])(run)
            if value is not None and m["name"] != "setup_s":
                log(f"under tracing, {m['name']} {value!r} {m['unit']}")
        result = {
            "correct": all(v <= lim for v, lim in checks.values()),
            "attempted": len(jobs), "failed": failed, "metrics": metrics,
            "device": _device(torch, cell.chips, max(setup_peak, window_peak),
                              dtrace, cuda)}
        if dtrace is not None:
            result["breakdown"] = {"device_ops": dtrace.top_ops(),
                                   "idle_gaps": dtrace.idle_gaps(spans)}
        result["checks"] = {k: {"value": v, "limit": lim}
                            for k, (v, lim) in checks.items()}
        log(f"jobs in the window: {len(jobs)}; window {t1 - t0!r} s; "
            f"set-up {setup_s!r} s; job walls (s): "
            + " ".join(f"{j.t1 - j.t0:.3f}" for j in jobs))
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _peak(torch, chips: int) -> int:
    return max(torch.cuda.max_memory_allocated(d) for d in range(chips))


def _device(torch, chips: int, peak: int, dtrace, cuda: bool) -> dict:
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": peak}
    if dtrace is not None:
        dev["busy_s"] = dtrace.busy_mean(chips)
        dev["window_s"] = dtrace.window_s
    return dev


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gt4bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("gt4bench: no CUDA device (torch.cuda.is_available() is "
              "false); the benchmark runs on the card only", file=sys.stderr)
        return 3
    cell = manifest.cell(args.workload)
    n = torch.cuda.device_count()
    if n != cell.chips:
        print(f"gt4bench: {args.workload} asks for {cell.chips} card(s); "
              f"this host shows {n}", file=sys.stderr)
        return 3
    for line in peaks.card_readings():
        print(f"card: {line}", flush=True)
    print(f"cell {cell.name}: config {cell.config_name}, traffic "
          f"{cell.traffic_name}, {n} card(s) {torch.cuda.get_device_name(0)}"
          f", seed {args.seed}, {args.seconds} s, trace {args.trace}",
          flush=True)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      log=lambda s: print(s, flush=True))
    bad = forbidden_modules()
    if bad:
        print("gt4bench: the run loaded " + ", ".join(bad), file=sys.stderr)
        return 4
    print(f"bytes written: {bytes_written()}", flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
