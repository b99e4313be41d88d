"""Run a process group (``parallel.multihost``) of the port's CLIs on one
host, and report what each process did.

One process of the group:

    GT4_DIST_COORD=127.0.0.1:29500 GT4_DIST_NPROCS=2 GT4_DIST_PROC_ID=<i> \
        python -m genometester4_tpu_torch.tools.group_run '<spec>'

``<spec>`` is a JSON object:

  tool        glistmaker, glistcompare, gmer_counter, make_union or
              make_intersection: the CLI whose ``main`` runs
  argv        its arguments
  device      "cpu", or null for CUDA
  local       null (the CLI's choice of this process's slots), or the
              device names of this process's slots, e.g. ["cpu", "cpu"]
  cap_factor  null, or the starting bucket slack of glistmaker's mesh count
              (``parallel.sharding.iter_count_kmers_sharded``)
  chunk_bases null, or gmer_counter's chunk (``pipelines.gmercount``)
  count       ["module:function", ...]: functions whose calls to count
  exit        null, or an exit code to leave with right after joining (a
              process that dies before the work)
  report      null, or a file for the report: {"rc", "wall" (s), "rank",
              "transport", "launches" (kernels A, B and E: the counters
              "launch.*"), "calls", "exchange" (from the spans of
              ``parallel.multihost``: "s", wall s in the exchanges,
              "stage_s", of which staging, and "bytes"), "files" (the
              working directory's when ``main`` returned)}

It runs in the working directory, with the tool's own stdout and stderr,
and records the program's spans (``utils.trace``) while ``main`` runs.
``launch`` starts a whole group on a free loopback port and collects each
process's exit code, output and report.
"""

from __future__ import annotations

import functools
import importlib
import json
import os
import sys
import time

TOOLS = {"glistmaker": ("glistmaker", "main"),
         "glistcompare": ("glistcompare", "main"),
         "gmer_counter": ("gmer_counter", "main"),
         "make_union": ("make_union", "main_union"),
         "make_intersection": ("make_union", "main_intersection")}


def _counted(name: str, calls: dict) -> None:
    """Wrap ``module:function`` so that ``calls[name]`` counts its
    calls."""
    mod_name, fn_name = name.split(":")
    mod = importlib.import_module(mod_name)
    fn = getattr(mod, fn_name)
    calls[name] = 0

    @functools.wraps(fn)
    def wrapper(*a, **kw):
        calls[name] += 1
        return fn(*a, **kw)
    setattr(mod, fn_name, wrapper)


def run(spec: dict) -> int:
    import torch

    from genometester4_tpu_torch.parallel import multihost, sharding
    from genometester4_tpu_torch.utils import trace

    if spec.get("device") == "cpu":
        torch.set_num_threads(1)
    multihost.join_from_env()
    if spec.get("exit") is not None:
        return int(spec["exit"])
    if spec.get("local"):
        local = list(spec["local"])
        multihost.group_mesh = lambda dev: multihost.make_global_mesh(local)
    if spec.get("cap_factor") is not None:
        sharding.count_kmers_sharded = functools.partial(
            sharding.count_kmers_sharded, cap_factor=spec["cap_factor"])
    if spec.get("chunk_bases"):
        from genometester4_tpu_torch.pipelines import gmercount

        class Counter(gmercount.DBCounter):
            def __init__(self, db, **kw):
                super().__init__(db, chunk_bases=spec["chunk_bases"], **kw)
        gmercount.DBCounter = Counter
    calls: dict = {}
    for name in spec.get("count") or []:
        _counted(name, calls)
    module, entry = TOOLS[spec["tool"]]
    main = getattr(importlib.import_module(
        f"genometester4_tpu_torch.cli.{module}"), entry)
    t0 = time.perf_counter()
    with trace.recording():
        rc = main(list(spec["argv"]), device=spec.get("device"))
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if spec.get("report"):
        import torch.distributed as dist
        files = sorted(os.listdir("."))
        took = {"exchange": 0.0, "stage": 0.0}
        for r in trace.rows():
            if r.name in took:
                took[r.name] += r.t1 - r.t0
        with open(spec["report"], "w") as f:
            json.dump({"rc": rc, "wall": wall, "rank": dist.get_rank(),
                       "transport": multihost.transport(),
                       "launches": {
                           "extract": trace.total("launch.extract"),
                           "run_marks": trace.total("launch.run_encode"),
                           "merge_runs": trace.total("launch.merge_runs")},
                       "calls": calls,
                       "exchange": {"s": took["exchange"],
                                    "stage_s": took["stage"],
                                    "bytes": trace.total("exchange.bytes")},
                       "files": files}, f)
    return rc


def free_port() -> int:
    """A TCP port free on the loopback interface just now."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(specs: list, cwds: list, envs=None, timeout: float = 300,
           dist_timeout: float = 60) -> list:
    """One process a spec, process i in ``cwds[i]`` with ``envs[i]`` added
    to the environment, joined as one group over loopback (collective
    timeout ``dist_timeout`` s). Returns [(rc, stdout bytes, stderr str,
    report dict or None)] by rank. A process still running after
    ``timeout`` s kills the whole group and raises TimeoutExpired; a
    coordinator port taken meanwhile (EADDRINUSE) makes one retry on
    another port."""
    import subprocess
    from pathlib import Path
    repo = str(Path(__file__).resolve().parents[2])
    envs = envs or [{}] * len(specs)
    for attempt in range(2):
        coord = f"127.0.0.1:{free_port()}"
        procs, reports = [], []
        for i, (spec, cwd, env) in enumerate(zip(specs, cwds, envs)):
            report = Path(cwd) / f".group_report.{i}.json"
            reports.append(report)
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "genometester4_tpu_torch.tools.group_run",
                 json.dumps({**spec, "report": str(report)})],
                cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                env={**os.environ, "PYTHONPATH": repo,
                     "GT4_DIST_COORD": coord,
                     "GT4_DIST_NPROCS": str(len(specs)),
                     "GT4_DIST_PROC_ID": str(i),
                     "GT4_DIST_TIMEOUT": str(dist_timeout), **env}))
        outs = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=timeout)
                outs.append((p.returncode, out,
                             err.decode(errors="replace")))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        taken = any("EADDRINUSE" in e or "address already in use" in
                    e.lower() for _, _, e in outs)
        if not (taken and attempt == 0):
            break
    res = []
    for (rc, out, err), report in zip(outs, reports):
        got = None
        if report.exists():
            got = json.loads(report.read_text())
            report.unlink()
        res.append((rc, out, err, got))
    return res


if __name__ == "__main__":
    sys.exit(run(json.loads(sys.argv[1])))
