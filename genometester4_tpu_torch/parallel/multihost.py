"""Multi-process groups over ``torch.distributed`` (port of
``genometester4_tpu/parallel/multihost.py``).

One process per host (or per card, or N CPU processes in the tests) joins
one group; the group's mesh has one ``dp`` row per process, and row r holds
process r's own slots (``make_global_mesh``). Every process parses the same
inputs, so no input byte crosses processes: each runs only its own slots'
share of the work, and only results travel, all of them to process 0,
the one writer:

  glistmaker   the mesh counting step of ``parallel.sharding`` runs each
               process's row; column j's dp x kp deduplicated buckets come
               together on process 0 (``gather_to_writer``), which merges
               the columns, merges the steps and writes the ``.list``
  glistcompare the rank buckets are dealt round-robin over the global
               slots; each process runs its own parts and sends their
               outputs to process 0 (``send_to_writer``), which streams
               every part to the files in part order
  gmer_counter chunk g goes to global slot g mod (dp * kp); each process
               counts its own chunks, and ``finalize`` sums the count
               vector over the group (``all_sum_``), JAX's one psum

The writer publishes before anyone returns (``barrier``). Control flow
agrees across processes because every process sees the same slabs and the
same cuts; the only data-dependent branches (a bucket overflow, the
adapted bucket slack) take the group's maximum (``all_max``).

Activation, as in JAX::

    GT4_DIST_COORD=host0:29500 GT4_DIST_NPROCS=2 GT4_DIST_PROC_ID=<i> \\
        python -m genometester4_tpu_torch.cli.glistmaker in.fa -w 25

The group joins over TCP at ``GT4_DIST_COORD`` with gloo. Its collectives
time out after ``GT4_DIST_TIMEOUT`` seconds (default 600), so a process
that died or diverged makes the others fail instead of hang. Device
tensors travel over NCCL when no two processes of the group share a card
(one card a process, ``CUDA_VISIBLE_DEVICES``); otherwise, and on the
CPU, over gloo, staged through pinned host memory. ``transport()`` names
the choice. The kernels run on the card either way.

JAX's ``put_axis0_sharded``, ``put_replicated`` and ``_put_global_blocks``
have no counterpart: a process runs only its own slots' chunks or parts,
from the host arrays it holds, and no array spans processes.
"""

from __future__ import annotations

import atexit
import functools
import os
import socket
import sys
from datetime import timedelta

from genometester4_tpu_torch.utils import trace

DEFAULT_TIMEOUT_S = 600

# the device tensors' route, chosen once per layout by make_global_mesh:
# {"layout": every process's device ids, "name": "nccl" or "gloo",
#  "group": the NCCL group or None, "device": this process's first slot}
_transport: dict = {}


def _exchange(fn):
    """``fn``'s calls as the span "exchange", in which this process waits
    on the others; its staging to pinned memory is the span "stage", the
    bytes of the tensors it sends or receives the counter
    "exchange.bytes" (``tools.group_run`` reports all three)."""
    @functools.wraps(fn)
    def wrapper(*a, **kw):
        with trace.span("exchange", wait=True):
            return fn(*a, **kw)
    return wrapper


def distributed_env():
    """The (coord, nprocs, proc_id) triple from GT4_DIST_* env, or None."""
    coord = os.environ.get("GT4_DIST_COORD")
    if not coord:
        return None
    nprocs = int(os.environ.get("GT4_DIST_NPROCS", "1"))
    proc_id = int(os.environ.get("GT4_DIST_PROC_ID", "0"))
    if nprocs <= 1:
        return None
    return coord, nprocs, proc_id


def init_from_env() -> bool:
    """Join the process group described by GT4_DIST_* (idempotent).

    Returns True when this process is part of a >1-process group."""
    env = distributed_env()
    if env is None:
        return False
    import torch.distributed as dist
    if not dist.is_initialized():
        coord, nprocs, proc_id = env
        timeout = float(os.environ.get("GT4_DIST_TIMEOUT",
                                       DEFAULT_TIMEOUT_S))
        dist.init_process_group("gloo", init_method=f"tcp://{coord}",
                                world_size=nprocs, rank=proc_id,
                                timeout=timedelta(seconds=timeout))
        atexit.register(dist.destroy_process_group)
    return dist.get_world_size() > 1


def is_multiprocess() -> bool:
    """True when a multi-process group is configured AND joinable (joins
    it on the first call). Cheap when GT4_DIST_COORD is unset: no torch
    import."""
    if distributed_env() is None:
        return False
    return init_from_env()


def join_from_env() -> None:
    """The CLIs' join, before any device work: with a group configured,
    join it, and on every process but 0 send stdout to /dev/null (only
    process 0 prints)."""
    if distributed_env() is None or not init_from_env():
        return
    import torch.distributed as dist
    if dist.get_rank() != 0:
        sys.stdout = open(os.devnull, "w")


def _device_id(dev) -> tuple:
    """What tells two processes' slots apart: the host and the card's
    UUID (``cpu`` for the CPU)."""
    import torch
    card = (str(torch.cuda.get_device_properties(dev).uuid)
            if dev.type == "cuda" else "cpu")
    return socket.gethostname(), card


def _choose_transport(layout: list, local: list) -> None:
    """NCCL when every slot is a CUDA card and no card serves two
    processes (NCCL refuses two ranks on one card); else gloo, staged
    through pinned host memory. ``layout``: every process's device ids,
    the same list on every process, so every process decides alike (and
    ``new_group``, a collective, runs on all of them or none)."""
    if _transport.get("layout") == layout:
        return
    import torch
    import torch.distributed as dist
    owners = {}
    shared = False
    for r, ids in enumerate(layout):
        for i in set(ids):
            shared |= i[1] == "cpu" or owners.setdefault(i, r) != r
    group = None
    if not shared and dist.is_nccl_available():
        torch.cuda.set_device(local[0])
        group = dist.new_group(backend="nccl")
    _transport.clear()
    _transport.update(layout=layout, group=group, device=local[0],
                      name="gloo" if group is None else "nccl")


def transport():
    """``"nccl"`` or ``"gloo"``: how the group's device tensors travel;
    None before ``make_global_mesh``."""
    return _transport.get("name")


def make_global_mesh(devices=None):
    """The group's ("dp", "kp") mesh: one dp row per process, row r the
    devices of process r (every visible CUDA card, or ``devices``, a list
    of device names such as ``["cpu", "cpu"]``). A process knows only its
    own devices: the other rows hold None. Every process must bring the
    same number of slots (JAX's ``reshape(nproc, local)``). Its ``slots``
    are JAX's flat mesh (``make_flat_global_mesh``), process-major."""
    import torch
    import torch.distributed as dist

    from genometester4_tpu_torch.parallel.sharding import Mesh
    from genometester4_tpu_torch.utils.device import resolve_device
    if not is_multiprocess():
        raise RuntimeError("no process group: set GT4_DIST_COORD, "
                           "GT4_DIST_NPROCS > 1 and GT4_DIST_PROC_ID")
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    local = [resolve_device(d) for d in devices]
    local = [torch.device("cuda", torch.cuda.current_device())
             if d.type == "cuda" and d.index is None else d for d in local]
    me, n = dist.get_rank(), dist.get_world_size()
    layout = [None] * n
    dist.all_gather_object(layout, [_device_id(d) for d in local])
    counts = [len(ids) for ids in layout]
    if len(set(counts)) != 1 or not counts[0]:
        raise RuntimeError(f"process group: the processes bring {counts} "
                           f"slots; each needs the same number, at least 1")
    _choose_transport(layout, local)
    return Mesh(tuple(tuple(local) if r == me else (None,) * len(local)
                      for r in range(n)), rank=me)


def group_mesh(dev):
    """The group's mesh for a pipeline given ``device``: every visible
    card for a plain ``cuda``, else that one device."""
    whole = dev.type == "cuda" and dev.index is None
    return make_global_mesh(None if whole else [dev])


def barrier() -> None:
    """Cross-process barrier (the writer publishes before anyone
    returns)."""
    import torch.distributed as dist
    dist.barrier()


def all_max(values: list) -> list:
    """The group's element-wise maximum of a few ints (overflow flags,
    bucket peaks), over gloo."""
    import torch
    import torch.distributed as dist
    t = torch.tensor(values, dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.tolist()


def _staged(t):
    """A CPU copy of ``t`` for gloo: pinned when it comes from a card."""
    import torch
    if not t.is_cuda:
        return t.contiguous()
    with trace.span("stage"):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
    return host


def _on_nccl(t) -> bool:
    return _transport.get("group") is not None and t.is_cuda


@_exchange
def all_sum_(t) -> None:
    """Sum ``t`` over the group, in place, on every process."""
    import torch.distributed as dist
    trace.count("exchange.bytes", t.numel() * t.element_size())
    if _on_nccl(t):
        comm = t.to(_transport["device"])
        dist.all_reduce(comm, group=_transport["group"])
        t.copy_(comm)
        return
    host = _staged(t)
    dist.all_reduce(host)
    t.copy_(host)


@_exchange
def gather_to_writer(t):
    """Process 0: a list of every process's ``t`` (equal shapes and
    dtypes), on ``t``'s device, by rank; the others: None."""
    import torch
    import torch.distributed as dist
    me, n = dist.get_rank(), dist.get_world_size()
    trace.count("exchange.bytes",
                t.numel() * t.element_size() * (n - 1 if me == 0 else 1))
    if _on_nccl(t):
        comm = t.to(_transport["device"])
        got = ([torch.empty_like(comm) for _ in range(n)] if me == 0
               else None)
        dist.gather(comm, got, dst=0, group=_transport["group"])
    else:
        host = _staged(t)
        got = ([torch.empty_like(host) for _ in range(n)] if me == 0
               else None)
        dist.gather(host, got, dst=0)
    return None if got is None else [g.to(t.device) for g in got]


@_exchange
def send_to_writer(tensors: list) -> None:
    """Send 1-D tensors (any count, 0 included: an empty part still
    sends its header) to process 0, which takes them with
    ``recv_from``."""
    import torch
    import torch.distributed as dist
    ts = [t.reshape(-1).to(torch.int64) for t in tensors]
    nccl = bool(ts) and all(_on_nccl(t) for t in ts)
    dev = _transport["device"] if nccl else "cpu"
    group = _transport["group"] if nccl else None
    head = torch.tensor([len(ts), int(nccl)] + [t.numel() for t in ts],
                        dtype=torch.int64)
    dist.send(torch.tensor([head.numel()], dtype=torch.int64), 0)
    dist.send(head, 0)
    for t in ts:
        if t.numel():
            trace.count("exchange.bytes", t.numel() * 8)
            dist.send(t.to(dev) if nccl else _staged(t), 0, group=group)


@_exchange
def recv_from(src: int) -> list:
    """Process 0's side of ``send_to_writer``: the int64 tensors that
    process ``src`` sent, on its NCCL card or on the CPU."""
    import torch
    import torch.distributed as dist
    size = torch.empty(1, dtype=torch.int64)
    dist.recv(size, src)
    head = torch.empty(int(size), dtype=torch.int64)
    dist.recv(head, src)
    _, nccl, *numels = head.tolist()
    dev = _transport["device"] if nccl else "cpu"
    group = _transport["group"] if nccl else None
    out = []
    for m in numels:
        t = torch.empty(m, dtype=torch.int64, device=dev)
        if m:
            dist.recv(t, src, group=group)
        trace.count("exchange.bytes", m * 8)
        out.append(t)
    return out
