"""numpy-free glistcompare N-list union/intersection fast path (the
port's copy of ``genometester4_tpu/pipelines/setops_stream.py``, on the
port's ``utils.native.load_raw``).

The multi-list op is already one native streaming k-way merge
(fgx_multi_stream_*), but the generic pipeline pays the numpy import
before the merge starts — enough to put an 8x4M-list union at 0.8x the
reference (round-3 audit). This module runs the same merge from stdlib
mmap + ctypes alone for plain .list inputs; index inputs or odd headers
return None and the numpy pipeline handles them. Output bytes are
identical either way (same kernel, same writer split).
"""

from __future__ import annotations

import ctypes
import mmap
import os
import struct
import sys

from genometester4_tpu_torch.pipelines.subset_fast import (GT4_LIST_CODE,
                                                     _HEADER,
                                                     _WRITE_CHUNK)

# src/glistcompare.c:586-588 progress tick (kept in sync with
# pipelines/listcompare.PROGRESS_TICK without importing it — that
# module imports numpy)
PROGRESS_TICK = 100_000_000

# listcompare.RULES numbers accepted by the native merge
_RINT = {"add": 1, "sum": 1, "min": 3, "max": 4, "number": 7}


def _open_list(path):
    """(mmap, ctypes_records, n_words, word_length) or None."""
    try:
        with open(path, "rb") as f:
            head = f.read(_HEADER.size)
    except OSError:
        return None
    if len(head) < _HEADER.size:
        return None
    code, vmaj, vmin, wlen, n_words, total, start, wb, cb = \
        _HEADER.unpack(head)
    if code != GT4_LIST_CODE:
        return None
    if vmin >= 3:
        if wb != 8 or cb != 4:
            return None
    elif vmin == 0:
        start = 40
    size_needed = start + 12 * n_words
    if os.path.getsize(path) < size_needed:
        return None
    if n_words == 0:
        return (None, (ctypes.c_ubyte * 12)(), 0, wlen)
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), size_needed, access=mmap.ACCESS_COPY)
    recs = (ctypes.c_ubyte * (12 * n_words)).from_buffer(mm, start)
    return (mm, recs, n_words, wlen)


def try_fast_multi(paths, op: str, outputname: str, cutoff: int,
                   rule: str, count_override: int, count_only: bool,
                   debug: int):
    """Return {op: (n_words, total_count)} on success, None to fall
    back to the generic pipeline (index inputs, odd headers)."""
    eff = rule
    if rule not in _RINT and rule != "default":
        eff = "number"
    if eff == "default":
        eff = "add" if op == "union" else "min"
    srcs = []
    try:
        for p in paths:
            s = _open_list(p)
            if s is None:
                return None
            srcs.append(s)
        wlen = srcs[0][3]
        from genometester4_tpu_torch.utils.native import load_raw
        lib = load_raw()
        lib.fgx_multi_stream_start.restype = ctypes.c_void_p
        n = len(srcs)
        ptrs = (ctypes.c_void_p * n)()
        lens = (ctypes.c_long * n)()
        for i, (_mm, recs, nw, _wl) in enumerate(srcs):
            ptrs[i] = ctypes.addressof(recs)
            lens[i] = nw
        st = ctypes.c_void_p(lib.fgx_multi_stream_start(
            ptrs, lens, ctypes.c_int(n),
            ctypes.c_int(1 if op == "intrsec" else 0),
            ctypes.c_int(_RINT[eff]), ctypes.c_uint(cutoff),
            ctypes.c_uint(count_override)))
        if not st:
            raise MemoryError("multi stream allocation failed")
        suffix = "union" if op == "union" else "intrsec"
        out_path = f"{outputname}_{wlen}_{suffix}.list"
        tmp = "%s.tmp.%d" % (out_path, os.getpid())
        CHUNK = 1 << 20
        buf = (ctypes.c_ubyte * (12 * CHUNK))()
        n_out = ctypes.c_long(0)
        s_out = ctypes.c_ulonglong(0)
        n_words = 0
        total = 0
        # buffering=0: BufferedWriter's extra copy interacts badly with
        # this VM's dirty-page throttling (measured 0.75-11 s for the
        # same 384 MB the raw fd writes in ~0.4 s); raw FileIO issues
        # one write(2) per 1 MB chunk, the size ListWriter also uses
        f = open(tmp, "wb", buffering=0) if not count_only else None
        try:
            if f is not None:
                f.write(_HEADER.pack(GT4_LIST_CODE, 4, 2, wlen, 0, 0,
                                     _HEADER.size, 8, 4))
            more = 1
            while more:
                more = lib.fgx_multi_stream_next(
                    st, buf, CHUNK, ctypes.byref(n_out),
                    ctypes.byref(s_out))
                m = n_out.value
                if not m:
                    continue
                if f is not None:
                    view = memoryview(buf)[: 12 * m]
                    for i in range(0, len(view), _WRITE_CHUNK):
                        f.write(view[i:i + _WRITE_CHUNK])
                prev = n_words
                n_words += m
                total += int(s_out.value)
                if debug:
                    b = (prev // PROGRESS_TICK + 1) * PROGRESS_TICK
                    while b <= n_words:
                        sys.stderr.write("Words written: %uM\n"
                                         % (b // 1_000_000))
                        b += PROGRESS_TICK
            if f is not None:
                f.seek(0)
                f.write(_HEADER.pack(GT4_LIST_CODE, 4, 2, wlen, n_words,
                                     total, _HEADER.size, 8, 4))
        finally:
            if f is not None:
                f.close()
            lib.fgx_multi_stream_free(st)
        if not count_only:
            os.replace(tmp, out_path)
        return {op: (n_words, total)}
    finally:
        # drop the exported ctypes views before closing the mmaps
        while srcs:
            mm, recs, _nw, _wl = srcs.pop()
            del recs
            if mm is not None:
                try:
                    mm.close()
                except BufferError:
                    pass
