"""numpy-free glistquery stat fast paths (--stat/--median/--distribution/--gc);
the port's copy of ``genometester4_tpu/pipelines/list_stats_fast.py``.

These commands are header reads plus at most one streaming pass over
the record blob; numpy's ~240 ms import (and torch's) would dominate
such runs. This module answers them with stdlib mmap +
ctypes into the native kernels (fgx_median_rec / fgx_distro_rec /
fgx_gc_rec, native/listkernel.c), byte-identical to the numpy pipeline
(reference semantics: src/glistquery.c:798-911).

``try_fast_stats`` returns an exit code when it fully handled the
command, or None to fall back to the generic pipeline — any open
error, non-.list input (except --stat on .index headers), version
surprise, or word-length mismatch bails so the generic path reproduces
the reference's error chrome exactly.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import struct
import sys

GT4_LIST_CODE = (ord("G") << 24) | (ord("T") << 16) | (ord("4") << 8) | ord("C")
GT4_INDEX_CODE = (ord("G") << 24) | (ord("T") << 16) | (ord("4") << 8) | ord("I")
_H44 = struct.Struct("<IIIIQQQII")
_H40 = struct.Struct("<IIIIQQQ")
_IDX_HEADER = struct.Struct("<IIIIQQIIIIQQQ")


class _ListInfo:
    __slots__ = ("path", "vmaj", "vmin", "k", "n_words", "total",
                 "list_start", "is_index")


def _read_info(path):
    """Parse a .list header (or .index header, marked is_index).
    Returns None on anything the generic path should handle."""
    try:
        with open(path, "rb") as f:
            head = f.read(72)
    except OSError:
        return None
    if len(head) < 16:
        return None
    code, vmaj, vmin, wlen = struct.unpack_from("<IIII", head, 0)
    if vmaj != 4:
        # gt4_word_map_new/gt4_index_map_new reject other majors with
        # their own stderr chrome — generic path owns that (round-4
        # fuzz_index_chrome finding)
        return None
    li = _ListInfo()
    li.path = path
    li.vmaj, li.vmin, li.k = vmaj, vmin, wlen
    if code == GT4_LIST_CODE:
        li.is_index = False
        if (vmaj, vmin) >= (4, 4):
            if len(head) < _H44.size:
                return None
            (_, _, _, _, n_words, total, start, wb, cb) = _H44.unpack_from(
                head, 0)
            if (wb, cb) != (8, 4):
                return None
        else:
            if len(head) < _H40.size:
                return None
            (_, _, _, _, n_words, total, start) = _H40.unpack_from(head, 0)
            # only 4.0 implies list_start == 40; 4.1+ honors the stored
            # value (word-map.c:198-210)
            if vmin == 0:
                start = _H40.size
        li.n_words, li.total, li.list_start = n_words, total, start
        try:
            if os.path.getsize(path) < start + 12 * n_words:
                return None      # truncated: generic path's behavior
        except OSError:
            return None
        return li
    if code == GT4_INDEX_CODE:
        li.is_index = True
        if len(head) < _IDX_HEADER.size:
            return None
        (_, _, _, wlen, n_words, n_locs, _fb, _sb, _pb, _fill,
         _fs, _ks, _ls) = _IDX_HEADER.unpack_from(head, 0)
        li.k = wlen
        li.n_words, li.total, li.list_start = n_words, n_locs, 0
        return li
    return None


def _stats_lines(li: _ListInfo) -> str:
    if li.is_index:
        return (f"Index {li.path}: built with glistmaker version "
                f"{li.vmaj}.{li.vmin}\n"
                f"Wordlength\t{li.k}\nNUnique\t{li.n_words}\n"
                f"NTotal\t{li.total}\n")
    return (f"List {li.path}: built with glistmaker version "
            f"{li.vmaj}.{li.vmin}\n"
            f"Wordlength\t{li.k}\nNUnique\t{li.n_words}\n"
            f"NTotal\t{li.total}\n")


def _with_records(li: _ListInfo, fn):
    """mmap the record blob and call fn(ptr_or_None, n_words)."""
    n = li.n_words
    if n == 0:
        return fn(None, 0)
    size = n * 12
    with open(li.path, "rb") as f:
        # ACCESS_COPY: private COW map — ctypes.from_buffer needs a
        # writable buffer, and the kernels only read
        mm = mmap.mmap(f.fileno(), li.list_start + size,
                       access=mmap.ACCESS_COPY)
    buf = None
    try:
        buf = (ctypes.c_ubyte * size).from_buffer(mm, li.list_start)
        return fn(buf, n)
    finally:
        buf = None
        mm.close()


def try_fast_stats(command: str, lists: list, distro: int):
    infos = []
    wlen = 0
    for p in lists:
        li = _read_info(p)
        if li is None:
            return None
        if li.is_index and command != "stats":
            return None          # count decode needs the offsets blob
        if not wlen:
            wlen = li.k
        elif li.k != wlen:
            return None          # generic path prints the mismatch error
        infos.append(li)
    if not infos:
        return None

    if command == "stats":
        for li in infos:
            sys.stdout.write(_stats_lines(li))
        return 0

    from genometester4_tpu_torch.utils.native import load_raw
    lib = load_raw()

    if command == "median":
        for li in infos:
            mn = ctypes.c_uint(0)
            mx = ctypes.c_uint(0)
            md = ctypes.c_uint(0)

            def run(buf, n, mn=mn, mx=mx, md=md):
                lib.fgx_median_rec(
                    buf, ctypes.c_long(n), ctypes.byref(mn),
                    ctypes.byref(mx), ctypes.byref(md))
            _with_records(li, run)
            sys.stdout.write(_stats_lines(li))
            if li.n_words:
                avg_s = "%.2f" % (li.total / li.n_words)
            else:
                # C prints 0.0/0 as "-nan" on x86 (src/glistquery.c:868)
                avg_s = "-nan"
            sys.stdout.write(f"Min {mn.value} Max {mx.value} "
                             f"Median {md.value} Average {avg_s}\n")
        return 0

    if command == "distro":
        max_count = distro + 1
        for li in infos:
            hist = (ctypes.c_ulonglong * (max_count + 2))()

            def run(buf, n, hist=hist):
                if n:
                    lib.fgx_distro_rec(buf, ctypes.c_long(n),
                                       ctypes.c_ulonglong(max_count + 1),
                                       hist)
            _with_records(li, run)
            out = [f"{i}\t{hist[i]}\n" for i in range(1, max_count + 1)]
            sys.stdout.write("".join(out))
        return 0

    if command == "gc":
        for li in infos:
            gt = ctypes.c_ulonglong(0)
            ct = ctypes.c_ulonglong(0)

            def run(buf, n, gt=gt, ct=ct):
                if n:
                    lib.fgx_gc_rec(buf, ctypes.c_long(n),
                                   ctypes.byref(gt), ctypes.byref(ct))
            _with_records(li, run)
            denom = ct.value * li.k
            if not denom:
                # x86 0.0/0.0 sets the NaN sign bit; C %g prints "-nan"
                sys.stdout.write("GC\t-nan\n")
            else:
                sys.stdout.write("GC\t%g\n" % (gt.value / denom))
        return 0

    return None
