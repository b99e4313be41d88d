"""numpy-free glistcompare -ss fast path (the port's copy of
``genometester4_tpu/pipelines/subset_fast.py``, on the port's
``utils.native.load_raw``).

The subset operation is a single native pass over the raw 12-byte
record stream (fgx_subset, exact drand48 parity with
src/glistcompare.c:719-787), but the generic pipeline pays ~0.6 s of
numpy import under the bin/ -S launchers before that pass starts — 4x
the reference's whole wall time at 2M records (round-3 find, same
pattern as pipelines/list_stats_fast). This module answers the common
case (one plain v>=4.1 .list input) from stdlib mmap + ctypes alone;
anything else returns None and the numpy pipeline handles it.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import struct
import sys

_HEADER = struct.Struct("<IIIIQQQII")  # list_format._HEADER_4_4
GT4_LIST_CODE = (ord("G") << 24) | (ord("T") << 16) | (ord("4") << 8) \
    | ord("C")
_METHODS = {"rand": 0, "rand_unique": 1, "rand_weighted_unique": 2}
_WRITE_CHUNK = 1 << 20   # dirty-page throttling split


def try_fast_subset(path: str, method: str, size: int, outputname: str,
                    seed: int):
    """Return the output path on success, None to fall back."""
    if method not in _METHODS:
        return None
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
        return None   # index files etc.: generic path
    # header layout on version_minor alone (src/word-map.c:197-209):
    # minor 0 -> data at 40; minor 1-2 -> list_start, implied 8/4
    # record bytes; minor >= 3 -> explicit word/count bytes
    if vmin >= 3:
        if wb != 8 or cb != 4:
            return None
    else:
        if vmin == 0:
            start = 40
        wb, cb = 8, 4
    if method != "rand" and size > n_words:
        return None   # generic path raises/prints the reference error

    from genometester4_tpu_torch.utils.native import load_raw
    lib = load_raw()
    lib.fgx_subset.restype = ctypes.c_long

    out_path = "%s_subset_%d.list" % (outputname, wlen)
    tmp = "%s.tmp.%d" % (out_path, os.getpid())
    size_needed = start + 12 * n_words
    if n_words and os.path.getsize(path) < size_needed:
        return None   # truncated input: generic path's chrome handles it
    out_buf = (ctypes.c_ubyte * max(12, 12 * n_words))()
    tot = ctypes.c_ulonglong(0)
    if n_words:
        with open(path, "rb") as f:
            mm = mmap.mmap(f.fileno(), size_needed,
                           access=mmap.ACCESS_COPY)
        try:
            recs = (ctypes.c_ubyte * (12 * n_words)).from_buffer(mm, start)
            m = lib.fgx_subset(recs, ctypes.c_long(n_words),
                               ctypes.c_ulonglong(total),
                               ctypes.c_int(_METHODS[method]),
                               ctypes.c_ulonglong(size),
                               ctypes.c_long(seed), out_buf,
                               ctypes.byref(tot))
        finally:
            recs = None
            mm.close()
    else:
        m = lib.fgx_subset((ctypes.c_ubyte * 12)(), ctypes.c_long(0),
                           ctypes.c_ulonglong(total),
                           ctypes.c_int(_METHODS[method]),
                           ctypes.c_ulonglong(size), ctypes.c_long(seed),
                           out_buf, ctypes.byref(tot))
    with open(tmp, "wb") as f:
        f.write(_HEADER.pack(GT4_LIST_CODE, 4, 2, wlen, m,
                             int(tot.value), _HEADER.size, 8, 4))
        view = memoryview(out_buf)[: 12 * m]
        for i in range(0, len(view), _WRITE_CHUNK):
            f.write(view[i:i + _WRITE_CHUNK])
    os.replace(tmp, out_path)
    return out_path
