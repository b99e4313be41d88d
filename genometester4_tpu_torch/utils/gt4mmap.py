"""Twin of the reference's ``gt4_mmap`` failure chrome (src/utils.c:36-60);
the port's copy of ``genometester4_tpu/utils/gt4mmap.py``.

``gt4_mmap`` stats, opens, then mmaps; each failure perror()s with its
own prefix before the caller prints its "Cannot mmap ..." line.  The
observable cases on this platform:

* missing path          -> ``gt4_mmap (stat): No such file or directory``
* path is a directory   -> stat+open succeed, ``mmap`` gives ENODEV ->
                           ``gt4_mmap (mmap): No such device``
* empty file            -> ``mmap`` of length 0 gives EINVAL ->
                           ``gt4_mmap (mmap): Invalid argument``
* unreadable file       -> ``gt4_mmap (open): Permission denied``
  (unreachable when running as root — open ignores the mode bits)
"""

from __future__ import annotations

import os
import stat as _stat


def gt4_mmap_fail(path: str) -> str | None:
    """The stderr line gt4_mmap would print before returning NULL for
    this path, or None when the mapping would succeed."""
    try:
        st = os.stat(path)
    except OSError as e:
        return "gt4_mmap (stat): %s\n" % os.strerror(e.errno or 2)
    if _stat.S_ISDIR(st.st_mode):
        return "gt4_mmap (mmap): No such device\n"
    if st.st_size == 0:
        return "gt4_mmap (mmap): Invalid argument\n"
    try:
        with open(path, "rb"):
            pass
    except OSError as e:
        return "gt4_mmap (open): %s\n" % os.strerror(e.errno or 13)
    return None
