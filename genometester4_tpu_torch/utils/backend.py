"""Host allocation setting shared by the port's file formats (the port's
copy of ``disable_numpy_thp`` from ``genometester4_tpu/utils/backend.py``)
and the one switch of its placement: ``GT4_TPU_LINK=slow``. The JAX
package's placement cost model is not ported: the port takes an explicit
device, ``utils.device``."""

from __future__ import annotations

import os

_thp_disabled = False


def disable_numpy_thp():
    """Turn off numpy's MADV_HUGEPAGE on large allocations.

    First touch of a 400 MB buffer costs 1.5 s with transparent huge page
    madvise and 0.2 s with 4 KB pages on a virtual machine (THP zeroing and
    compaction are slow there), and the host pipelines allocate buffers of
    hundreds of MB. Safe to call any time; idempotent."""
    global _thp_disabled
    if _thp_disabled:
        return
    try:
        try:
            from numpy._core import multiarray as _ma
        except ImportError:                      # numpy < 2
            from numpy.core import multiarray as _ma
        _ma._set_madvise_hugepage(False)
    except Exception:
        pass
    _thp_disabled = True


def link_is_slow() -> bool:
    """``GT4_TPU_LINK=slow``: the output-heavy pipelines (glistquery's
    bulk lookups and ``-s``) take their host routes, as the JAX package's
    ``accelerator_link_is_slow`` sends them there. A card on PCIe or
    NVLink has no slow link to detect, so nothing else answers True."""
    return os.environ.get("GT4_TPU_LINK") == "slow"
