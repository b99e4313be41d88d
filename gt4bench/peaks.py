"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
700 W power limit), the roofline bound, and the card's own reading of its
name and power limit. Copied from ``chip_smoke.py``'s ``PEAK_BYTES`` and
``PEAK_INT_OPS``."""

from __future__ import annotations

import shutil
import subprocess

PEAK_BYTES = 3.35e12       # HBM3 bytes/s
PEAK_INT_OPS = 16.7e12     # int32 ops/s outside the tensor cores


def bound_s(bytes_moved: float, int_ops: float = 0.0) -> float:
    """The least time the work can take: the larger of its bytes over the
    memory peak and its integer operations over the integer peak."""
    return max(bytes_moved / PEAK_BYTES, int_ops / PEAK_INT_OPS)


def roofline_pct(bytes_moved: float, kernel_s: float,
                 int_ops: float = 0.0) -> float | None:
    """The bound's share of the measured kernel time, in %; None when no
    kernel time was read."""
    if not kernel_s or kernel_s <= 0:
        return None
    return 100.0 * bound_s(bytes_moved, int_ops) / kernel_s


def card_readings() -> list[str]:
    """``nvidia-smi``'s name and power limit of each card, one line a
    card; empty without the tool."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return []
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False)
    except (OSError, subprocess.SubprocessError):
        return []
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
