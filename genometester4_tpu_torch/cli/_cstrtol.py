"""glibc ``strtol``/``strtoll`` twins for CLI argv parsing (the port's copy of
``genometester4_tpu/cli/_cstrtol.py``).

The reference tools parse every numeric flag with
``v = strtol (arg, &end, 10)`` and (sometimes) check ``*end == 0``
afterwards.  That has three properties ``int(arg)`` does not:

* a prefix parse: ``"12abc"`` converts to 12 with ``end`` at ``'a'``
  (tools that skip the end-check accept it silently);
* an empty string "converts" to 0 with ``end`` still at the
  terminator, so the end-check PASSES for ``""`` but fails for
  whitespace-only input (no conversion leaves ``end`` at the start);
* out-of-range values clamp to the C ``long`` range instead of
  raising.

Every converter here returns ``(value, end_ok)`` where ``end_ok``
mirrors ``*end == 0``.  Width-specific wrappers then truncate exactly
like the C assignment the reference performs (``unsigned int x =
strtol (...)`` etc.).
"""

from __future__ import annotations

import re

_NUM = re.compile(r"[ \t\n\v\f\r]*[+-]?[0-9]+")

_LONG_MIN, _LONG_MAX = -2**63, 2**63 - 1


def strtol(s: str):
    """``strtol(s, &end, 10)`` → ``(long_value, *end == 0)``."""
    m = _NUM.match(s)
    if m is None:
        return 0, s == ""
    v = int(m.group())
    v = min(max(v, _LONG_MIN), _LONG_MAX)
    return v, m.end() == len(s)


def strtol_u32(s: str):
    """``unsigned int x = strtol (s, &end, 10)`` → ``(x, *end == 0)``."""
    v, ok = strtol(s)
    return v & 0xFFFFFFFF, ok


def strtol_i32(s: str):
    """``int x = strtol (s, &end, 10)`` → ``(x, *end == 0)``."""
    v, ok = strtol(s)
    v &= 0xFFFFFFFF
    return (v - 0x100000000 if v >= 0x80000000 else v), ok


def strtoll_u64(s: str):
    """``unsigned long long x = strtoll (s, &end, 10)``."""
    v, ok = strtol(s)
    return v & 0xFFFFFFFFFFFFFFFF, ok


def i32(u: int) -> int:
    """Value a C ``%d`` prints for an unsigned-int variable."""
    return u - 0x100000000 if u >= 0x80000000 else u


_FLT = re.compile(r"[ \t\n\v\f\r]*[+-]?(?:[0-9]+(?:\.[0-9]*)?|\.[0-9]+)"
                  r"(?:[eE][+-]?[0-9]+)?")
_INFNAN = re.compile(r"[ \t\n\v\f\r]*([+-])?(inf(?:inity)?|nan)",
                     re.IGNORECASE)


def atof(s: str) -> float:
    """C ``atof`` (``strtod`` prefix parse): ``"12x"`` → 12.0, no
    conversion → 0.0; inf/nan spellings accepted like glibc."""
    m = _FLT.match(s)
    if m is not None:
        return float(m.group())
    m = _INFNAN.match(s)
    if m is not None:
        v = float("inf") if m.group(2).lower().startswith("inf") else float("nan")
        return -v if m.group(1) == "-" else v
    return 0.0
