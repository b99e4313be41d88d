"""What the traced run reads from ``torch.profiler``: each card's busy
intervals, kernel time by name, and the card's idle gaps named by the
benchmark's host span that was open during each.

The busy share is the union of a card's device intervals (kernels, copies,
sets) over the window, the method of ``tools/profile_torch_listmaker.py``'s
``device_busy``. The profiler's clock is tied to the host's by a range
(``MARK``) recorded around the window.
"""

from __future__ import annotations

MARK = "gt4bench.window"
_SKIP = ("Activity Buffer Request",)


def profiler(cuda: bool = True):
    """A profiler of host operations and, on a card, device activity; not
    started."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    return profile(activities=acts)


def _union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def short_name(name: str, limit: int = 120) -> str:
    """A kernel's name without its trailing argument list (a copy keeps
    its kind), cut to ``limit``."""
    name = name.strip()
    if name.endswith(")") and not name.startswith(("Memcpy", "Memset")):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i else name
                break
    return name[:limit]


class DeviceTrace:
    """Device activity inside the window [t0, t1] (host seconds)."""

    def __init__(self, prof, t0: float, t1: float):
        from torch.autograd import DeviceType
        self.t0, self.t1 = t0, t1
        events = prof.events()
        marks = [e for e in events
                 if e.name == MARK and e.device_type == DeviceType.CPU]
        if not marks:
            raise RuntimeError("the profiler holds no window range")
        # profiler microseconds -> host seconds
        off = marks[0].time_range.start / 1e6 - t0
        self.by_device: dict[int, list[tuple[float, float, str]]] = {}
        for e in events:
            if (e.device_type != DeviceType.CUDA or e.name in _SKIP
                    or e.name.startswith("gt4bench")):
                continue
            a = max(e.time_range.start / 1e6 - off, t0)
            b = min(e.time_range.end / 1e6 - off, t1)
            if b > a:
                self.by_device.setdefault(e.device_index, []).append(
                    (a, b, e.name))

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy(self, device: int) -> float:
        return sum(b - a for a, b in _union(
            (a, b) for a, b, _ in self.by_device.get(device, ())))

    def busiest(self) -> int | None:
        if not self.by_device:
            return None
        return max(self.by_device, key=self.busy)

    def busy_mean(self, n_devices: int) -> float:
        return sum(self.busy(d) for d in self.by_device) / max(n_devices, 1)

    def kernel_seconds(self, patterns) -> float:
        """Summed device time, over every card, of the activities whose
        name holds one of ``patterns`` (case-insensitive)."""
        pats = [p.lower() for p in patterns]
        return sum(b - a for rows in self.by_device.values()
                   for a, b, n in rows
                   if any(p in n.lower() for p in pats))

    def top_ops(self, n: int = 10) -> list:
        tot: dict[str, float] = {}
        for rows in self.by_device.values():
            for a, b, name in rows:
                key = short_name(name)
                tot[key] = tot.get(key, 0.0) + (b - a)
        return [[k, v] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, spans, n: int = 10) -> list:
        """The busiest card's idle time, split by the host span that
        covered each part of each gap ("other" where none did)."""
        dev = self.busiest()
        busy = _union((a, b) for a, b, _ in self.by_device.get(dev, ()))
        gaps, t = [], self.t0
        for a, b in busy + [(self.t1, self.t1)]:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        rows = sorted((a, b, name) for name, a, b in spans.rows)
        tot: dict[str, float] = {}
        i = 0
        for g0, g1 in gaps:
            covered = 0.0
            while i < len(rows) and rows[i][1] <= g0:
                i += 1
            for a, b, name in rows[i:]:
                if a >= g1:
                    break
                part = min(b, g1) - max(a, g0)
                if part > 0:
                    tot[name] = tot.get(name, 0.0) + part
                    covered += part
            if g1 - g0 > covered:
                tot["other"] = tot.get("other", 0.0) + (g1 - g0 - covered)
        return [[k, v] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]
