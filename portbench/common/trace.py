"""Reading a profiled stretch of whole calls: device intervals from the
profiler's events, the benchmark's own spans, the idle share as one
minus the union of device intervals over the stretch, and the breakdown
the result line carries."""
from __future__ import annotations

import bisect
from collections import defaultdict

import torch

SPAN_PREFIX = "pb:"
CALL_SPAN = SPAN_PREFIX + "call"


def _ns(e, which: str) -> int:
    f = getattr(e, which + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, which + "_us")() * 1000)


def union_ns(intervals) -> int:
    """Total length of the union of [start, end) intervals (ns)."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class TraceView:
    """What the per-layer metric readers see of a traced run.

    `kernels` and `device` are (name, start_ns, end_ns) of device kernels
    and of all device activity (kernels, copies, sets); `spans` maps a
    span's name (`group/attr`) to its host intervals; `calls` are the
    profiled calls' host intervals; `units` the work units (pairs,
    frames) they carried; `span_wall` the host seconds of each group's
    spans, each closed after a synchronize; `missing` the groups one of
    whose targets the program no longer has; `work` what the cell's code
    counted for the profiled calls."""

    def __init__(self, kernels, device, spans, calls, units, span_wall,
                 missing, work):
        self.kernels, self.device, self.spans = kernels, device, spans
        self.calls, self.units = calls, units
        self._span_wall, self.missing, self.work = span_wall, missing, work
        self.start = min(s for s, _ in calls)
        self.end = max(e for _, e in calls)

    @classmethod
    def from_events(cls, events, units, span_wall, missing, work):
        kernels, device = [], []
        spans, calls = defaultdict(list), []
        for e in events:
            name = e.name()
            s, d = _ns(e, "start"), int(e.duration_ns())
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if e.is_user_annotation() or name.startswith(SPAN_PREFIX):
                    continue
                device.append((name, s, s + d))
                if not name.startswith(("Memcpy", "Memset")):
                    kernels.append((name, s, s + d))
            elif name == CALL_SPAN:
                calls.append((s, s + d))
            elif name.startswith(SPAN_PREFIX):
                spans[name[len(SPAN_PREFIX):]].append((s, s + d))
        return cls(kernels, device, dict(spans), calls, units, span_wall,
                   missing, work)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def _in_window(self, items):
        return [(n, max(s, self.start), min(e, self.end)) for n, s, e in items
                if e > self.start and s < self.end]

    @property
    def busy_s(self) -> float:
        return union_ns((s, e) for _, s, e in
                        self._in_window(self.device)) / 1e9

    def group_intervals(self, group: str):
        return [iv for name, ivs in self.spans.items()
                if name.split("/")[0] == group for iv in ivs]

    def span_wall(self, group: str):
        """Host seconds in the group's spans, or None when a target of the
        group is missing or it never ran."""
        if group in self.missing or group not in self._span_wall:
            return None
        return self._span_wall[group]

    def device_s_in(self, group: str):
        """Device seconds of the kernels that started inside the group's
        spans (the spans synchronize before they close), or None."""
        if self.span_wall(group) is None:
            return None
        ivs = merged(self.group_intervals(group))
        if not ivs:
            return None
        starts = [s for s, _ in ivs]
        total = 0
        for _, s, e in self.kernels:
            j = bisect.bisect_right(starts, s) - 1
            if j >= 0 and s < ivs[j][1]:
                total += e - s
        return total / 1e9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the innermost span the host was in (seconds)."""
        ops = defaultdict(int)
        for n, s, e in self._in_window(self.device):
            ops[n] += e - s
        dev = merged((s, e) for _, s, e in self._in_window(self.device))
        gaps = []
        prev = self.start
        for s, e in dev:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.end > prev:
            gaps.append((prev, self.end))
        leaf = sorted(((s, e, n) for n, ivs in self.spans.items()
                       for s, e in ivs), key=lambda x: x[0])
        by = defaultdict(int)
        for s, e in gaps:
            mid = (s + e) // 2
            inner = [(ie - is_, n) for is_, ie, n in leaf if is_ <= mid < ie]
            by[min(inner)[1] if inner else "host outside the spans"] += e - s
        return {
            "device_ops": [[n, v / 1e9] for n, v in
                           sorted(ops.items(), key=lambda x: -x[1])[:top]],
            "idle_gaps": [[n, v / 1e9] for n, v in
                          sorted(by.items(), key=lambda x: -x[1])[:top]]}
