"""The device trace of a traced window, reduced to what the metrics read.

``from_profiler`` takes a finished ``torch.profiler.profile`` and keeps
three kinds of events from its raw (Kineto) results: the host's named
ranges (``record_function``: the harness's range around each call into
the store, the program's ``vdb/*`` ranges), the runtime calls that
launched device work (by correlation id), and the device's kernels,
copies and fills. ``build`` reduces them, on the trace's own clock, to:

  * the window: from the first call range's start to the last one's end;
  * the device's busy intervals (the union of its operations) and the
    idle time left in the window;
  * idle time by the innermost host range open at that moment
    (``host_outside_any_range`` where none is);
  * each device operation with the innermost host range open when it
    was launched.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

OUTSIDE = "host_outside_any_range"
_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class DeviceOp:
    name: str
    start: int             # ns, trace clock
    end: int
    kind: str              # kernel | gpu_memcpy | gpu_memset
    launched_in: Optional[str] = None


@dataclass
class Trace:
    window: Tuple[int, int]
    calls: int
    busy: List[Tuple[int, int]]
    ops: List[DeviceOp]
    idle_by_range: Dict[str, float] = field(default_factory=dict)
    unlinked_ops: int = 0

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-9

    @property
    def idle_s(self) -> float:
        return self.window_s - self.busy_s

    def breakdown(self, top: int = 10) -> dict:
        by_name: Dict[str, float] = defaultdict(float)
        for op in self.ops:
            by_name[op.name[:96]] += (op.end - op.start) * 1e-9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_range.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps[:top]]}


def _segments(ranges):
    """Host ranges (name, start, end) -> sorted disjoint segments (start,
    end, name) labelled by the innermost open range (the latest start)."""
    points = []
    for i, (_, s, e) in enumerate(ranges):
        if e > s:
            points.append((s, 1, i))
            points.append((e, 0, i))
    points.sort()
    active: Dict[int, int] = {}
    segs = []
    prev = None
    for t, is_start, i in points:
        if prev is not None and t > prev and active:
            inner = max(active, key=lambda j: (ranges[j][1], -ranges[j][2]))
            name = ranges[inner][0]
            if segs and segs[-1][2] == name and segs[-1][1] == prev:
                segs[-1] = (segs[-1][0], t, name)
            else:
                segs.append((prev, t, name))
        if is_start:
            active[i] = ranges[i][1]
        else:
            active.pop(i, None)
        prev = t
    return segs


def _merge(intervals):
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def build(ranges, launches: Dict[int, int], ops, call_range: str) -> Trace:
    """``ranges``: host ranges (name, start_ns, end_ns); ``launches``:
    correlation id -> the launching runtime call's start; ``ops``: device
    operations (name, start_ns, end_ns, kind, correlation id)."""
    calls = [(s, e) for n, s, e in ranges if n == call_range]
    if not calls:
        raise ValueError(f"the trace holds no {call_range!r} range")
    w0 = min(s for s, _ in calls)
    w1 = max(e for _, e in calls)
    segs = _segments(ranges)
    seg_starts = [s for s, _, _ in segs]

    def label_at(t: int) -> Optional[str]:
        i = bisect.bisect_right(seg_starts, t) - 1
        if i >= 0 and segs[i][0] <= t < segs[i][1]:
            return segs[i][2]
        return None

    kept: List[DeviceOp] = []
    unlinked = 0
    for name, s, e, kind, corr in ops:
        if e <= w0 or s >= w1:
            continue
        t = launches.get(corr)
        if t is None:
            unlinked += 1
        kept.append(DeviceOp(name, max(s, w0), min(e, w1), kind,
                             None if t is None else label_at(t)))
    busy = _merge([(op.start, op.end) for op in kept])

    idle = []
    cur = w0
    for s, e in busy:
        if s > cur:
            idle.append((cur, s))
        cur = max(cur, e)
    if cur < w1:
        idle.append((cur, w1))

    by_range: Dict[str, float] = defaultdict(float)
    j = 0
    for s, e in idle:
        covered = 0
        while j < len(segs) and segs[j][1] <= s:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < e:
            lo, hi = max(s, segs[k][0]), min(e, segs[k][1])
            if hi > lo:
                by_range[segs[k][2]] += (hi - lo) * 1e-9
                covered += hi - lo
            k += 1
        if e - s > covered:
            by_range[OUTSIDE] += (e - s - covered) * 1e-9
    return Trace((w0, w1), len(calls), busy, kept, dict(by_range), unlinked)


def _call(obj, name, default=None):
    fn = getattr(obj, name, None)
    if fn is None:
        return default
    try:
        return fn()
    except (RuntimeError, TypeError):
        return default


def from_profiler(prof, call_range: str):
    """Reduce a finished ``torch.profiler.profile`` (see the module
    docstring). Returns (Trace, the count of raw events by device and
    activity type)."""
    from torch.autograd import DeviceType
    ranges, launches, ops = [], {}, []
    kinds: Dict[str, int] = defaultdict(int)
    for ev in prof.profiler.kineto_results.events():
        kind = str(_call(ev, "activity_type", ""))
        name = ev.name()
        on_device = ev.device_type() != DeviceType.CPU
        kinds[f"{'device' if on_device else 'host'}:{kind}"] += 1
        if on_device:
            if "annotation" in kind or name.startswith(("vdb/", "vdbbench/")):
                continue
            if kind not in _DEVICE_KINDS:
                kind = ("gpu_memcpy" if name.startswith("Memcpy") else
                        "gpu_memset" if name.startswith("Memset") else
                        "kernel")
            ops.append((name, ev.start_ns(), ev.end_ns(), kind,
                        ev.correlation_id()))
        elif kind in ("cuda_runtime", "cuda_driver") or (
                not kind and name.startswith("cu")):
            launches[ev.correlation_id()] = ev.start_ns()
        elif kind == "user_annotation" or _call(ev, "is_user_annotation",
                                                False):
            ranges.append((name, ev.start_ns(), ev.end_ns()))
    return build(ranges, launches, ops, call_range), dict(kinds)
