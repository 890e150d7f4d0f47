"""Reading a torch.profiler trace of a short steady slice of a run.

The slice is profiled with CPU and CUDA activities and read straight from
the profiler's events (no trace file is written):

- device activity: every event on the card (kernels, copies, sets), its
  name and interval;
- the host's timeline on the thread that runs the slice: the innermost
  torch op, CUDA API call or benchmark span at each moment;
- launches: the host API call behind each device event, by correlation id,
  so that device time can be charged to the benchmark span that launched it
  (`device_seconds_under`).

`device_window` reads a slice profiled with the device's activity alone,
between two marker kernels: its busy seconds and its window, with no host
op recorded (whose cost would read as idle).

`summary` gives the busy seconds (the union of device intervals) and the
window of the slice, the device ops that took most time and the longest
idle gaps by what the host was doing meanwhile.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WINDOW_SPAN = "bench.window"
HOST_PYTHON = "host Python outside torch ops"
NAME_CHARS = 160  # device op names are cut to this length in the breakdown


@dataclass
class Trace:
    device: List[tuple] = field(default_factory=list)  # name, t0, t1, (correlation ids)
    host: List[Tuple[str, int, int]] = field(default_factory=list)  # main thread: name, t0, t1
    spans: Dict[str, List[Tuple[int, int]]] = field(default_factory=dict)  # annotations
    launch_ns: Dict[int, int] = field(default_factory=dict)  # corr -> host launch time
    window: Tuple[int, int] = (0, 0)


def _is_device(ev) -> bool:
    return str(ev.device_type()).split(".")[-1] in ("CUDA", "PrivateUse1")


def from_profiler(prof) -> Trace:
    """The slice's Trace from a stopped torch.profiler.profile whose slice
    ran under record_function(WINDOW_SPAN)."""
    events = list(prof.profiler.kineto_results.events())
    tr = Trace()
    window_tid = None
    annotations = set()
    for ev in events:
        if not _is_device(ev) and ev.is_user_annotation():
            annotations.add(ev.name())
        if not _is_device(ev) and ev.name() == WINDOW_SPAN:
            tr.window = (ev.start_ns(), ev.end_ns())
            window_tid = ev.start_thread_id()
    for ev in events:
        t0, t1 = ev.start_ns(), ev.end_ns()
        if _is_device(ev):
            if ev.is_user_annotation() or ev.name() in annotations:
                continue  # a span's shadow on the device timeline, not device work
            tr.device.append((ev.name(), t0, t1,
                              (ev.correlation_id(), ev.linked_correlation_id())))
            continue
        if ev.correlation_id() and ev.name().startswith("cu"):  # CUDA runtime / driver
            tr.launch_ns.setdefault(ev.correlation_id(), t0)
        if ev.is_user_annotation():
            tr.spans.setdefault(ev.name(), []).append((t0, t1))
        if window_tid is None or ev.start_thread_id() == window_tid:
            tr.host.append((ev.name(), t0, t1))
    tr.device.sort(key=lambda e: e[1])
    return tr


def merged(intervals) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return [(a, b) for a, b in out]


def _clip(intervals, lo: int, hi: int):
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def host_timeline(host) -> List[Tuple[int, int, str]]:
    """The innermost host event at each moment, as (t0, t1, name) pieces
    that do not overlap; moments under no event are left out."""
    bounds = sorted({t for _, a, b in host for t in (a, b)})
    if not bounds:
        return []
    # paint outer events first so that inner ones overwrite them
    order = sorted(host, key=lambda e: (e[2] - e[1]), reverse=True)
    label: List[Optional[str]] = [None] * (len(bounds) - 1)
    for name, a, b in order:
        i, j = bisect.bisect_left(bounds, a), bisect.bisect_left(bounds, b)
        for k in range(i, j):
            label[k] = name
    out = []
    for k, name in enumerate(label):
        if name is None:
            continue
        if out and out[-1][2] == name and out[-1][1] == bounds[k]:
            out[-1] = (out[-1][0], bounds[k + 1], name)
        else:
            out.append((bounds[k], bounds[k + 1], name))
    return out


def summary(tr: Trace, top: int = 10) -> dict:
    """busy_s, window_s, and the breakdown: device ops by total seconds and
    idle gaps by the innermost host event that ran during them."""
    lo, hi = tr.window
    busy_iv = merged(_clip([(a, b) for _, a, b, _ in tr.device], lo, hi))
    busy_ns = sum(b - a for a, b in busy_iv)
    by_op: Dict[str, float] = defaultdict(float)
    for name, a, b, _ in tr.device:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            by_op[name[:NAME_CHARS]] += (b - a) / 1e9
    gaps, t = [], lo
    for a, b in busy_iv:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    by_host: Dict[str, float] = defaultdict(float)
    timeline = host_timeline([e for e in tr.host if e[2] > lo and e[1] < hi])
    j = 0
    for g0, g1 in gaps:
        covered = 0
        while j < len(timeline) and timeline[j][1] <= g0:
            j += 1
        k = j
        while k < len(timeline) and timeline[k][0] < g1:
            a, b = max(timeline[k][0], g0), min(timeline[k][1], g1)
            if b > a:
                by_host[timeline[k][2]] += (b - a) / 1e9
                covered += b - a
            k += 1
        if (g1 - g0) > covered:
            by_host["(no host event)"] += (g1 - g0 - covered) / 1e9
    if WINDOW_SPAN in by_host:  # under the slice's own span alone: Python between torch ops
        by_host[HOST_PYTHON] = by_host.pop(WINDOW_SPAN)
    rank = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]  # noqa
    return {"busy_s": busy_ns / 1e9, "window_s": (hi - lo) / 1e9,
            "breakdown": {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}}


def device_window_of(device: List[tuple]) -> Optional[dict]:
    """busy_s and window_s of a slice traced between two marker kernels:
    `device` holds (name, t0, t1) of every device event, the markers first
    and last; the window runs from the first marker's end to the last's
    start. None without two markers."""
    device = sorted(device, key=lambda e: e[1])
    if len(device) < 2:
        return None
    lo, hi = device[0][2], device[-1][1]
    busy = merged(_clip([(a, b) for _, a, b in device[1:-1]], lo, hi))
    return {"busy_s": sum(b - a for a, b in busy) / 1e9, "window_s": (hi - lo) / 1e9,
            "markers": [device[0][0], device[-1][0]], "events": len(device) - 2}


def device_window(prof) -> Optional[dict]:
    """device_window_of a stopped torch.profiler.profile of the device's
    activity alone."""
    return device_window_of([(ev.name(), ev.start_ns(), ev.end_ns())
                             for ev in prof.profiler.kineto_results.events()
                             if _is_device(ev) and not ev.is_user_annotation()])


def device_seconds_under(tr: Trace, span: str) -> Optional[float]:
    """Device seconds of the events launched inside benchmark span `span`
    (matched by the launch's host time), within the window; None when the
    trace links no device event to a launch or the span never ran."""
    ranges = sorted(tr.spans.get(span, []))
    if not ranges or not tr.launch_ns:
        return None
    starts = [a for a, _ in ranges]
    lo, hi = tr.window
    total, linked = 0, 0
    for _, a, b, corrs in tr.device:
        t = next((tr.launch_ns[c] for c in corrs if c in tr.launch_ns), None)
        if t is None:
            continue
        linked += 1
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and ranges[i][0] <= t <= ranges[i][1]:
            a, b = max(a, lo), min(b, hi)
            if b > a:
                total += b - a
    return total / 1e9 if linked else None
