"""Reading the program's own spans (efficientvlm_tpu_torch/train/profiler:
span and recording) against a device trace taken at the same time.

A span log is the list that recording() yields: (name, parent index or
None, t0_ns, t1_ns), stamped on the clock that torch.profiler stamps its
events with, so a span lies directly over the device events of the slice.
A span still open when its recording ended (t1_ns None) runs to the end of
the window.

`idle_under` puts each nanosecond of a window in which no device event ran
under the innermost program span open at that moment (or under none);
`seconds_under` and `subtree` sum a log by name and by ancestry.
"""

from __future__ import annotations

import bisect
from typing import Iterable, List, Optional, Tuple

from benchmark.trace import merged


def innermost(spans, window: Tuple[int, int]) -> List[Tuple[int, int, int]]:
    """(t0, t1, span index) pieces of the window that do not overlap, each
    under its innermost span (the deepest open one); moments under no span
    are left out."""
    lo, hi = window
    depth: List[int] = []
    for _, parent, _, _ in spans:
        depth.append(0 if parent is None else depth[parent] + 1)
    ivs = [(max(t0, lo), min(hi if t1 is None else t1, hi), i)
           for i, (_, _, t0, t1) in enumerate(spans)]
    ivs = [iv for iv in ivs if iv[1] > iv[0]]
    bounds = sorted({t for a, b, _ in ivs for t in (a, b)})
    label: List[Optional[int]] = [None] * max(len(bounds) - 1, 0)
    for a, b, i in sorted(ivs, key=lambda iv: depth[iv[2]]):  # deeper spans paint last
        for k in range(bisect.bisect_left(bounds, a), bisect.bisect_left(bounds, b)):
            label[k] = i
    out: List[Tuple[int, int, int]] = []
    for k, i in enumerate(label):
        if i is None:
            continue
        if out and out[-1][2] == i and out[-1][1] == bounds[k]:
            out[-1] = (out[-1][0], bounds[k + 1], i)
        else:
            out.append((bounds[k], bounds[k + 1], i))
    return out


def idle_under(device: Iterable[Tuple[int, int]], spans,
               window: Tuple[int, int]) -> Tuple[List[float], float]:
    """The device-idle seconds of `window` (lo_ns, hi_ns), given the device
    events' (t0_ns, t1_ns): (a list, per span index, of the idle seconds
    under that span while it was the innermost one; the idle seconds under
    no span)."""
    lo, hi = window
    gaps, t = [], lo
    for a, b in merged([(max(a, lo), min(b, hi)) for a, b in device if b > lo and a < hi]):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    per = [0.0] * len(spans)
    outside = 0
    pieces = innermost(spans, window)
    j = 0
    for g0, g1 in gaps:
        covered = 0
        while j < len(pieces) and pieces[j][1] <= g0:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < g1:
            a, b = max(pieces[k][0], g0), min(pieces[k][1], g1)
            if b > a:
                per[pieces[k][2]] += (b - a) / 1e9
                covered += b - a
            k += 1
        outside += g1 - g0 - covered
    return per, outside / 1e9


def subtree(spans, roots) -> List[bool]:
    """Per span index, whether the span or one of its ancestors is named in
    `roots`."""
    roots = set(roots)
    inside: List[bool] = []
    for name, parent, _, _ in spans:
        inside.append(name in roots or (parent is not None and inside[parent]))
    return inside


def seconds_under(spans, name: str, window: Optional[Tuple[int, int]] = None) -> float:
    """The seconds of every range of span `name` (within `window` if given)."""
    total = 0
    for n, _, t0, t1 in spans:
        if n != name or t1 is None:
            continue
        if window is not None:
            t0, t1 = max(t0, window[0]), min(t1, window[1])
        total += max(t1 - t0, 0)
    return total / 1e9
