"""Profiling (port of efficientvlm_tpu/train/profiler.py): a torch.profiler
trace around a block, and the program's own spans.

A span marks one part of the program (`with span("evlm.step.student"):`).
Off, which is the default, a span costs one check of a module global and
enters a shared no-op context. Inside `recording()` each span appends
(name, parent, t0_ns, t1_ns) to the recording's log, `parent` being the
index in the log of the span that encloses it (None at the top); with
`annotate` it also enters torch.profiler.record_function(name), so that a
profiler that records host activity shows the span as a range. A profiler
of the device's activity alone sees nothing of a span that only logs, so
its idle time stays as it is.

The clock is time.time_ns: torch.profiler stamps its host events on the
Unix clock in nanoseconds and lays the card's (CUPTI's) timestamps onto the
same clock, so a logged interval lies directly over the device events of a
trace taken at the same time. On an H100 a span starts a median 5-7 us
from its record_function range (tests/test_torch_spans.py holds the CPU to
20 us). The profiler maps its own clock onto Unix time linearly over its
session, so where the host's Unix clock is stepped or slewed a long
profile and time_ns part by up to the step.

A recording belongs to the thread that opened it; spans of other threads
are not logged. Recordings nest: the inner one logs on its own, and the
outer one resumes when it ends.

JAX's force_sync (a host fetch of one leaf, because block_until_ready
returned early on its remote device) has no counterpart: on the card a CUDA
event or torch.cuda.synchronize waits for the work itself. Nor do flops_of
(XLA's cost analysis) and the bench scripts' helpers (timed_runs,
median_time, report), which the port's harnesses do not call.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Optional

import torch


class _Recording:
    __slots__ = ("log", "open", "annotate", "thread")

    def __init__(self, annotate: bool):
        self.log: list = []   # (name, parent, t0_ns, t1_ns); t1_ns None while open
        self.open: list = []  # indices of the spans open now, innermost last
        self.annotate = annotate
        self.thread = threading.get_ident()


_recording: Optional[_Recording] = None


_NO_SPAN = contextlib.nullcontext()


class _Span:
    __slots__ = ("rec", "name", "at", "range")

    def __init__(self, rec: _Recording, name: str):
        self.rec, self.name, self.range = rec, name, None

    def __enter__(self):
        rec = self.rec
        if rec.annotate:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.at = len(rec.log)
        rec.log.append((self.name, rec.open[-1] if rec.open else None, time.time_ns(), None))
        rec.open.append(self.at)
        return None

    def __exit__(self, *exc):
        t1 = time.time_ns()
        rec = self.rec
        rec.open.pop()
        name, parent, t0, _ = rec.log[self.at]
        rec.log[self.at] = (name, parent, t0, t1)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context that marks one part of the program: logged inside
    recording(), and nothing otherwise."""
    rec = _recording
    if rec is None or rec.thread != threading.get_ident():
        return _NO_SPAN
    return _Span(rec, name)


@contextlib.contextmanager
def recording(annotate: bool = False):
    """Spans on for the block, in this thread; yields their log, a list of
    (name, parent index or None, t0_ns, t1_ns). annotate: each span also
    enters record_function (for a profiler that records host activity).
    The previous recording, if any, resumes on exit."""
    global _recording
    prev, _recording = _recording, _Recording(annotate)
    try:
        yield _recording.log
    finally:
        _recording = prev


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """A torch.profiler trace of the block (the CPU, and the card's kernels
    when there is one) with the program's spans as ranges, written to
    <logdir>/trace.json (Chrome trace format) when the block ends; yields
    the profiler (key_averages() reads it)."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        with recording(annotate=True):
            yield prof
    finally:
        _sync()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
