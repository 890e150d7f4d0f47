"""Profiling and timing (port of efficientvlm_tpu/train/profiler.py): a
torch.profiler trace around a block, and the step timing of a function on
CUDA events.

JAX's force_sync (a host fetch of one leaf, because block_until_ready
returned early on its remote device) has no counterpart: on the card a CUDA
event or torch.cuda.synchronize waits for the work itself. Nor do flops_of
(XLA's cost analysis) and the bench scripts' helpers (timed_runs,
median_time, report), which the port's harnesses do not call.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import numpy as np
import torch


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """A torch.profiler trace of the block (the CPU, and the card's kernels
    when there is one), written to <logdir>/trace.json (Chrome trace
    format) when the block ends; yields the profiler (key_averages() reads
    it)."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        _sync()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2,
            pipelined: bool = True) -> dict:
    """Seconds per call of fn(*args). pipelined=True measures throughput:
    `iters` calls back to back between two CUDA events (the host clock
    around a synchronize on the CPU); False measures latency: each call
    timed on its own, waited for before the next."""
    cuda = torch.cuda.is_available()
    for _ in range(warmup):
        fn(*args)
    _sync()
    if pipelined:
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*args)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3 / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            dt = (time.perf_counter() - t0) / iters
        times = [dt] * iters
    else:
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            _sync()
            times.append(time.perf_counter() - t0)
    return {"mean_s": float(np.mean(times)), "median_s": float(np.median(times)),
            "min_s": float(np.min(times)), "iters": iters, "pipelined": pipelined}
