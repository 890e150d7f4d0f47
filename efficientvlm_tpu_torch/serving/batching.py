"""Dynamic request batching for online serving (the port's own copy of
efficientvlm_tpu/serving/batching.py; framework-free, standard library only).

The card's throughput comes from batch work: one image at batch 1 leaves
most of the H100 idle. The batcher coalesces concurrent single requests into
batches (up to max_batch_size, waiting at most max_wait_ms after the first
arrival), and `pad_to_bucket` rounds batch sizes up to powers of two, so the
device sees a handful of batch shapes. No compile happens on the card, but
the first call at a new shape loads kernels, sizes cuBLAS workspaces and
grows the caching allocator; the service runs every bucket once before it
takes requests (InferenceService.warmup_buckets).

Two execution modes:

- single-stage (`run_batch` only): one worker thread runs the whole batch
  and returns its results; kept for simple callers and tests.
- pipelined (`run_batch` = dispatch, plus `finish_batch`): the dispatch
  thread uploads the batch and runs the device work, and hands an in-flight
  handle to a finisher thread that waits for the result, copies it to the
  host and postprocesses it. While the finisher works, the dispatch thread
  is already collecting and uploading the next batch, and request
  collection keeps draining past max_wait_ms while the pipeline is full (the
  device is busy anyway, so waiting costs no latency and grows the next
  batch toward max_batch_size). What the two stages overlap depends on the
  service: see serving/service.py.

Per-stage timing (queue wait / dispatch / finish, per-bucket batch counts)
is tracked for `/stats`, so a slow endpoint can be attributed to queueing,
host work or device work.

No reference counterpart (the reference ships no serving path); this backs
efficientvlm_tpu_torch/scripts/serve.py.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import Counter, deque
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence


def pad_to_bucket(n: int, max_batch_size: int) -> int:
    """Smallest power of two >= n, capped at max_batch_size: log2(max_batch)
    + 1 batch shapes, each warmed up once."""
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch_size)


def pad_items(items: Sequence, bucket: int) -> list:
    """Pad a request list to the bucket size by repeating the last item
    (the padded rows' results are dropped)."""
    items = list(items)
    if len(items) < bucket:
        items = items + [items[-1]] * (bucket - len(items))
    return items


class DynamicBatcher:
    """submit(item) -> Future; a worker drains the queue into batches and
    calls run_batch(items) -> results (one per item, same order). With
    finish_batch given, run_batch instead returns an opaque in-flight
    handle and finish_batch(handle, items) -> results runs on a second
    thread (pipelined mode, see module docstring). Exceptions from either
    stage propagate to every Future of that batch. Thread-safe; close()
    stops the workers and fails every still-queued Future with
    RuntimeError("batcher closed") so no caller blocks out its full result
    timeout."""

    def __init__(
        self,
        run_batch: Callable[[List], object],
        *,
        finish_batch: Optional[Callable[[object, List], List]] = None,
        max_batch_size: int = 16,
        max_wait_ms: float = 10.0,
        max_backlog: Optional[int] = None,
        finish_watchdog_s: float = 120.0,
        name: str = "batcher",
    ):
        self._run = run_batch
        self._finish = finish_batch
        self.max_batch_size = int(max_batch_size)
        self.max_wait_ms = float(max_wait_ms)
        # backlog cap: if the device wedges (a result that never arrives),
        # submits fail loudly once the queue hits the cap instead of growing
        # without bound while every client blocks out its full timeout
        self.max_backlog = (64 * self.max_batch_size if max_backlog is None
                            else int(max_backlog))
        # request queue: deque + Condition (not queue.Queue) so the dispatch
        # thread can block on "a request arrived or the pipeline freed"
        # instead of polling: a 2 ms poll loop steals GIL time from the HTTP
        # threads that decode the images
        self._rq: deque = deque()
        self._cv = threading.Condition()
        # held across every device dispatch; other device work (the bucket
        # warm-up) takes it too, so only one thread at a time launches
        # kernels
        self.dispatch_lock = threading.Lock()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.requests = 0
        self.batches = 0
        self.batched_requests = 0  # requests that shared a batch with others
        self.bucket_counts: Counter = Counter()  # batch size -> #batches
        # bounded: long-lived servers must not accumulate one float per
        # request forever; percentiles only ever read the tail anyway
        self.latencies_ms = deque(maxlen=2000)
        self.queue_wait_ms = deque(maxlen=2000)  # submit -> dispatch start
        self.dispatch_ms = deque(maxlen=500)  # per batch: upload + launch
        self.finish_ms = deque(maxlen=500)  # per batch: result wait + postproc
        # union of per-batch [dispatch_start, finish_end] spans since the
        # last reset — busy/wall is the device-utilization figure the bench
        # reports (spans include host postprocess; a slight overcount)
        self.device_busy_s = 0.0
        self._busy_until = 0.0
        self._t_reset = time.monotonic()
        # pipelined mode: one batch may sit here fully dispatched while the
        # next is being collected/uploaded — depth 1 keeps device-queue
        # latency bounded at ~2 batches
        self._pending: Optional[queue.Queue] = (
            queue.Queue(maxsize=1) if finish_batch is not None else None)
        # watchdog: if one finish_batch call (the wait for a device result)
        # runs longer than this, the batcher declares itself wedged: submits
        # fail loudly instead of queueing until the client timeout
        self.finish_watchdog_s = float(finish_watchdog_s)
        self._finish_t0: Optional[float] = None  # guarded by _lock
        self._thread = threading.Thread(target=self._loop, daemon=True, name=name)
        self._thread.start()
        self._finisher = None
        if finish_batch is not None:
            self._finisher = threading.Thread(
                target=self._finish_loop, daemon=True, name=f"{name}-finish")
            self._finisher.start()

    def submit(self, item) -> Future:
        if self._stop.is_set():
            raise RuntimeError("batcher is closed")
        with self._lock:
            wedge_t0 = self._finish_t0
        if (wedge_t0 is not None
                and time.monotonic() - wedge_t0 > self.finish_watchdog_s):
            raise RuntimeError(
                f"batcher wedged: finish_batch stuck for "
                f">{self.finish_watchdog_s:.0f}s (a device result that never arrived?)")
        fut: Future = Future()
        with self._cv:
            if len(self._rq) >= self.max_backlog:
                raise RuntimeError(
                    f"batcher overloaded: {len(self._rq)} queued requests "
                    f"(cap {self.max_backlog}) — device wedged or undersized")
            self._rq.append((item, fut, time.monotonic()))
            self._cv.notify_all()
        return fut

    @staticmethod
    def _pcts(values) -> dict:
        vals = sorted(values)
        if not vals:
            return {"p50": None, "p95": None, "mean": None}
        return {
            "p50": vals[len(vals) // 2],
            "p95": vals[int(len(vals) * 0.95)],
            "mean": sum(vals) / len(vals),
        }

    def stats(self) -> dict:
        with self._lock:
            lat = self._pcts(list(self.latencies_ms)[-1000:])
            qw = self._pcts(list(self.queue_wait_ms)[-1000:])
            disp = self._pcts(self.dispatch_ms)
            fin = self._pcts(self.finish_ms)
            return {
                "requests": self.requests,
                "batches": self.batches,
                "mean_batch_size": (self.requests / self.batches) if self.batches else 0.0,
                "batched_requests": self.batched_requests,
                "buckets": dict(sorted(self.bucket_counts.items())),
                "p50_ms": lat["p50"],
                "p95_ms": lat["p95"],
                "queue_wait_p50_ms": qw["p50"],
                "queue_wait_p95_ms": qw["p95"],
                "dispatch_mean_ms": disp["mean"],
                "finish_mean_ms": fin["mean"],
                "device_busy_s": self.device_busy_s,
                "window_s": time.monotonic() - self._t_reset,
            }

    def reset_stats(self) -> None:
        """Zero the counters (callers reset after the warm-up, so first-call
        set-up does not enter the latency percentiles)."""
        with self._lock:
            self.requests = self.batches = self.batched_requests = 0
            self.bucket_counts.clear()
            self.latencies_ms.clear()
            self.queue_wait_ms.clear()
            self.dispatch_ms.clear()
            self.finish_ms.clear()
            self.device_busy_s = 0.0
            self._busy_until = 0.0
            self._t_reset = time.monotonic()

    def _drain_failed(self) -> None:
        while True:
            with self._cv:
                if not self._rq:
                    return
                _, fut, _ = self._rq.popleft()
            if not fut.done():
                fut.set_exception(RuntimeError("batcher closed"))

    def close(self) -> None:
        self._stop.set()
        # fail queued futures first: a wedged pipeline must not hold every
        # queued client hostage behind the join timeouts below
        self._drain_failed()
        with self._cv:
            self._cv.notify_all()  # wake a blocked dispatch thread
        self._thread.join(timeout=30)
        if self._finisher is not None:
            with self._lock:
                wedged = (self._finish_t0 is not None and
                          time.monotonic() - self._finish_t0 > self.finish_watchdog_s)
            # don't wait out a wedged fetch — the daemon thread dies with us
            self._finisher.join(timeout=1 if wedged else 30)
        # backstop for the submit()/close() race: anything enqueued after
        # the worker's own exit drain still gets failed here
        self._drain_failed()

    # -- worker threads -----------------------------------------------------

    def _collect(self, first) -> list:
        """Coalesce requests: up to max_batch_size, waiting max_wait_ms past
        the first arrival — except while the pipeline is full, where we keep
        draining (device busy = free coalescing time). Blocks on the
        condition (woken by submit() and by the finisher freeing the
        pipeline slot) — never polls."""
        batch = [first]
        deadline = time.monotonic() + self.max_wait_ms / 1e3
        with self._cv:
            while len(batch) < self.max_batch_size and not self._stop.is_set():
                while self._rq and len(batch) < self.max_batch_size:
                    batch.append(self._rq.popleft())
                if len(batch) >= self.max_batch_size:
                    break
                busy = self._pending is not None and self._pending.full()
                left = deadline - time.monotonic()
                if left <= 0 and not busy:
                    break
                # wake on: new request, pipeline slot freed, or deadline
                self._cv.wait(timeout=left if left > 0 else None)
        return batch

    def _fail_batch(self, batch, exc) -> None:
        for _, fut, _ in batch:
            if not fut.done():
                fut.set_exception(exc)

    def _record(self, batch, t_dispatch0, dispatch_ms, finish_ms) -> None:
        now = time.monotonic()
        with self._lock:
            self.requests += len(batch)
            self.batches += 1
            self.bucket_counts[len(batch)] += 1
            if len(batch) > 1:
                self.batched_requests += len(batch)
            self.latencies_ms.extend((now - t0) * 1e3 for _, _, t0 in batch)
            self.queue_wait_ms.extend((t_dispatch0 - t0) * 1e3 for _, _, t0 in batch)
            self.dispatch_ms.append(dispatch_ms)
            self.finish_ms.append(finish_ms)
            # merge [t_dispatch0, now] into the busy-span union (pipeline
            # depth 1 means at most one overlapping predecessor)
            start = max(t_dispatch0, self._busy_until)
            if now > start:
                self.device_busy_s += now - start
                self._busy_until = now

    def _loop(self) -> None:
        while not self._stop.is_set():
            with self._cv:
                if not self._rq:
                    # 0.5s backstop only (close() notifies the condition)
                    self._cv.wait(timeout=0.5)
                if not self._rq:
                    continue
                first = self._rq.popleft()
            batch = self._collect(first)
            items = [b[0] for b in batch]
            t0 = time.monotonic()
            try:
                with self.dispatch_lock:
                    out = self._run(items)
            except Exception as e:  # noqa: BLE001 — propagate to callers
                self._fail_batch(batch, e)
                # failed batches still count (an erroring endpoint must not
                # look idle in /stats)
                self._record(batch, t0, (time.monotonic() - t0) * 1e3, 0.0)
                continue
            dispatch_ms = (time.monotonic() - t0) * 1e3
            if self._pending is None:
                # single-stage: `out` IS the result list
                t1 = time.monotonic()
                try:
                    if len(out) != len(items):
                        raise RuntimeError(
                            f"run_batch returned {len(out)} results for {len(items)} items")
                    for (_, fut, _), o in zip(batch, out):
                        fut.set_result(o)
                except Exception as e:  # noqa: BLE001
                    self._fail_batch(batch, e)
                    self._record(batch, t0, dispatch_ms, (time.monotonic() - t1) * 1e3)
                    continue
                self._record(batch, t0, dispatch_ms, (time.monotonic() - t1) * 1e3)
            else:
                # stop-aware put: a wedged finisher keeps the slot occupied
                # forever — the dispatch thread must still exit on close()
                entry = (out, batch, items, t0, dispatch_ms)
                while not self._stop.is_set():
                    try:
                        self._pending.put(entry, timeout=0.5)
                        entry = None
                        break
                    except queue.Full:
                        continue
                if entry is not None:
                    self._fail_batch(batch, RuntimeError("batcher closed"))
        if self._pending is not None:
            # wake the finisher promptly with a sentinel; if the slot is
            # wedged/full, skip it — the finisher's own 0.5s stop backstop
            # (see _finish_loop) handles shutdown
            try:
                self._pending.put_nowait(None)
            except queue.Full:
                pass
        self._drain_failed()  # stop requested: fail anything still queued

    def _finish_loop(self) -> None:
        while True:
            try:
                entry = self._pending.get(timeout=0.5)
            except queue.Empty:
                # 0.5s stop backstop (same pattern as _loop): a close() whose
                # sentinel couldn't be enqueued still terminates this thread
                if self._stop.is_set():
                    return
                continue
            with self._cv:
                # pipeline slot freed: wake a dispatch thread blocked in
                # _collect's busy-drain so it stops coalescing and dispatches
                self._cv.notify_all()
            if entry is None:
                return
            handle, batch, items, t0, dispatch_ms = entry
            t1 = time.monotonic()
            with self._lock:
                self._finish_t0 = t1  # watchdog arm: one fetch in flight
            try:
                outs = self._finish(handle, items)
                if len(outs) != len(items):
                    raise RuntimeError(
                        f"finish_batch returned {len(outs)} results for {len(items)} items")
                for (_, fut, _), o in zip(batch, outs):
                    fut.set_result(o)
            except Exception as e:  # noqa: BLE001 — propagate to callers
                self._fail_batch(batch, e)
                self._record(batch, t0, dispatch_ms, (time.monotonic() - t1) * 1e3)
                continue
            finally:
                with self._lock:
                    self._finish_t0 = None  # watchdog disarm
            self._record(batch, t0, dispatch_ms, (time.monotonic() - t1) * 1e3)
