"""Batches built ahead of the step on the host (the port's copy of
efficientvlm_tpu/data/prefetch.py): Prefetcher keeps a few batches of any
iterable ready in a thread; ParallelMapLoader builds a SimpleLoader's
batches with a thread pool; ProcessMapLoader with a pool of worker
processes, which decode and augment without the parent's interpreter lock.

ProcessMapLoader's workers are spawned, not forked: the parent may hold a
CUDA context (a fork of it can deadlock), and a spawned worker starts from
a fresh interpreter that imports only this package's host data modules
(numpy, PIL), never torch, so it cannot touch the card. Its pool is a
ProcessPoolExecutor, not a multiprocessing.Pool: Pool.terminate() with
batches in flight, as when a loop stops early, can hang in joining its
result thread (seen on the H100's host). Each batch reseeds
the dataset transform's generator from (seed, epoch, first position), so a
batch does not depend on the worker count or on which worker built it.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import threading
from collections import deque
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Iterable, Iterator, Optional

import numpy as np


class Prefetcher:
    """Iterates `iterable` in a thread, up to `depth` items ahead; an error
    there is raised here."""

    _SENTINEL = object()

    def __init__(self, iterable: Iterable, depth: int = 2):
        self.iterable = iterable
        self.depth = depth

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        err: list = []

        def worker():
            try:
                for item in self.iterable:
                    q.put(item)
            except BaseException as e:  # noqa: BLE001 -- raised again in the consumer
                err.append(e)
            finally:
                q.put(self._SENTINEL)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is self._SENTINEL:
                if err:
                    raise err[0]
                return
            yield item


def _ordered(submit, starts, in_flight: int, wait):
    """Submit a batch for each start, keep `in_flight` in flight, yield
    their results in order (wait(handle) -> batch)."""
    pending: deque = deque()
    it = iter(starts)
    for i in it:
        pending.append(submit(i))
        if len(pending) >= in_flight:
            break
    for i in it:
        yield wait(pending.popleft())
        pending.append(submit(i))
    while pending:
        yield wait(pending.popleft())


class ParallelMapLoader:
    """A SimpleLoader's batches, each built by one thread of a pool of
    num_workers (the dataset's __getitem__ and collate_fn), in order."""

    def __init__(self, loader, num_workers: int = 4, prefetch_depth: int = 2):
        self.loader = loader
        self.num_workers = num_workers
        self.prefetch_depth = prefetch_depth

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self) -> Iterator:
        base = self.loader
        idx = base._indices()

        def build(i):
            return base.collate_fn([base.dataset[int(j)] for j in idx[i:i + base.batch_size]])

        with ThreadPoolExecutor(self.num_workers) as pool:
            yield from _ordered(lambda i: pool.submit(build, i), base.batch_starts(idx),
                                self.num_workers + self.prefetch_depth, lambda f: f.result())


_WORKER: dict = {}


def _worker_init(dataset, collate_fn):
    _WORKER.update(dataset=dataset, collate=collate_fn)


def _worker_batch(chunk, reseed):
    dataset = _WORKER["dataset"]
    transform = getattr(dataset, "transform", None)
    if getattr(transform, "rng", None) is not None:
        transform.rng = np.random.default_rng(reseed)
        if getattr(transform, "randaug", None) is not None:
            transform.randaug.rng = transform.rng
    return _WORKER["collate"]([dataset[j] for j in chunk])


class ProcessMapLoader:
    """A SimpleLoader's batches, each built whole by one of num_workers
    spawned processes (a ProcessPoolExecutor), in order. The dataset and
    collate_fn are pickled to each worker once. batch_timeout (seconds)
    bounds the wait for each batch: past it the workers are stopped and
    concurrent.futures.TimeoutError is raised. Leaving the loop early
    cancels the batches not yet started and waits for the running ones."""

    def __init__(self, loader, num_workers: int = 4, prefetch_depth: int = 2, seed: int = 42,
                 batch_timeout: Optional[float] = None):
        self.loader = loader
        self.num_workers = num_workers
        self.prefetch_depth = prefetch_depth
        self.seed = seed
        self.batch_timeout = batch_timeout
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self) -> Iterator:
        base = self.loader
        idx = base._indices()
        pool = ProcessPoolExecutor(self.num_workers, mp_context=mp.get_context("spawn"),
                                   initializer=_worker_init,
                                   initargs=(base.dataset, base.collate_fn))

        def submit(i):
            chunk = [int(j) for j in idx[i:i + base.batch_size]]
            return pool.submit(_worker_batch, chunk, (self.seed, self._epoch, i))

        try:
            yield from _ordered(submit, base.batch_starts(idx),
                                self.num_workers + self.prefetch_depth,
                                lambda f: f.result(self.batch_timeout))
        except FuturesTimeout:
            # a worker that does not answer would hold shutdown forever; the
            # executor has no public way to stop its workers before Python 3.14
            for proc in list(pool._processes.values()):
                proc.terminate()
            raise
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
