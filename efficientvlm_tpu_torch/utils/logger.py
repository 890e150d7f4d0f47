"""Windowed metric smoothing and iteration logging (port of
efficientvlm_tpu/utils/logger.py, the reference's utils/__init__.py
SmoothedValue and MetricLogger.log_every with its ETA lines). Above one
process synchronize_between_processes sums each meter's (count, total) over
the ranks (the host group of utils/dist), so every rank logs the world's
global averages.
"""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Iterable, Optional

from ..train.profiler import span

_END = object()  # log_every's iterable is exhausted


class SmoothedValue:
    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1) -> None:
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    def synchronize_between_processes(self) -> None:
        """(count, total) summed over the processes (reference :118-129); one
        process keeps its own."""
        from .dist import get_world_size, host_all_reduce_sum

        if get_world_size() == 1:
            return
        count, total = host_all_reduce_sum([self.count, self.total])
        self.count, self.total = int(count), total

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value,
        )


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: dict = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        # after a log_every loop: its wall seconds, the seconds it waited for
        # the iterable's next item, and its iterations
        self.loop_seconds = self.wait_seconds = 0.0
        self.iterations = 0

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def add_meter(self, name: str, meter: SmoothedValue) -> None:
        self.meters[name] = meter

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self) -> str:
        return self.delimiter.join(f"{name}: {meter}" for name, meter in self.meters.items())

    def global_avg(self) -> str:
        return self.delimiter.join(
            f"{name}: {meter.global_avg:.4f}" for name, meter in self.meters.items()
        )

    def synchronize_between_processes(self) -> None:
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def log_every(self, iterable: Iterable, print_freq: int, header: str = "", total: Optional[int] = None):
        i = 0
        start_time = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        if total is None:
            try:
                total = len(iterable)  # type: ignore[arg-type]
            except TypeError:
                total = None
        items = iter(iterable)
        while True:
            with span("evlm.loop.wait"):
                obj = next(items, _END)
            if obj is _END:
                break
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                if total:
                    eta = datetime.timedelta(seconds=int(iter_time.global_avg * (total - i)))
                    print(f"{header} [{i}/{total}] eta: {eta} {self} "
                          f"time: {iter_time} data: {data_time}", flush=True)
                else:
                    print(f"{header} [{i}] {self} time: {iter_time} data: {data_time}", flush=True)
            i += 1
            end = time.time()
        total_time = time.time() - start_time
        self.loop_seconds, self.wait_seconds, self.iterations = total_time, data_time.total, i
        print(f"{header} Total time: {datetime.timedelta(seconds=int(total_time))}", flush=True)
