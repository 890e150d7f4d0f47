"""Times the port's host loaders on the retrieval train set read from files
(chip_smoke.write_data_corpus: 48 textured 640 x 480 JPEGs x 5 captions,
ImageTransform.train(384), batches of 24), to tell where a loader's time
goes on the machine that feeds the card:

    python3 scripts/torch_loader_bench.py [--workers 1,2,4,8] [--epochs 2]

For each loader (ParallelMapLoader threads and ProcessMapLoader spawned
processes, at each worker count; one process, SimpleLoader, once) it prints
one JSON line: images/s over `--epochs` epochs (a pool's start included),
the wait for the first batch, and images/s after the loader's in-flight
window (workers + 2 batches) filled. For the process loader each batch
also carries the worker's own wall and CPU seconds building it, so the
line shows the workers' compute rate apart from the transfer to the
parent. It also prints the host's CPU affinity and cgroup CPU quota, the
time to pickle and unpickle one batch, and, where a CUDA device is
present, the process loader at the largest worker count again with a
CUDA context created in the parent first. The corpus lives under build/
and is removed after.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


_SPENT = [0.0, 0.0]  # this process's wall and CPU seconds in the current batch


class TimedDataset:
    """The dataset, its items' wall and CPU seconds added to _SPENT (read in
    the process that builds the batch; picklable, so it reaches spawned
    workers). `transform` is the dataset's own, which the loaders reseed."""

    def __init__(self, dataset):
        self.dataset, self.transform = dataset, dataset.transform

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        t0, c0 = time.perf_counter(), time.process_time()
        out = self.dataset[i]
        _SPENT[0] += time.perf_counter() - t0
        _SPENT[1] += time.process_time() - c0
        return out


def timed_collate(samples):
    """default_collate, and the batch's wall and CPU seconds in its worker."""
    from efficientvlm_tpu_torch.data.datasets import default_collate

    t0, c0 = time.perf_counter(), time.process_time()
    batch = default_collate(samples)
    spent = (_SPENT[0] + time.perf_counter() - t0, _SPENT[1] + time.process_time() - c0)
    _SPENT[:] = [0.0, 0.0]
    return batch, spent


def run(name: str, loader, epochs: int, window: int, batch: int) -> dict:
    t0 = time.perf_counter()
    arrived, work = [], []
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        for out in loader:
            arrived.append(time.perf_counter() - t0)
            if len(out) == 2:  # (batch, the worker's seconds) from timed_collate
                work.append(out[1])
    n = len(arrived)
    row = {"loader": name, "batches": n, "images_per_s": n * batch / arrived[-1],
           "first_batch_s": arrived[0],
           "steady_per_s": (n - window) * batch / (arrived[-1] - arrived[window - 1])}
    if work:
        wall = sum(w for w, _ in work) / len(work)
        row.update(worker_batch_wall_s=wall, worker_batch_cpu_s=sum(c for _, c in work)
                   / len(work), worker_images_per_s_each=batch / wall)
    print(json.dumps(row), flush=True)
    return row


def main(argv) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workers", default="1,2,4,8")
    p.add_argument("--epochs", type=int, default=2)
    args = p.parse_args(argv)
    sys.path.insert(0, HERE)
    import numpy as np

    import chip_smoke
    from efficientvlm_tpu_torch.data import prefetch
    from efficientvlm_tpu_torch.data.datasets import RetrievalTrainDataset, SimpleLoader
    from efficientvlm_tpu_torch.data.transforms import ImageTransform

    quota = "not found"
    if os.path.exists("/sys/fs/cgroup/cpu.max"):
        with open("/sys/fs/cgroup/cpu.max") as f:
            quota = f.read().strip()
    print(json.dumps({"cpu_count": os.cpu_count(), "affinity": len(os.sched_getaffinity(0)),
                      "cgroup_cpu_max": quota}), flush=True)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="loader-corpus-", dir=os.path.join(HERE, "build"))
    try:
        files = chip_smoke.write_data_corpus(root, np.random.default_rng(0))
        u = chip_smoke.DATA_UNIT
        b = u["batch"]
        dataset = RetrievalTrainDataset(files["retrieval_train"],
                                        ImageTransform.train(384, seed=0), root, max_words=40)

        def base(timed=False):
            return SimpleLoader(TimedDataset(dataset) if timed else dataset, batch_size=b,
                                shuffle=True, drop_last=True,
                                collate_fn=timed_collate if timed else None)

        one = next(iter(base()))
        t0 = time.perf_counter()
        blob = pickle.dumps(one, protocol=pickle.HIGHEST_PROTOCOL)
        t1 = time.perf_counter()
        pickle.loads(blob)
        print(json.dumps({"batch_mb": len(blob) / 1e6, "pickle_s": t1 - t0,
                          "unpickle_s": time.perf_counter() - t1}), flush=True)
        run("1_process", base(), args.epochs, 6, b)
        counts = [int(w) for w in args.workers.split(",")]
        for w in counts:
            run(f"{w}_threads", prefetch.ParallelMapLoader(base(), w), args.epochs, w + 2, b)
        for w in counts:
            run(f"{w}_processes", prefetch.ProcessMapLoader(base(True), w, batch_timeout=300),
                args.epochs, w + 2, b)
        try:
            import torch
        except ImportError:
            torch = None
        if torch is not None and torch.cuda.is_available():
            torch.zeros(1, device="cuda")
            w = max(counts)
            run(f"{w}_processes_cuda_parent",
                prefetch.ProcessMapLoader(base(True), w, batch_timeout=300), args.epochs,
                w + 2, b)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
