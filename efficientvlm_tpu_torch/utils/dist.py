"""Process topology and the collectives of data-parallel training (port of
efficientvlm_tpu/utils/dist.py, whose reference is utils/__init__.py:391-413:
rank discovery from the environment, process-group init, the rank-0 print).

A launch of N processes follows torchrun's contract: each process reads
RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT.
init_distributed_mode then joins the default process group: NCCL when the
run is on the card (each process on the device LOCAL_RANK names), gloo when
it asks for the CPU. Host values (meters, the preemption flag, evaluation
scores, barriers around files) go through a gloo group of their own
(host_group): under NCCL the default group cannot reduce CPU tensors.

The two collectives the port's steps need:
- all_reduce_mean: a list of tensors (gradients, metrics) averaged over the
  ranks, flattened into buckets of BUCKET_BYTES per device and dtype (sum,
  then / world size, as JAX's pmean);
- all_gather_with_grad: the ITC's world batch. Its forward gathers every
  rank's rows; its backward sums the cotangent over the ranks and returns
  this rank's slice (jax.lax.all_gather's transpose, the reference's
  AllGather). The gather is an all_reduce of a zero-padded buffer, so it
  runs on every backend (gloo gathers no CUDA tensors) and is exact: each
  entry is one rank's value plus zeros.

Without WORLD_SIZE in the environment a run is rank 0 of 1 and joins no
group."""

from __future__ import annotations

import builtins
import os
import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

BUCKET_BYTES = 25 * 2 ** 20  # torch DDP's default bucket size

_HOST_GROUP = {"group": None}


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def setup_for_distributed(is_master: bool) -> None:
    """print only on the main process, unless called with force=True."""
    builtin_print = builtins.print

    def print_fn(*args, **kwargs):
        force = kwargs.pop("force", False)
        if is_master or force:
            builtin_print(*args, **kwargs)

    builtins.print = print_fn


_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_distributed_mode(args: Optional[dict] = None, *, device=None,
                          backend: Optional[str] = None) -> dict:
    """{"rank", "world_size", "num_devices", "local_devices"} of this run.
    With WORLD_SIZE in the environment (torchrun's contract; WORLD_SIZE=1
    too) the process joins the default group once: `backend` (default nccl
    unless `device` is "cpu", then gloo), on cuda:LOCAL_RANK for nccl. A
    launch missing one of RANK, MASTER_ADDR, MASTER_PORT raises ValueError
    rather than wait for peers that were never started."""
    if "WORLD_SIZE" in os.environ and not is_initialized():
        missing = [k for k in _ENV if not os.environ.get(k)]
        if missing:
            raise ValueError(f"WORLD_SIZE={os.environ['WORLD_SIZE']} without "
                             f"{', '.join(missing)}: launch with torchrun or set them")
        cpu = device is not None and torch.device(device).type == "cpu"
        backend = backend or ("gloo" if cpu else "nccl")
        local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
        kw = {}
        if not cpu:
            torch.cuda.set_device(local)
            if backend == "nccl":
                kw["device_id"] = torch.device("cuda", local)
        dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]), **kw)
        host_group()  # every rank makes the host group here, in the same order
    world = get_world_size()
    info = {"rank": get_rank(), "world_size": world, "num_devices": world, "local_devices": 1}
    setup_for_distributed(is_main_process())
    return info


def host_group():
    """The process group for CPU tensors: the default group under gloo, a
    gloo group over the same ranks (made once) under NCCL; None in a
    one-process run."""
    if not is_initialized():
        return None
    if dist.get_backend() == "gloo":
        return dist.group.WORLD
    if _HOST_GROUP["group"] is None:
        _HOST_GROUP["group"] = dist.new_group(backend="gloo")
    return _HOST_GROUP["group"]


def destroy() -> None:
    """Leave the process group (the host group with it)."""
    if is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP["group"] = None


def barrier() -> None:
    if is_initialized():
        dist.barrier(group=host_group())


def host_all_reduce_sum(values: Sequence[float]) -> List[float]:
    """Host numbers summed over the ranks (f64, the host group)."""
    t = torch.tensor(list(values), dtype=torch.float64)
    if get_world_size() > 1:
        dist.all_reduce(t, group=host_group())
    return t.tolist()


def _buckets(tensors: Sequence[Optional[torch.Tensor]], bucket_bytes: int) -> List[List[int]]:
    """Indices of the non-None tensors, grouped by device and dtype in
    order, each group cut into buckets of about bucket_bytes."""
    by_kind: dict = {}
    for i, t in enumerate(tensors):
        if t is not None:
            by_kind.setdefault((t.device, t.dtype), []).append(i)
    out = []
    for idx in by_kind.values():
        bucket, size = [], 0
        for i in idx:
            n = tensors[i].numel() * tensors[i].element_size()
            if bucket and size + n > bucket_bytes:
                out.append(bucket)
                bucket, size = [], 0
            bucket.append(i)
            size += n
        out.append(bucket)
    return out


def all_reduce_mean(tensors: Sequence[Optional[torch.Tensor]], group=None, *,
                    bucket_bytes: int = BUCKET_BYTES) -> List[Optional[torch.Tensor]]:
    """Each tensor's mean over the group's ranks (None stays None: every
    rank must pass the same Nones, shapes and dtypes), as new tensors.
    Sum, then divide by the world size, bucket by bucket."""
    world = dist.get_world_size(group)
    out = list(tensors)
    with torch.no_grad():
        for bucket in _buckets(out, bucket_bytes):
            flat = torch.cat([out[i].detach().reshape(-1) for i in bucket])
            dist.all_reduce(flat, group=group)
            flat.div_(world)
            at = 0
            for i in bucket:
                n = out[i].numel()
                out[i] = flat[at:at + n].view_as(out[i])
                at += n
    return out


class _AllGatherWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        ctx.group, ctx.rank, ctx.rows = group, rank, x.shape[0]
        full = x.new_zeros((world * x.shape[0],) + tuple(x.shape[1:]))
        full[rank * x.shape[0]:(rank + 1) * x.shape[0]] = x
        dist.all_reduce(full, group=group)
        return full

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def all_gather_with_grad(x: torch.Tensor, group=None) -> torch.Tensor:
    """[world * B, ...]: every rank's x (equal shapes) in rank order; the
    gradient of this rank's x is the sum over the ranks of the cotangent's
    rows of this rank."""
    return _AllGatherWithGrad.apply(x, group)


class GradientSync:
    """The data-parallel reduction of a train step (drivers/common.
    build_train_step gives one to the step above one process): begin(state)
    sets the step's params, gates and λs to rank 0's once per state object;
    __call__(metrics, grads) averages the step's metrics and every gradient
    group (params, loga, λ, or one list) over the group in one
    all_reduce_mean, so every rank applies the same update. `group` is also
    the ITC's gather group. Each call appends (bytes, seconds) to `calls`:
    the seconds from CUDA events on the card (read by call_ms), the host
    clock on the CPU."""

    def __init__(self, group=None):
        self.group = dist.group.WORLD if group is None else group
        self.calls: list = []
        self._state_id = None

    def begin(self, state) -> None:
        if id(state) == self._state_id:
            return
        from ..train.optim import tree_leaves

        trees = [state.params] + [getattr(state, k) for k in ("loga", "lam") if hasattr(state, k)]
        with torch.no_grad():
            for t in (t for tree in trees for t in tree_leaves(tree)):
                dist.broadcast(t.data, src=0, group=self.group)
        self._state_id = id(state)

    def __call__(self, metrics: dict, grads):
        grouped = isinstance(grads, tuple)
        groups = list(grads) if grouped else [grads]
        flat = [g for group in groups for g in group]
        dev = next((g.device for g in flat if g is not None), None)
        keys = list(metrics)
        vals = [torch.as_tensor(metrics[k], dtype=torch.float32, device=dev).reshape(())
                for k in keys]
        nbytes = sum(t.numel() * t.element_size() for t in flat + vals if t is not None)
        cuda = dev is not None and dev.type == "cuda"
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        reduced = all_reduce_mean(flat + vals, self.group)
        if cuda:
            end.record()
            self.calls.append((nbytes, (start, end)))
        else:
            self.calls.append((nbytes, time.perf_counter() - t0))
        out, at = [], 0
        for group in groups:
            out.append(reduced[at:at + len(group)])
            at += len(group)
        metrics = dict(zip(keys, reduced[len(flat):]))
        return metrics, (tuple(out) if grouped else out[0])

    def call_ms(self) -> List[float]:
        """Each call's milliseconds (waits for the card's events)."""
        out = []
        for _, t in self.calls:
            if isinstance(t, tuple):
                t[1].synchronize()
                out.append(t[0].elapsed_time(t[1]))
            else:
                out.append(t * 1e3)
        return out
