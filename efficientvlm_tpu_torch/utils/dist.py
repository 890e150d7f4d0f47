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

The collectives of the data-parallel step:
- all_reduce_mean: a list of tensors (gradients, metrics) averaged over the
  ranks, flattened into buckets of BUCKET_BYTES per device and dtype (sum,
  then / world size, as JAX's pmean);
- all_gather_with_grad: the ITC's world batch. Its forward gathers every
  rank's rows; its backward sums the cotangent over the ranks and returns
  this rank's slice (jax.lax.all_gather's transpose, the reference's
  AllGather): gather_dim along the rows, below.

The collectives of ZeRO-1, tensor, sequence, pipeline and expert
parallelism go through one set of helpers here: reduce_scatter_sum,
all_gather_rows, all_to_all_rows, send / recv, and gather_dim (an
all-gather along a dim whose backward is the reduce-scatter). NCCL runs
them on CUDA tensors natively; gloo takes CUDA tensors for all_reduce and
broadcast only, so there each of the others is staged through pinned host
memory (copy out, the collective on the host, copy back). The two ranks of
one card run over gloo, because NCCL refuses two ranks on one device.

Without WORLD_SIZE in the environment a run is rank 0 of 1 and joins no
group."""

from __future__ import annotations

import builtins
import collections
import os
import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

BUCKET_BYTES = 25 * 2 ** 20  # torch DDP's default bucket size
RECORD_WINDOW = 64  # the calls a recording GradientSync keeps

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


# ---------------------------------------------------------------------------
# rows collectives (dim 0), staged through pinned host memory under gloo


def _staged(t: torch.Tensor, group) -> bool:
    """Whether `t` goes through host memory: a CUDA tensor under gloo."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf


def _run_staged(fn, x: torch.Tensor, out_shape, group) -> torch.Tensor:
    """fn(out, inp) on x's device, or on pinned host copies under gloo with a
    CUDA x (the result copied back)."""
    x = x.contiguous()
    if not _staged(x, group):
        out = x.new_empty(out_shape)
        fn(out, x)
        return out
    out = torch.empty(out_shape, dtype=x.dtype, pin_memory=True)
    fn(out, _host(x))
    return out.to(x.device, non_blocking=False)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """A new tensor: x summed over the group's ranks (gloo takes CUDA
    tensors for this one)."""
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, group=group)
    return out


def reduce_scatter_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """x [world * m, ...] summed over the ranks; this rank's rows [m, ...]
    (rank r's are rows r*m:(r+1)*m)."""
    world = dist.get_world_size(group)
    if x.shape[0] % world:
        raise ValueError(f"reduce_scatter_sum: {x.shape[0]} rows over {world} ranks")
    shape = (x.shape[0] // world,) + tuple(x.shape[1:])
    return _run_staged(lambda o, i: dist.reduce_scatter_tensor(o, i, group=group),
                       x, shape, group)


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """[world * m, ...]: every rank's x [m, ...] (equal shapes) in rank
    order."""
    world = dist.get_world_size(group)
    shape = (world * x.shape[0],) + tuple(x.shape[1:])
    return _run_staged(lambda o, i: dist.all_gather_into_tensor(o, i, group=group),
                       x, shape, group)


def all_to_all_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """x [world * m, ...]: rows j*m:(j+1)*m go to rank j; returns [world * m,
    ...] whose rows r*m:(r+1)*m came from rank r."""
    world = dist.get_world_size(group)
    if x.shape[0] % world:
        raise ValueError(f"all_to_all_rows: {x.shape[0]} rows over {world} ranks")
    return _run_staged(lambda o, i: dist.all_to_all_single(o, i, group=group),
                       x, tuple(x.shape), group)


def send(x: torch.Tensor, dst: int, group=None) -> None:
    """Send x to global rank dst (staged under gloo with a CUDA x)."""
    x = x.detach().contiguous()
    dist.send(_host(x) if _staged(x, group) else x, dst, group=group)


def recv(like: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """A tensor of like's shape, dtype and device received from global rank
    src."""
    if not _staged(like, group):
        out = torch.empty_like(like)
        dist.recv(out, src, group=group)
        return out
    buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
    dist.recv(buf, src, group=group)
    return buf.to(like.device)


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        rows = all_gather_rows(x.movedim(dim, 0), group)
        return rows.movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        g = reduce_scatter_sum(grad.movedim(ctx.dim, 0), ctx.group)
        return g.movedim(0, ctx.dim), None, None


def gather_dim(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's x concatenated along `dim` in rank order (equal shapes);
    the gradient of this rank's x is its block of the cotangent summed over
    the ranks (the reduce-scatter)."""
    return _GatherDim.apply(x, dim, group)


def all_gather_with_grad(x: torch.Tensor, group=None) -> torch.Tensor:
    """[world * B, ...]: every rank's x (equal shapes) in rank order; the
    gradient of this rank's x is the sum over the ranks of the cotangent's
    rows of this rank (gather_dim along the rows)."""
    return gather_dim(x, 0, group)


class GradientSync:
    """The data-parallel reduction of a train step (drivers/common.
    build_train_step gives one to the step above one process): begin(state)
    sets the step's params, gates and λs to rank 0's once per state object;
    __call__(metrics, grads) averages the step's metrics and every gradient
    group (params, loga, λ, or one list) over the group in one
    all_reduce_mean, so every rank applies the same update. `group` is also
    the ITC's gather group. With record=True each call appends (bytes,
    seconds) to `calls`, which keeps the last RECORD_WINDOW: the seconds
    from CUDA events on the card (read by call_ms), the host clock on the
    CPU. A driver's sync records nothing."""

    reduce_grads = True  # ZeRO-1's sync leaves the gradients to its optimizers

    def __init__(self, group=None, *, record: bool = False):
        self.group = dist.group.WORLD if group is None else group
        self.record = record
        self.calls: collections.deque = collections.deque(maxlen=RECORD_WINDOW)
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
        flat = [g for group in groups for g in group] if self.reduce_grads else []
        dev = next((g.device for group in groups for g in group if g is not None), None)
        keys = list(metrics)
        vals = [torch.as_tensor(metrics[k], dtype=torch.float32, device=dev).reshape(())
                for k in keys]
        cuda = self.record and dev is not None and dev.type == "cuda"
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        reduced = all_reduce_mean(flat + vals, self.group)
        if self.record:
            nbytes = sum(t.numel() * t.element_size() for t in flat + vals if t is not None)
            if cuda:
                end.record()
                self.calls.append((nbytes, (start, end)))
            else:
                self.calls.append((nbytes, time.perf_counter() - t0))
        metrics = dict(zip(keys, reduced[len(flat):]))
        if not self.reduce_grads:
            return metrics, grads
        out, at = [], 0
        for group in groups:
            out.append(reduced[at:at + len(group)])
            at += len(group)
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
