"""Shared driver plumbing (port of efficientvlm_tpu/drivers/common.py): run
set-up, the model configs, the optimizer trio with gradient accumulation and
the skip of non-finite updates, checkpoint loading, the fine-tunes' train
epoch with its metric fetch and bookkeeping (resume, the epoch's record, the
log.txt line), preemption and full-state saves, the pretraining streams'
saved state, the host loaders and on-device preprocessing around a step.
Every driver's loop runs on it: retrieval, VQA, captioning, NLVR and
grounding (`main` of each drivers/<task>.py) and general distillation
(drivers/gd.main, step by step over two streams); captioning's SCST loop
(drivers/captioning.scst_train) uses its saves and preemption. Above one
process (torchrun's WORLD_SIZE) build_train_step makes each step data
parallel: every rank steps on its loader shard, the gradients and metrics
are averaged over the ranks between the backward and the update
(utils/dist.GradientSync), and the ITC gathers the world batch.

Where JAX's design does not carry over to eager PyTorch:
- the metrics of a step are read one step later, from pinned host buffers
  behind a CUDA event (`.item()` would wait for the step queued after it);
- each step draws from its own generator, seeded from (seed, epoch, batch
  index) (step_generator): a resumed epoch draws what the uninterrupted one
  drew without replaying the skipped batches' draws;
- a background save copies the state to the CPU on the caller's thread
  before the write is handed over (AdamW updates the tensors in place);
- data parallelism is one process a device (torchrun), not a mesh: there
  is no batch placement across devices, and each rank's step generator
  folds in its rank (step_generator), as JAX folds in the axis index;
- `zero1: true` keeps each rank's step and shards the optimizers' moments
  over the ranks (parallel/zero.py), so every driver takes it, GD's region
  batches and VQA's k_index included (JAX's pjit step cannot); one process
  is a no-op, as in JAX;
- `checkpoint_backend: orbax` writes the full state as a directory of
  per-rank files (train/sharded_io.py), not orbax's format; JAX's key and
  value are kept so that a shipped config means the same thing.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Config, TextConfig, VisionConfig
from ..data.device_pipeline import CROP_SCALE, preprocess_train
from ..device import resolve_device
from ..train import checkpoint as ckpt_io
from ..train.profiler import span, trace
from ..train.optim import (ApplyIfFinite, MultiSteps, create_l0_optimizer,
                           create_lagrangian_optimizer, create_optimizer)
from ..train.scheduler import create_scheduler
from ..utils.dist import (GradientSync, get_rank, get_world_size, host_all_reduce_sum,
                          init_distributed_mode)
from ..utils.logger import MetricLogger


def setup(args: Config, config: Config) -> Config:
    """The run's topology (utils/dist.init_distributed_mode: one process, or
    the rank of a torchrun launch over NCCL, gloo with --device cpu), numpy's
    global seed (+ rank), and <output_dir>/config.json with the args and the
    config."""
    checkpoint_backend(config)  # a bad value fails before the run starts
    info = init_distributed_mode(device=args.get("device"))
    np.random.seed(int(args.get("seed", 42)) + info["rank"])
    if args.get("output_dir"):
        os.makedirs(args["output_dir"], exist_ok=True)
        if get_rank() == 0:
            with open(os.path.join(args["output_dir"], "config.json"), "w") as f:
                json.dump({"args": Config.from_dict(args).to_dict(),
                           "config": Config.from_dict(config).to_dict()},
                          f, indent=2, default=str)
    return Config(info)


class StepProfiler:
    """A train/profiler.trace over a window of train steps, from the config:
    `profile_dir` (a path, or true for <output_dir>/trace),
    `profile_start_step` (default 2) and `profile_num_steps` (default 3).
    The window records the program's spans, ends synchronised with the
    device and writes a Chrome trace (trace.json). Call tick() once per
    train step."""

    def __init__(self, config: Config, output_dir: str = ""):
        d = config.get("profile_dir")
        if d is True or d == "true":
            d = os.path.join(output_dir or ".", "trace")
        self.dir = d if (d and get_rank() == 0) else None
        self.start = int(config.get("profile_start_step", 2))
        self.num = int(config.get("profile_num_steps", 3))
        self._i = 0
        self._window = None
        self._done = False

    def tick(self) -> None:
        if not self.dir or self._done:
            return
        if self._i == self.start:
            self._window = contextlib.ExitStack()
            self._window.enter_context(trace(self.dir))
        elif self._window is not None and self._i >= self.start + self.num:
            self._stop()
        self._i += 1

    def _stop(self) -> None:
        self._window.close()
        self._window, self._done = None, True
        print(f"### profiler trace written to {self.dir}")

    def close(self) -> None:
        """A window cut short by the end of an epoch writes what it caught."""
        if self._window is not None:
            self._stop()


def log_stats(stats: dict, output_dir: str, filename: str = "log.txt") -> None:
    """One JSON line a call in <output_dir>/log.txt."""
    if get_rank() != 0 or not output_dir:
        return
    with open(os.path.join(output_dir, filename), "a") as f:
        f.write(json.dumps(stats, default=str) + "\n")


def compute_dtype(config: Config):
    """bf16 unless config compute_dtype says otherwise (then f32, None)."""
    return torch.bfloat16 if config.get("compute_dtype", "bf16") == "bf16" else None


def device_of(params) -> torch.device:
    """The device of a param tree's first leaf (an evaluation runs where its
    params are)."""
    from ..train.optim import tree_leaves

    return tree_leaves(params)[0].device


def to_device(x, device, dtype=None) -> torch.Tensor:
    """A host array (numpy or a list) as a tensor on `device`, cast to
    `dtype` when given (ids to int64: the models gather with them)."""
    t = torch.from_numpy(np.asarray(x)).to(device)
    return t if dtype is None else t.to(dtype)


def model_configs(config: Config) -> Tuple[VisionConfig, TextConfig]:
    """The student's towers: config["vision"] (the vision config file's
    keys) or a default ViT at image_res, and config["text"] or BERT-base
    with text_num_hidden_layers layers over the vision width."""
    vision = config.get("vision") or VisionConfig.create(image_res=config.get("image_res", 224))
    text = config.get("text") or TextConfig.create(
        num_hidden_layers=config.get("text_num_hidden_layers", 12),
        encoder_width=vision["vision_width"])
    return VisionConfig(vision), TextConfig(text)


def teacher_configs(config: Config) -> Tuple[VisionConfig, TextConfig]:
    """The teacher: 12L ViT + 12L BERT unless the config carries
    teacher_vision / teacher_text."""
    tv = config.get("teacher_vision") or VisionConfig.create(
        image_res=config.get("image_res", 224), num_hidden_layers=12, local_attn_depth=4)
    tt = config.get("teacher_text") or TextConfig.create(num_hidden_layers=12,
                                                         encoder_width=tv["vision_width"])
    return VisionConfig(tv), TextConfig(tt)


def resolve_warmup(num_warmup_steps, accum: int):
    """The warm-up of the update-count schedule under accumulation: a float
    below 1 is a fraction of the updates and stays as it is; a step count is
    divided by the accumulation factor."""
    if isinstance(num_warmup_steps, float) and num_warmup_steps < 1:
        return num_warmup_steps
    return int(num_warmup_steps) // accum


def build_optimizers(params, config: Config, total_steps: int, *, init_param_paths=()):
    """(main, L0, Lagrangian) AdamWs from the config's optimizer, schedular
    and accelerator sections. skip_nonfinite_updates: n wraps each in
    ApplyIfFinite(n); accelerator.GRAD_ACCUMULATE_STEPS: k > 1 wraps each in
    MultiSteps(k), outermost, and the schedule runs over total_steps // k
    updates. All three go on the same cadence, so the gates and λ never step
    against a stale set of micro-updates."""
    opt_cfg = config.get("optimizer", Config())
    sched_cfg = config.get("schedular", Config())
    accum = int(config.get("accelerator", {}).get("GRAD_ACCUMULATE_STEPS", 1) or 1)
    sched = create_scheduler(lr=float(opt_cfg.get("lr", 1e-4)),
                             num_training_steps=max(total_steps // accum, 1),
                             num_warmup_steps=resolve_warmup(sched_cfg.get("num_warmup_steps", 0),
                                                             accum))
    clip = float(config.get("accelerator", {}).get("CLIP_GRAD_NORM", 1.0) or 0) or None
    reg_lr = float(opt_cfg.get("reg_learning_rate", 0.01))
    opts = [create_optimizer(params, lr=sched, weight_decay=float(opt_cfg.get("weight_decay", 0.01)),
                             lr_mult=float(opt_cfg.get("lr_mult", 1.0)),
                             init_param_paths=init_param_paths, grad_clip=clip),
            create_l0_optimizer(reg_lr=reg_lr), create_lagrangian_optimizer(reg_lr=reg_lr)]
    skip_bad = int(config.get("skip_nonfinite_updates", 0) or 0)
    if skip_bad:
        opts = [ApplyIfFinite(o, skip_bad) for o in opts]
    if accum > 1:
        opts = [MultiSteps(o, accum) for o in opts]
    return tuple(opts)


def maybe_load_params(model, args: Config, config: Config, build_fn, *, device=None, **load_kw):
    """The model's params on `device` (default cuda): from --checkpoint (or
    config["checkpoint"]) when the file exists, else build_fn(). A native
    `.ckpt` (any payload shape, a physically pruned export included) is
    taken as stored (f32 masters); any other file is read as the
    reference's state dict and remapped (xvlm_params_from_state_dict, with
    load_kw). Without a checkpoint, a Swin or DeiT model (use_swin /
    use_deit) takes its tower from config["vision"]["ckpt"] when that file
    exists (alt_vision_params_from_file)."""
    device = resolve_device(device)
    ckpt = args.get("checkpoint") or config.get("checkpoint")
    if not ckpt or not os.path.exists(ckpt):
        if ckpt:
            print(f"### checkpoint {ckpt} not found: params from their initialisation")
        params = build_fn()
        vision_ckpt = (config.get("vision") or {}).get("ckpt")
        if vision_ckpt and os.path.exists(vision_ckpt) and \
                (config.get("use_swin") or config.get("use_deit")):
            params["vision"] = ckpt_io.alt_vision_params_from_file(
                vision_ckpt, config, model.vision_cfg, device=device)
            print(f"### loaded vision tower from {vision_ckpt}")
        return params
    if ckpt.endswith(".ckpt"):
        params, _ = ckpt_io.extract_model_and_gates(ckpt_io.load_params(ckpt))
        print(f"### loaded native checkpoint from {ckpt}")
        return ckpt_io.place(params, device)
    vcfg, tcfg = model.vision_cfg, model.text_cfg
    params = ckpt_io.xvlm_params_from_state_dict(
        ckpt_io.load_torch_state_dict(ckpt), vision_layers=vcfg["num_hidden_layers"],
        text_layers=tcfg["num_hidden_layers"], fusion_layer=tcfg["fusion_layer"],
        num_patches=vcfg.num_patches, device=device, **load_kw)
    print(f"### loaded checkpoint from {ckpt}")
    return params


def is_native_checkpoint(args: Config, config: Config) -> bool:
    """True when --checkpoint names a native `.ckpt` file."""
    ckpt = args.get("checkpoint") or config.get("checkpoint")
    return bool(ckpt) and str(ckpt).endswith(".ckpt")


def native_eval_gates(l0, args: Config, config: Config, *, device=None):
    """The evaluation gates of a native checkpoint: forward_deterministic of
    its stored log-alphas (a snapshot or a full state), or None (the dense
    program) for a tree without gates (a physical export). The read shares
    maybe_load_params' memoised tree and then releases it."""
    ckpt = str(args.get("checkpoint") or config.get("checkpoint"))
    if not os.path.exists(ckpt):
        raise SystemExit(f"--checkpoint not found: {ckpt}")
    _, gates = ckpt_io.extract_model_and_gates(ckpt_io.load_params(ckpt))
    ckpt_io.clear_load_memo()
    if gates is None:
        return None
    device = resolve_device(device)
    return l0.forward_deterministic({"loga": {k: v.to(device) for k, v in gates["loga"].items()}})


def load_eval_params(model, l0, ckpt_path: str, torch_loader, device):
    """(params on `device`, evaluation gates) from one read of a checkpoint
    (the service's and infer's load, JAX's InferenceService._resolve_params
    and scripts/infer._load_params_and_gates): a native .ckpt's tree (any
    payload shape: a snapshot, a full state, a pruned or int8 export) and,
    when it stores log-alphas, forward_deterministic of them (None for a
    tree without gates); any other file through torch_loader(model, path,
    device=) (the task driver's import of a reference .th, no gates)."""
    if not os.path.exists(ckpt_path):
        raise FileNotFoundError(f"checkpoint not found: {ckpt_path}")
    if not ckpt_path.endswith(".ckpt"):
        params = torch_loader(model, ckpt_path, device=device)
        if params is None:
            raise ValueError(f"could not import torch checkpoint: {ckpt_path}")
        return params, None
    params, gates = ckpt_io.extract_model_and_gates(ckpt_io.load_params(ckpt_path))
    ckpt_io.clear_load_memo()
    zs = None
    if gates is not None:
        zs = l0.forward_deterministic({"loga": {k: v.to(device)
                                                for k, v in gates["loga"].items()}})
    return ckpt_io.place(params, device), zs


def load_student(model, args: Config, init, from_torch, *, device=None):
    """A fine-tune's student params: a native --checkpoint as stored
    (maybe_load_params), else from_torch(path) (the task's import of a
    reference .th, None when there is no file), else init()."""
    if is_native_checkpoint(args, Config()):
        return maybe_load_params(model, args, Config(), init, device=device)
    return from_torch(args.get("checkpoint")) or init()


def eval_gates(l0, l0_params: dict, args: Config, config: Config, *, device=None):
    """--evaluate's gates: a native checkpoint's stored ones
    (native_eval_gates; None for a physical export), else
    forward_deterministic of l0_params (the seeded init's)."""
    if is_native_checkpoint(args, config):
        return native_eval_gates(l0, args, config, device=device)
    return l0.forward_deterministic({"loga": l0_params["loga"]})


def frozen_teacher(params, dtype):
    """The frozen teacher's params stored in the compute dtype (the values
    its matmuls round to), or as they are (dtype None: f32)."""
    if dtype is None:
        return params
    from ..bridge import cast_floating

    return cast_floating(params, dtype)


# ---------------------------------------------------------------------------
# Preemption: SIGTERM only sets a flag; the train loop saves the full state at
# the next step boundary and exits 0, and --resume continues step-exact.

_PREEMPT = threading.Event()


def install_preemption_handler(extra_signals=()) -> threading.Event:
    """The SIGTERM flag-setter (from the launcher's main thread); the flag
    starts cleared. Returns the flag, so a caller can set or read it. A
    process forked after this (a fork-based worker pool) inherits the
    handler: there the signal takes its default action, so a pool can still
    terminate its workers."""
    owner = os.getpid()

    def _handler(signum, frame):
        if os.getpid() != owner:
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
            return
        _PREEMPT.set()
        print(f"### signal {signum}: preemption flagged, saving full state at the next step "
              "boundary")

    _PREEMPT.clear()
    for sig in (signal.SIGTERM, *extra_signals):
        try:
            signal.signal(sig, _handler)
        except (ValueError, OSError):  # not the main thread, or not supported
            pass
    return _PREEMPT


def preempted() -> bool:
    return _PREEMPT.is_set()


def preempted_sync() -> bool:
    """The flag as all processes agree on it (any rank flagged): signal
    delivery races rank to rank, so every rank calls this at the same loop
    position; one process reads its own."""
    if get_world_size() == 1:
        return preempted()
    return host_all_reduce_sum([float(preempted())])[0] > 0


def step_generator(seed: int, epoch: int, index: int, device) -> torch.Generator:
    """The generator of batch `index` of `epoch` (its L0 noise, dropout, hard
    negatives and on-device preprocessing), seeded from the three numbers
    alone and, above one process, the rank (each rank draws its own noise,
    as JAX folds the axis index into each shard's key)."""
    entropy = [int(seed), int(epoch), int(index)]
    if get_world_size() > 1:
        entropy.append(get_rank())
    s = np.random.SeedSequence(entropy).generate_state(1, np.uint64)
    return torch.Generator(device=torch.device(device)).manual_seed(int(s[0]))


class LaggedMetrics:
    """A step's metrics read one step later: the device values are copied
    into a pinned host buffer behind a CUDA event, and push() returns the
    previous step's values as floats once its event has passed, so the host
    feeds the next step while the last one runs. CPU values are read at
    once."""

    def __init__(self):
        self._pending = None

    def push(self, metrics: dict) -> Optional[dict]:
        prev = self.pop()
        host, dev = {}, []
        for k, v in metrics.items():
            if isinstance(v, torch.Tensor) and v.is_cuda:
                dev.append((k, v))
            else:
                host[k] = float(v)
        buf = event = None
        if dev:
            vals = torch.stack([v.detach().reshape(()).float() for _, v in dev])
            buf = torch.empty(len(dev), dtype=torch.float32, pin_memory=True)
            buf.copy_(vals, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        self._pending = (list(metrics), host, [k for k, _ in dev], buf, event)
        return prev

    def pop(self) -> Optional[dict]:
        if self._pending is None:
            return None
        keys, host, dev_keys, buf, event = self._pending
        self._pending = None
        if event is not None:
            event.synchronize()
            host.update(zip(dev_keys, buf.tolist()))
        return {k: host[k] for k in keys}


def run_train_epoch(loader, logger, step_fn, state, make_batch, prof, *, epoch: int, seed: int,
                    device, output_dir: str = "", backend: str = "msgpack",
                    resume_batches: int = 0, header: str = "", log_freq: int = 50,
                    sync_every: int = 10):
    """One fine-tune epoch: items -> make_batch -> step_fn(state, batch,
    generator), which updates `state` in place and returns its metrics,
    with profiler ticks and the metrics logged one step late
    (LaggedMetrics). Batch i draws from step_generator(seed, epoch, i).
    Spans: evlm.loop.wait (the loader's next, in log_every), .batch
    (make_batch), .step (step_fn) and .after (the tick, the metrics, the
    preemption check).

    On preemption the full state is saved with {"epoch": epoch - 1,
    "batches_done": n} and the process exits 0; --resume replays this epoch
    from the loader, skipping the first n batches' steps (the loader still
    builds them, so a host transform's draws stay in step), and then draws
    exactly what the uninterrupted epoch drew. Host augmentation replays
    exactly with a loader of one worker or with device_preprocess; a worker
    pool's threads share the transform's generator in the order they run.
    Above one process the ranks agree on the flag (preempted_sync) every
    sync_every batches and at the epoch's end, as JAX's loop does. Returns
    the state."""
    ckpt_io.clear_load_memo()  # the params live on the device now
    world = get_world_size()
    lagged = LaggedMetrics()

    def _save_and_exit(batches_done: int) -> None:
        last = lagged.pop()
        if last:
            logger.update(**last)
        if output_dir:
            save_full_state(output_dir, state, {"epoch": epoch - 1, "batches_done": batches_done,
                                                "preempted": True}, backend=backend)
            wait_for_saves()
            log_stats({"preempted": True, "epoch": epoch, "batches_done": batches_done},
                      output_dir)
        print(f"### preempted at epoch {epoch} batch {batches_done}: full state saved, exiting")
        raise SystemExit(0)

    done = 0
    for i, items in enumerate(logger.log_every(loader, log_freq, header)):
        done = i + 1
        if i < resume_batches:
            continue
        with span("evlm.loop.batch"):
            batch = make_batch(items)
        with span("evlm.loop.step"):
            metrics = step_fn(state, batch, step_generator(seed, epoch, i, device))
        with span("evlm.loop.after"):
            prof.tick()
            prev = lagged.push(metrics)
            if prev:
                logger.update(**prev)
            if preempted() if world == 1 else (done % sync_every == 0 and preempted_sync()):
                _save_and_exit(done)
    if world > 1 and preempted_sync():  # an epoch shorter than sync_every
        _save_and_exit(done)
    last = lagged.pop()
    if last:
        logger.update(**last)
    return state


def resume_epochs(args: Config, state):
    """(state, start_epoch, resume_batches): with --resume and a saved full
    state in the output directory, the state restored and the epoch and
    batch it stopped at; else the state as given, 0, 0."""
    out_dir = args.get("output_dir", "")
    restored = restore_full_state(out_dir, state) if args.get("resume") and out_dir else None
    if restored is None:
        return state, 0, 0
    state, extra = restored
    start_epoch = int(extra.get("epoch", -1)) + 1
    resume_batches = int(extra.get("batches_done", 0))
    print(f"### resumed from epoch {start_epoch} (full state incl. optimizers)"
          + (f" at batch {resume_batches}" if resume_batches else ""))
    return state, start_epoch, resume_batches


def train_epoch(loader, step_fn, state, make_batch, prof, *, epoch: int, seed: int, device,
                output_dir: str = "", backend: str = "msgpack", resume_batches: int = 0,
                batch_size: int = 0):
    """One epoch of a fine-tune's loop: the loader's epoch set,
    run_train_epoch under a fresh MetricLogger, the profiler's window
    closed. Returns (state, logger, record), record {"epoch", "steps" (run
    in this process), "batch", "train_s" (the loop's seconds), "wait_s"
    (of them, waiting for batches)}."""
    loader.set_epoch(epoch)
    logger = MetricLogger()
    t0 = time.perf_counter()
    state = run_train_epoch(loader, logger, step_fn, state, make_batch, prof, epoch=epoch,
                            seed=seed, device=device, output_dir=output_dir, backend=backend,
                            resume_batches=resume_batches, header=f"Train Epoch: [{epoch}]")
    train_s = time.perf_counter() - t0
    prof.close()
    logger.synchronize_between_processes()
    return state, logger, {"epoch": epoch, "steps": logger.iterations - resume_batches,
                           "batch": batch_size, "train_s": train_s,
                           "wait_s": logger.wait_seconds}


def train_stats(logger: MetricLogger) -> dict:
    """The log.txt keys of the train meters: train_<name>, the global
    average to 5 decimals (a string, as JAX writes it)."""
    return {f"train_{k}": f"{m.global_avg:.5f}" for k, m in logger.meters.items()}


def save_training_state(output_dir: str, tag, payload: dict) -> None:
    """A snapshot, model_state_{tag}.ckpt; training_state_latest (the full
    resumable state) is save_full_state's alone."""
    if get_rank() != 0 or not output_dir:
        return
    ckpt_io.Checkpointer(output_dir).save_checkpoint(tag, payload)


def build_train_step(step, config: Config):
    """The driver's step (efficientvlm_tpu/drivers/common.py:412-499): in one
    process the step itself; above one process the same step made data
    parallel, a utils/dist.GradientSync on the step inside any
    DevicePreprocess (rank 0's state broadcast at its first call, the
    gradients and metrics averaged before each update, the ITC over the
    world batch); with zero1 its optimizers wrapped in ZeRO-1 and a
    Zero1Sync in its place (parallel/zero.make_zero1: the moments cut to
    this rank's slices at the first call, the gradients reduce-scattered)."""
    if get_world_size() > 1:
        inner = step.step if isinstance(step, DevicePreprocess) else step
        if config.get("zero1"):
            from ..parallel.zero import make_zero1

            make_zero1(inner)
        else:
            inner.data_parallel = GradientSync()
    return step


def maybe_parallel_loader(loader, config: Config, *, num_workers: Optional[int] = None):
    """A train loader wrapped in a pool of num_workers (config num_workers,
    default 4) when there is more than one and the host has more than 2
    cores: threads (ParallelMapLoader, the default) or, with loader_backend:
    process, spawned processes (ProcessMapLoader). Pool threads share the
    transform's generator, so the draws follow thread scheduling: for an
    exact replay (a resume) use num_workers <= 1 or device_preprocess."""
    n = int(config.get("num_workers", 4) if num_workers is None else num_workers)
    if n > 1 and (os.cpu_count() or 1) > 2 and hasattr(loader, "batch_size"):
        if config.get("loader_backend", "thread") == "process":
            from ..data.prefetch import ProcessMapLoader

            return ProcessMapLoader(loader, num_workers=n, seed=int(config.get("seed", 42)))
        from ..data.prefetch import ParallelMapLoader

        return ParallelMapLoader(loader, num_workers=n)
    return loader


def eval_transform(config: Config, image_res: int):
    """The evaluation transform: PIL bicubic, or with native_eval_decode the
    libjpeg DCT-scaled decode."""
    from ..data.transforms import ImageTransform

    return ImageTransform.test(image_res, native_decode=bool(config.get("native_eval_decode")))


def preprocess_transform(config: Config, *, default=None):
    """With device_preprocess, the uint8 host transform (decode and resize;
    the augmentation runs on the device, wrap_step_with_preprocess); else
    `default`."""
    if not config.get("device_preprocess"):
        return default
    from ..data.transforms import ImageTransform

    return ImageTransform.uint8(config.get("image_res", 224))


def wrap_step_with_preprocess(step, config: Config, *, image_keys=("image",),
                              hflip: bool = True, randaug: bool = True):
    """With device_preprocess, the step behind DevicePreprocess at
    image_res; else the step."""
    if not config.get("device_preprocess"):
        return step
    return DevicePreprocess(step, int(config.get("image_res", 224)), hflip=hflip,
                            randaug=randaug, image_keys=image_keys)


# ---------------------------------------------------------------------------
# Full training state: params, gates, λ and every optimizer's state, with
# the driver's {"epoch", "batches_done"}, in <output_dir>/training_state_latest.ckpt.

_SAVE_EXECUTOR = None
_PENDING_SAVE = None
_PENDING_COMMIT = None
CHECKPOINT_BACKENDS = ("msgpack", "orbax")
SHARDED_DIR = "training_state_latest.shards"


def checkpoint_backend(config: Config) -> str:
    """The full state's backend a config names: "msgpack" (one file from
    rank 0, the default) or "orbax" (a directory of per-rank files,
    train/sharded_io.py)."""
    backend = str(config.get("checkpoint_backend", "msgpack"))
    if backend not in CHECKPOINT_BACKENDS:
        raise ValueError(f"checkpoint_backend: {backend}: msgpack (one file from rank 0) or "
                         "orbax (a directory of per-rank files)")
    return backend


def wait_for_saves() -> None:
    """Block until a background save has landed, then commit it (the
    sharded backend's rename synchronises the ranks: every rank calls this
    at the same point; save_full_state and restore_full_state call it
    first)."""
    global _PENDING_SAVE, _PENDING_COMMIT
    pending, commit, _PENDING_SAVE, _PENDING_COMMIT = _PENDING_SAVE, _PENDING_COMMIT, None, None
    if pending is not None:
        pending.result()
    if commit is not None:
        commit()


def save_full_state(output_dir: str, state, extra: dict, *, backend: str = "msgpack",
                    background: bool = False) -> None:
    """The complete training state and `extra`, as the reference saves {model,
    optimizer, lr_scheduler, epoch}. The state is copied to the CPU on the
    caller's thread (synchronised with the device) before anything is
    written; background=True hands only the write to a worker thread. At
    most one save is in flight: a new one waits for the last. Every rank
    calls it: the sharded backend (checkpoint_backend: orbax) writes each
    rank's own slices; the default gathers ZeRO-1 moments (a collective)
    and writes one file from rank 0."""
    if not output_dir:
        return
    wait_for_saves()
    commit = None
    if backend == "orbax":
        from ..train import sharded_io

        write, commit = sharded_io.prepare_save(os.path.join(output_dir, SHARDED_DIR), state,
                                                extra)
    else:
        from ..parallel import zero

        if zero.is_sharded(state):
            state = zero.gather_moments(state)
        if get_rank() != 0:
            return
        path = os.path.join(output_dir, "training_state_latest.ckpt")
        payload = {"state": ckpt_io.to_cpu(state), "extra": dict(extra)}

        def write():
            ckpt_io.save_pytree(path, payload)

    if not background:
        write()
        if commit is not None:
            commit()
        return
    global _SAVE_EXECUTOR, _PENDING_SAVE, _PENDING_COMMIT
    if _SAVE_EXECUTOR is None:
        from concurrent.futures import ThreadPoolExecutor

        _SAVE_EXECUTOR = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-save")
    _PENDING_SAVE, _PENDING_COMMIT = _SAVE_EXECUTOR.submit(write), commit


def restore_full_state(output_dir: str, template_state):
    """(state, extra) of save_full_state, rebuilt in `template_state`'s
    structure on its devices (a ZeRO-1 template gets its own slices), or
    None when there is no saved state. Both backends are probed, and when
    both left a state the newer one wins (JAX's rule). A JAX run's full
    state (flax msgpack) holds optax's moments, which the port does not
    resume: that raises."""
    wait_for_saves()
    shards = os.path.join(output_dir, SHARDED_DIR)
    path = os.path.join(output_dir, "training_state_latest.ckpt")
    have_dir, have_file = os.path.isdir(shards), os.path.exists(path)
    if have_dir and (not have_file or os.path.getmtime(shards) >= os.path.getmtime(path)):
        from ..train import sharded_io

        return sharded_io.restore_state_dir(shards, template_state)
    if not have_file:
        return None
    if ckpt_io.is_msgpack(path):
        raise ValueError(f"{path} is a JAX run's full state (flax msgpack): its optax moments do "
                         "not resume in the port; start from its params with --checkpoint")
    from ..parallel import zero

    payload = ckpt_io.load_pytree(path)
    saved = payload["state"]
    if zero.is_sharded(template_state):
        saved = zero.shard_saved(template_state, saved)
    return ckpt_io.restore_pytree_like(template_state, saved), payload.get("extra", {})


# ---------------------------------------------------------------------------
# A pretraining stream's saved state: the JSONL cursor and the host generators.


def _transform_draws(transform) -> bool:
    """Whether the host transform draws from its generator (a crop, flip or
    RandAugment; not the evaluation's or the uint8 resize)."""
    return transform is not None and transform.mode not in ("test", "uint8")


def stream_state(dataset) -> dict:
    """Where a pretraining stream (PretrainImageTextDataset or
    RegionTextDataset) stands: its JSONL cursor under JAX's keys ("epoch",
    "file", "line") and the states (bit_generator.state: ints and strings,
    which torch.load(weights_only=True) reads) of the host generators its
    batches draw from: the dataset's own (captions, region crops, text
    choice), the masking's and, when the host augments, the transform's.
    JAX's GD saves the cursor alone, so its resumed stream draws what step 0
    drew (ROADMAP C)."""
    cursor = dataset.stream.state_dict()
    state = {"epoch": int(cursor["epoch"]), "file": int(cursor["cursor"][0]),
             "line": int(cursor["cursor"][1]), "rng": dataset.rng.bit_generator.state,
             "mask_rng": dataset.mask_generator.rng.bit_generator.state}
    if _transform_draws(dataset.transform):
        state["transform_rng"] = dataset.transform.rng.bit_generator.state
    return state


def load_stream_state(dataset, state: dict) -> None:
    """stream_state's dict back into a freshly built stream: the cursor and
    each generator's state (in place: the transform's RandAugment shares its
    generator)."""
    dataset.stream.load_state_dict({"epoch": int(state["epoch"]),
                                    "cursor": [int(state["file"]), int(state["line"])]})
    dataset.rng.bit_generator.state = state["rng"]
    dataset.mask_generator.rng.bit_generator.state = state["mask_rng"]
    if "transform_rng" in state:
        dataset.transform.rng.bit_generator.state = state["transform_rng"]


class DevicePreprocess:
    """A step whose batch images (the image_keys entries, default "image")
    come as uint8 [B,H,W,3]: the generator draws the crop, flip and
    RandAugment of preprocess_train for each key in turn first (the crop's
    area fraction in `scale`; flip and RandAugment applied as hflip /
    randaug say), then the step runs on the normalised f32 images; keyword
    arguments go through to the step."""

    def __init__(self, step, image_res: int, *, hflip: bool = True, randaug: bool = True,
                 image_keys: Tuple[str, ...] = ("image",), scale=CROP_SCALE):
        self.step, self.image_res, self.scale = step, image_res, tuple(scale)
        self.hflip, self.randaug, self.image_keys = hflip, randaug, tuple(image_keys)

    def preprocess(self, batch: dict, generator: Optional[torch.Generator] = None) -> dict:
        return dict(batch, **{k: preprocess_train(batch[k], self.image_res, generator=generator,
                                                  hflip=self.hflip, randaug=self.randaug,
                                                  scale=self.scale)
                              for k in self.image_keys})

    def __call__(self, state, batch: dict, generator: Optional[torch.Generator] = None, **kw):
        return self.step(state, self.preprocess(batch, generator), generator, **kw)
