"""General distillation (stage 1) and plain pretraining (port of
efficientvlm_tpu/drivers/gd.py): the models, the steps and the loop. The
teacher (12L/12L) distils into the student (6L/6L); a task whose name
starts with "pretrain" runs the same loop without a teacher. With
`device_preprocess` the host ships uint8 images and the general step crops
(an area fraction in (0.2, 1.0), as the reference's pretraining transform;
JAX's GD step keeps the fine-tunes' (0.5, 1.0)), flips, augments and
normalises them on the device first (data/device_pipeline.preprocess_train).

main steps over the general and region streams interleaved as JAX
interleaves them (step i is a region step when default_rng((seed,
i)).random() < iter_perc), with the lag-1 metric fetch, preemption at step
granularity, a snapshot and a background full-state save every
ckpt_frequent_step steps and at the end. Step i draws on the device from
common.step_generator(seed, 0, i). The loop body is `train_steps`, over any
iterators of device batches, so a caller with its streams in memory runs
main's loop itself. Either vision tower of the pretraining configs serves
both streams: CLIP-ViT, or X-VLM-base's Swin-B with `use_swin` (region rows
pooled by the region masks, models/swin.py). Where it differs from JAX:

- each process feeds one device (no n_dev multiple of the batch); above
  one process the ranks agree on a preemption every 50 steps, as JAX's do;
- the saved state holds each stream's host generators beside its cursor
  (common.stream_state), so a resumed run's batches are the uninterrupted
  run's: JAX's restores the cursor alone and redraws from the seed (ROADMAP
  C);
- with compute_dtype bf16 the frozen teacher is stored in bf16.

The fine-tunes' loops are drivers/{retrieval,vqa,captioning,nlvr,
grounding}.main, on drivers/common.py's shared epoch; SCST is
drivers/captioning.scst_train.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import Config
from ..data.datasets import PretrainImageTextDataset, RegionTextDataset
from ..data.device_pipeline import PRETRAIN_CROP_SCALE
from ..data.tokenizer import build_tokenizer
from ..device import resolve_device
from ..models.model_pretrain import XVLMForPretrain
from ..train import checkpoint as ckpt_io
from ..train.profiler import span
from ..train.steps import init_pretrain_state, make_gd_train_step, make_pretrain_train_step
from ..utils.dist import get_rank
from ..utils.logger import MetricLogger
from . import common
from .common import DevicePreprocess


def build_models(config: Config):
    """(student, teacher) XVLMForPretrain; both are initialised with the
    bbox head (`init(seed, with_bbox_head=True)`)."""
    vcfg, tcfg = common.model_configs(config)
    tv, tt = common.teacher_configs(config)
    return XVLMForPretrain(vcfg, tcfg, config), XVLMForPretrain(tv, tt, config)


def total_steps(config: Config) -> int:
    """The schedule's length on one device: epochs x train_dataset_size //
    batch."""
    batch = config.get("images", {}).get("batch_size", 128)
    epochs = int(config.get("schedular", {}).get("epochs", 41))
    return epochs * (config.get("train_dataset_size", 10000) // max(batch, 1))


def build_step(config: Config, student, optimizer, *, teacher=None, teacher_params=None,
               with_bbox: bool = False, temperature: float = 1.0, dtype=None,
               impl: str = "fused"):
    """The general (with_bbox False) or region step: GD with a teacher, the
    plain pretrain step without one. The general step takes uint8 images
    when config["device_preprocess"] is set, and crops them at pretraining's
    scale."""
    if teacher is not None:
        step = make_gd_train_step(student, teacher, optimizer, teacher_params=teacher_params,
                                  temperature=temperature, with_bbox=with_bbox, dtype=dtype,
                                  impl=impl)
    else:
        step = make_pretrain_train_step(student, optimizer, with_bbox=with_bbox, dtype=dtype,
                                        impl=impl)
    if config.get("device_preprocess") and not with_bbox:
        return DevicePreprocess(step, int(config.get("image_res", 224)),
                                scale=PRETRAIN_CROP_SCALE)
    return step


def is_region_step(seed: int, step: int, iter_perc: float) -> bool:
    """JAX's interleave (efficientvlm_tpu/drivers/gd.py:186-189): step i is
    a region step when default_rng((seed, i)).random() < iter_perc."""
    return bool(np.random.default_rng((seed, step)).random() < iter_perc)


def build_streams(config: Config, tokenizer, seed: int, info=None):
    """(general, region or None, iter_perc): the image-text stream (uint8
    images under device_preprocess, else the pretraining transform) and, when
    config names train_file_regions, the region stream, both repeating."""
    info = info or {"rank": 0, "world_size": 1}
    transform = common.preprocess_transform(config)
    general = PretrainImageTextDataset(config, config["train_file"], tokenizer,
                                       rank=info["rank"], world_size=info["world_size"],
                                       repeat=True, seed=seed, transform=transform)
    if not config.get("train_file_regions"):
        return general, None, 0.0
    region = RegionTextDataset(config, config["train_file_regions"], tokenizer,
                               rank=info["rank"], world_size=info["world_size"], repeat=True,
                               seed=seed)
    return general, region, float(config.get("regions", {}).get("iter_perc", 0.5))


INDEX_KEYS = ("text_ids", "text_ids_masked", "masked_pos", "masked_ids", "idx_to_group_img")


def to_device(batch: dict, device) -> dict:
    """A stream's numpy batch on `device`; ids, positions and the image
    index as int64 (the steps gather with them)."""
    return {k: common.to_device(v, device, torch.int64 if k in INDEX_KEYS else None)
            for k, v in batch.items()}


def train_steps(steps, state, general, region, general_step, region_step, *, seed: int,
                iter_perc: float, device, logger: MetricLogger, prof, world_size: int = 1,
                save=None, ckpt_freq: int = 0, log_freq: int = 50, total=None) -> dict:
    """main's loop body over given streams: for each step index of `steps`
    (an iterable of ints), the region step on the next batch of `region`
    when is_region_step(seed, step, iter_perc) (and `region` is given),
    else the general step on the next of `general` (iterators of batches on
    the device), each with common.step_generator(seed, 0, step, device);
    the metrics read one step late; preemption at step granularity (above
    one process agreed every 50 steps) calls save(done, preempted=True) and
    exits 0; every ckpt_freq steps save(done, preempted=False). Spans:
    evlm.loop.wait (the next step index, in log_every), .batch (the next
    batch), .step and .after, as drivers/common.run_train_epoch's. Returns
    {"region_steps" (the region steps' indices), "wait_s" (seconds spent
    drawing batches)}."""
    lagged = common.LaggedMetrics()
    region_steps, wait_s = [], 0.0
    for step in logger.log_every(steps, log_freq, "GD Train:", total=total):
        with span("evlm.loop.batch"):
            t0 = time.perf_counter()
            use_region = region is not None and is_region_step(seed, step, iter_perc)
            if use_region:
                region_steps.append(step)
            batch = next(region if use_region else general)
            wait_s += time.perf_counter() - t0
        with span("evlm.loop.step"):
            metrics = (region_step if use_region else general_step)(
                state, batch, common.step_generator(seed, 0, step, device))
        del batch
        with span("evlm.loop.after"):
            prof.tick()
            prev = lagged.push(metrics)
            if prev:
                logger.update(**prev)
            if common.preempted() if world_size == 1 else (
                    (step + 1) % 50 == 0 and common.preempted_sync()):
                last = lagged.pop()
                if last:
                    logger.update(**last)
                if save is not None:
                    save(step + 1, preempted=True)
                print(f"### preempted at step {step + 1}: full state saved, exiting")
                raise SystemExit(0)
            if save is not None and ckpt_freq and (step + 1) % ckpt_freq == 0:
                save(step + 1, preempted=False)
    last = lagged.pop()
    if last:
        logger.update(**last)
    return {"region_steps": region_steps, "wait_s": wait_s}


def main(args: Config, config: Config) -> dict:
    """General distillation, or plain pretraining for a "pretrain*" task:
    --student_chkpt (ahead of --checkpoint) and --teacher_chkpt through
    maybe_load_params, the two streams, the AdamW of build_optimizers over
    total_steps (or --max_steps), --resume of the full state with both
    streams' cursors and generators, and the step loop. Returns {"state",
    "region_steps" (the indices of the region steps run in this process),
    "steps", "train_s" (the loop's seconds), "wait_s" (of them, building
    batches on the host)}."""
    info = common.setup(args, config)
    backend = common.checkpoint_backend(config)
    device = resolve_device(args.get("device"))
    out_dir = args.get("output_dir", "")
    seed = int(args.get("seed", 42))
    tokenizer = build_tokenizer(config.get("text_encoder", ""))

    # pretrain_* tasks run the same loop without a teacher (the reference's Pretrain.py)
    distill = not str(args.get("task", "gd_4m_small")).startswith("pretrain")
    vcfg, tcfg = common.model_configs(config)
    student = XVLMForPretrain(vcfg, tcfg, config)
    teacher = XVLMForPretrain(*common.teacher_configs(config), config) if distill else None
    student_args = args
    if args.get("student_chkpt"):
        student_args = Config({**args.to_dict(), "checkpoint": args["student_chkpt"]})
    sparams = common.maybe_load_params(
        student, student_args, config, lambda: student.init(0, device=device, with_bbox_head=True),
        device=device, with_bbox_head=True)
    dtype = common.compute_dtype(config)
    tparams = common.frozen_teacher(common.maybe_load_params(
        teacher, Config({"checkpoint": args.get("teacher_chkpt")}), Config(),
        lambda: teacher.init(1, device=device, with_bbox_head=True), device=device,
        with_bbox_head=True), dtype) if distill else None

    general_ds, region_ds, iter_perc = build_streams(config, tokenizer, seed, info)
    steps_total = total_steps(config)
    optimizer = common.build_optimizers(sparams, config, steps_total)[0]
    state = init_pretrain_state(sparams, optimizer)
    start_step = 0
    if args.get("resume") and out_dir:
        restored = common.restore_full_state(out_dir, state)
        if restored is not None:
            state, extra = restored
            start_step = int(extra.get("step", 0))
            if "general_stream" in extra:
                common.load_stream_state(general_ds, extra["general_stream"])
            if region_ds is not None and "region_stream" in extra:
                common.load_stream_state(region_ds, extra["region_stream"])
            print(f"### resumed from step {start_step} (full state incl. optimizer, the "
                  "streams' cursors and generators)")

    temperature = float(args.get("temperature", 1.0))
    kw = dict(teacher=teacher, teacher_params=tparams, temperature=temperature, dtype=dtype,
              impl=config.get("attn_impl", "fused"))
    general_step = common.build_train_step(build_step(config, student, optimizer, **kw), config)
    region_step = (common.build_train_step(
        build_step(config, student, optimizer, with_bbox=True, **kw), config)
        if region_ds is not None else None)
    ckpt_freq = int(config.get("ckpt_frequent_step", 10000))
    max_steps = int(args.get("max_steps") or steps_total)

    def stream_extra() -> dict:
        extra = {"general_stream": common.stream_state(general_ds)}
        if region_ds is not None:
            extra["region_stream"] = common.stream_state(region_ds)
        return extra

    def save(done: int, preempted: bool) -> None:
        if not out_dir:
            return
        if preempted:
            common.save_full_state(out_dir, state, {"step": done, **stream_extra()},
                                   backend=backend)
            common.wait_for_saves()
            common.log_stats({"preempted": True, "step": done}, out_dir)
            return
        if get_rank() == 0:
            ckpt_io.Checkpointer(out_dir, keep_last=config.get("ckpt_keep_last")
                                 ).save_checkpoint(done, {"model": state.params, "step": done})
        # the full state is copied here; its write overlaps the next steps
        common.save_full_state(out_dir, state, {"step": done, **stream_extra()},
                               backend=backend, background=True)
        common.log_stats({"step": done, **common.train_stats(logger)}, out_dir)

    logger = MetricLogger()
    prof = common.StepProfiler(config, out_dir)
    general_iter = (to_device(b, device) for b in general_ds.batches())
    region_iter = (None if region_ds is None else (to_device(b, device) for b in region_ds.batches(
        config.get("regions", {}).get("max_images", 48))))
    ckpt_io.clear_load_memo()  # the params live on the device now
    t_loop = time.perf_counter()
    loop = train_steps(range(start_step, max_steps), state, general_iter, region_iter,
                       general_step, region_step, seed=seed, iter_perc=iter_perc,
                       device=device, logger=logger, prof=prof, world_size=info["world_size"],
                       save=save, ckpt_freq=ckpt_freq, total=max_steps - start_step)
    prof.close()
    train_s = time.perf_counter() - t_loop
    if out_dir:
        if get_rank() == 0:
            ckpt_io.Checkpointer(out_dir).save_checkpoint(
                "final", {"model": state.params, "step": max_steps})
        common.save_full_state(out_dir, state, {"step": max_steps, **stream_extra()},
                               backend=backend)
    return {"state": state, "region_steps": loop["region_steps"],
            "steps": max_steps - start_step, "train_s": train_s, "wait_s": loop["wait_s"]}
