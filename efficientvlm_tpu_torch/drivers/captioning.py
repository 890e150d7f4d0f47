"""The captioning pruning fine-tune (stage 2, the reference's
Eff_Captioning.py): the models, the gates, the step, checkpoint import, the
beam-search evaluation and the loop of efficientvlm_tpu/drivers/
captioning.py. The 12L/12L teacher
distils into the 6L/6L student; the decoder is the whole fusion text stack
(layers [0, fusion) text-only, the rest cross-attending into the image), so
the gates are XVLML0Module's over that stack. loss = 0.7 x the caption LM
loss (prompt and PAD masked, label smoothing) + 0.3 x captioning_kd_losses
+ the Lagrangian. With `device_preprocess` the step crops, flips, augments
and normalises uint8 images on the device first.

Batches: {"image", "caption_ids", "caption_atts"}; config["prompt_length"]
is the prompt's token count without [SEP], which main takes from the
tokenizer. main runs on the device args["device"] names (default cuda),
with JAX's loop but for these: --checkpoint may also name a
native .ckpt; --evaluate builds no teacher; with compute_dtype bf16 the
frozen teacher is stored in bf16.

--scst runs scst_train (self-critical sequence training after the pruning
fine-tune, efficientvlm_tpu/drivers/captioning.py:241-351): K sampled
captions and one greedy caption a image on the device, the CIDEr-D
advantages on the host, one advantage-weighted log-prob update a batch, the
gates frozen deterministic when the config prunes. Batch i of epoch e
samples with common.step_generator(seed, e, i) and the resume replays the
interrupted epoch, as JAX's does; the port also saves the dataset's and the
host transform's generator states at the epoch's start, so a replayed epoch
draws what the interrupted one drew (JAX's replay of an epoch after the
first starts from the seeded states).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..data.datasets import (
    CaptioningEvalDataset, CaptioningSCSTDataset, CaptioningTrainDataset, SimpleLoader,
    scst_collate,
)
from ..data.tokenizer import build_tokenizer
from ..data.transforms import ImageTransform
from ..data.utils import collect_result
from ..device import resolve_device
from ..evaluation.caption_metrics import coco_caption_eval
from ..models.model_generation import XVLMForCaptioning
from ..pruning.l0_module import L0Module, XVLML0Module
from ..train import checkpoint as ckpt_io
from ..train.optim import create_optimizer
from ..train.scheduler import create_scheduler
from ..train.scst import ScstRewardCriterion, make_scst_step
from ..train.steps import (
    TaskTrainStep, captioning_kd_losses, init_pretrain_state, init_train_state,
    make_task_train_step, subset_teacher_taps,
)
from ..utils.logger import MetricLogger
from . import common
from .common import DevicePreprocess

TASK_WEIGHT, KD_WEIGHT = 0.7, 0.3


def build_models(config: Config):
    """(student, teacher) XVLMForCaptioning, with the config's
    label_smoothing and prompt_length."""
    vcfg, tcfg = common.model_configs(config)
    tv, tt = common.teacher_configs(config)
    return XVLMForCaptioning(vcfg, tcfg, config), XVLMForCaptioning(tv, tt, config)


def load_torch_params(model: XVLMForCaptioning, ckpt_path, load_capt_pretrain: bool = False, *,
                      device=None) -> Optional[dict]:
    """A reference-keyed torch checkpoint for `model` on `device` (default
    cuda), or None when the path is absent (efficientvlm_tpu/drivers/
    captioning.py:37-55): the decoder from text_encoder.*, or with
    load_capt_pretrain a captioning domain pretrain's text_decoder.*."""
    if not (ckpt_path and os.path.exists(ckpt_path)):
        return None
    device = resolve_device(device)
    return ckpt_io.captioning_params_from_state_dict(
        ckpt_io.load_torch_state_dict(ckpt_path),
        vision_layers=model.vision_cfg["num_hidden_layers"],
        text_layers=model.text_cfg["num_hidden_layers"],
        fusion_layer=model.text_cfg["fusion_layer"], num_patches=model.vision_cfg.num_patches,
        load_capt_pretrain=load_capt_pretrain, device=device)


def build_l0(config: Config) -> L0Module:
    """XVLML0Module over the student's vision tower and its decoder's
    text / cross layout, head gates per head_gate_group heads."""
    vcfg, tcfg = common.model_configs(config)
    return XVLML0Module(
        vision_layers=vcfg["num_hidden_layers"], text_layers=tcfg["fusion_layer"],
        cross_layers=tcfg["num_hidden_layers"] - tcfg["fusion_layer"],
        hidden_size=tcfg["hidden_size"], intermediate_size=tcfg["intermediate_size"],
        num_heads=tcfg["num_attention_heads"],
        target_sparsity=float(config.get("sparsity", 0.0)),
        head_group=int(config.get("head_gate_group", 1)))


def build_optimizers(params, config: Config, total_steps: int):
    """common.build_optimizers."""
    return common.build_optimizers(params, config, total_steps)


def build_step(config: Config, student: XVLMForCaptioning, teacher: XVLMForCaptioning,
               l0: L0Module, optimizers, *, teacher_params, frozen_zs: Optional[dict] = None,
               temperature: float = 1.0, dtype=None, impl: str = "fused"):
    """The step (a TaskTrainStep, in DevicePreprocess when
    config["device_preprocess"] is set): the student in train mode with its
    KD taps, the teacher in eval mode with its maps, its taps cut to the
    student's depths right after its forward; frozen_zs is stop_prune."""
    tcfg = student.text_cfg
    fusion, depth = tcfg["fusion_layer"], tcfg["num_hidden_layers"]
    taps = dict(pad_token_id=config.get("pad_token_id", 0),
                prompt_length=config.get("prompt_length", student.prompt_length),
                output_attentions=True, output_hidden_states=True, dtype=dtype, impl=impl)

    def student_forward(params, zs, batch, generator):
        return student.forward(params, batch["image"], batch["caption_ids"],
                               batch["caption_atts"], zs=zs, generator=generator, train=True,
                               **taps)

    def teacher_forward(params, batch):
        out = teacher.forward(params, batch["image"], batch["caption_ids"],
                              batch["caption_atts"], train=False, **taps)
        return subset_teacher_taps(
            out, vision_layers=student.vision_cfg["num_hidden_layers"], text_fusion=fusion,
            cross_layers=depth - fusion,
            by_key={"decoder_hidden_states": depth, "decoder_attentions": depth})

    step: TaskTrainStep = make_task_train_step(
        student_forward, teacher_forward,
        lambda s, t: captioning_kd_losses(s, t, temperature=temperature), l0, optimizers,
        teacher_params=teacher_params, task_weight=TASK_WEIGHT, kd_weight=KD_WEIGHT,
        frozen_zs=frozen_zs)
    if config.get("device_preprocess"):
        return DevicePreprocess(step, int(config.get("image_res", 384)))
    return step


def strip_prompt(caption: str, prompt: str) -> str:
    """The decoded caption without the prompt it starts with."""
    p = prompt.strip()
    return caption[len(p):].strip() if caption.startswith(p) else caption


@torch.no_grad()
def evaluation(model: XVLMForCaptioning, params, loader, tokenizer, config: Config, *, zs=None,
               dtype=None) -> list:
    """Beam search from the prompt (efficientvlm_tpu/drivers/
    captioning.py:72-96, the reference's Eff_Captioning.py:184-208): the
    prompt's ids without [SEP], num_beams, max_length and min_length of the
    config, the prompt stripped from each decoded caption, on the params'
    device. Returns [{"image_id", "caption"}]."""
    prompt = config.get("prompt", "a picture of ")
    prompt_ids = np.asarray(tokenizer([prompt])["input_ids"], np.int64)[:, :-1]  # drop [SEP]
    device = common.device_of(params)
    dtype = dtype or common.compute_dtype(config)
    results = []
    for images, image_ids in loader:
        tokens = model.generate(
            params, common.to_device(images, device),
            common.to_device(np.repeat(prompt_ids, len(image_ids), axis=0), device),
            max_length=int(config.get("max_length", 20)),
            min_length=int(config.get("min_length", 5)), num_beams=int(config.get("num_beams", 3)),
            eos_id=tokenizer.sep_token_id, pad_id=tokenizer.pad_token_id, zs=zs, dtype=dtype,
            impl=config.get("attn_impl", "fused"))
        for img_id, toks in zip(image_ids, tokens.cpu().numpy()):
            results.append({"image_id": int(img_id), "caption": strip_prompt(
                tokenizer.decode(toks, skip_special_tokens=True), prompt)})
    return results


def make_batch(items, tokenizer, config: Config, device) -> dict:
    """A loader batch (images, prompt + caption, image index) as the step's
    batch on `device`, the captions at padding "max_length" (max_tokens)."""
    images, captions, _ = items
    tok = tokenizer(list(captions), padding="max_length", truncation=True,
                    max_length=config.get("max_tokens", 30))
    return {"image": common.to_device(images, device),
            "caption_ids": common.to_device(tok["input_ids"], device, torch.int64),
            "caption_atts": common.to_device(tok["attention_mask"], device)}


def main(args: Config, config: Config) -> dict:
    """The fine-tune (efficientvlm_tpu/drivers/captioning.py:98-238):
    config["prompt_length"] from the tokenizer, the student (a native
    --checkpoint as stored, else a .th through load_torch_params with
    --load_capt_pretrain, else the seeded init) and the teacher
    (--teacher_chkpt), the gates, --evaluate (the validation split with a
    native checkpoint's stored gates or the init gates' deterministic ones,
    merged by collect_result into caption_result, one caption an image),
    --resume, and per epoch the loop, the evaluation, coco_caption_eval
    against val_gt_file when the config names one, log.txt, the epoch's
    snapshot and the full state. Returns {"state", "epochs"} (each epoch's
    steps, seconds and metrics); with --evaluate {"results"}."""
    info = common.setup(args, config)
    backend = common.checkpoint_backend(config)
    device = resolve_device(args.get("device"))
    out_dir = args.get("output_dir") or "output"
    seed = int(args.get("seed", 42))
    tokenizer = build_tokenizer(config.get("text_encoder", ""))
    image_res = config.get("image_res", 384)
    prompt = config.get("prompt", "a picture of ")
    prompt_len = len(tokenizer([prompt])["input_ids"][0]) - 1
    config["prompt_length"], config["pad_token_id"] = prompt_len, tokenizer.pad_token_id
    student, teacher = build_models(config)
    student.prompt_length = teacher.prompt_length = prompt_len

    pretrain = bool(args.get("load_capt_pretrain"))
    sparams = common.load_student(
        student, args, lambda: student.init(0, device=device),
        lambda path: load_torch_params(student, path, pretrain, device=device), device=device)
    l0 = build_l0(config)
    l0_params = l0.init(2, device=device)
    val_ds = CaptioningEvalDataset(config["val_file"], common.eval_transform(config, image_res),
                                   config.get("image_root", ""))
    val_loader = SimpleLoader(val_ds, batch_size=config.get("batch_size_test", 16))

    if args.get("evaluate"):
        zs = common.eval_gates(l0, l0_params, args, Config(), device=device)
        results = evaluation(student, sparams, val_loader, tokenizer, config, zs=zs)
        return {"results": collect_result(
            results, "caption_result", out_dir, hdfs_wdir=args.get("output_hdfs", ""),
            rank=info["rank"], world_size=info["world_size"], remove_duplicate="image_id")}

    if args.get("scst"):
        return scst_train(args, config, student, sparams, l0, l0_params, tokenizer, info,
                          prompt, device)

    dtype = common.compute_dtype(config)
    tparams = common.frozen_teacher(
        load_torch_params(teacher, args.get("teacher_chkpt"), pretrain, device=device)
        or teacher.init(1, device=device), dtype)
    train_ds = CaptioningTrainDataset(
        config["train_file"],
        common.preprocess_transform(config, default=ImageTransform.train(image_res, seed=seed)),
        config.get("image_root", ""), prompt=prompt, max_words=config.get("max_tokens", 30))
    bs = int(args.get("bs") or config.get("batch_size_train", 16))
    train_loader = common.maybe_parallel_loader(SimpleLoader(
        train_ds, batch_size=bs, shuffle=True, drop_last=True, rank=info["rank"],
        world_size=info["world_size"]), config)
    epochs = int(args.get("epoch") or config.get("schedular", {}).get("epochs", 5))
    steps_per_epoch = max(len(train_loader), 1)
    l0.lagrangian_warmup = int(float(config.get("L0_schedular", {}).get(
        "lagrangian_warmup_epochs", 1)) * steps_per_epoch)
    optimizers = build_optimizers(sparams, config, epochs * steps_per_epoch)
    state = init_train_state(sparams, l0_params, optimizers)
    step = common.build_train_step(build_step(
        config, student, teacher, l0, optimizers, teacher_params=tparams,
        temperature=float(args.get("temperature", 1.0)), dtype=dtype,
        impl=config.get("attn_impl", "fused")), config)
    state, start_epoch, resume_batches = common.resume_epochs(args, state)

    epochs_run = []
    prof = common.StepProfiler(config, out_dir)
    for epoch in range(start_epoch, epochs):
        state, logger, record = common.train_epoch(
            train_loader, step, state, lambda items: make_batch(items, tokenizer, config, device),
            prof, epoch=epoch, seed=seed, device=device, output_dir=out_dir, backend=backend,
            resume_batches=resume_batches if epoch == start_epoch else 0, batch_size=bs)
        zs = l0.forward_deterministic({"loga": state.loga})
        t0 = time.perf_counter()
        results = evaluation(student, state.params, val_loader, tokenizer, config, zs=zs)
        record["eval_s"] = time.perf_counter() - t0
        metrics = {}
        if config.get("val_gt_file"):
            with open(config["val_gt_file"]) as f:
                metrics = coco_caption_eval(json.load(f), results)
        common.log_stats({"epoch": epoch, **metrics, **common.train_stats(logger)}, out_dir)
        common.save_training_state(out_dir, epoch, {
            "model": state.params, "l0": {"loga": state.loga, **state.lam}, "epoch": epoch})
        common.save_full_state(out_dir, state, {"epoch": epoch}, backend=backend)
        epochs_run.append(dict(record, metrics=metrics, results=results))
    return {"state": state, "epochs": epochs_run}


def _host_draws(dataset) -> dict:
    """The states of the host generators an SCST epoch draws from: the
    dataset's (the ground truths picked) and the train transform's."""
    return {"rng": dataset.rng.bit_generator.state,
            "transform_rng": dataset.transform.rng.bit_generator.state}


def _load_host_draws(dataset, states: dict) -> None:
    dataset.rng.bit_generator.state = states["rng"]
    dataset.transform.rng.bit_generator.state = states["transform_rng"]


def _preempted_exit(out_dir: str, state, epoch: int, draws: dict, backend: str) -> None:
    """SCST's preemption: the state saved as of epoch - 1 with the host
    generators' states at the epoch's start, then exit 0."""
    if out_dir:
        common.save_full_state(out_dir, state, {"epoch": epoch - 1, "scst": True,
                                                "host_draws": draws}, backend=backend)
        common.wait_for_saves()
        common.log_stats({"preempted": True, "epoch": epoch, "scst": True}, out_dir)
    print(f"### scst preempted in epoch {epoch}: state saved, exiting")
    raise SystemExit(0)


def scst_train(args: Config, config: Config, student: XVLMForCaptioning, sparams, l0: L0Module,
               l0_params: dict, tokenizer, info: Config, prompt: str, device) -> dict:
    """The --scst fine-tune (efficientvlm_tpu/drivers/captioning.py:241-351,
    the reference's Eff_Captioning.py --scst): per batch, sample_n sampled
    captions (top_p scst_top_p) and the greedy caption of each image from
    the prompt, their CIDEr-D advantages against the image's ground truths
    (greedy baseline), and one update of -(advantage x log-prob) by an AdamW
    at lr_scst (default lr) over a linear schedule, clipped at
    accelerator.CLIP_GRAD_NORM (default 1). Batch: --bs, else
    batch_size_train_scst, else batch_size_train. The gates are frozen
    deterministic when sparsity > 0. Compute in compute_dtype, bf16 by
    default as in every other loop: JAX's SCST computes in f32 whatever the
    config says, but the port's kernels compute in bf16, so an f32 SCST
    runs only on the plain path (compute_dtype other than bf16 with
    attn_impl plain; ROADMAP C). The full state is saved at each
    epoch's end; on preemption it is saved as of epoch - 1 with the host
    generators' states at the epoch's start, and --resume replays the epoch.
    Above one process each rank samples its loader shard with its own
    generator and the grad step averages the gradients over the ranks
    (common.build_train_step), the ranks agreeing on a preemption every 10
    batches and at the epoch's end, as JAX's does. Returns {"state",
    "reward_history", "epochs"} (each epoch's steps, seconds, and per step
    the seconds of sampling, reward and update)."""
    world = info["world_size"]
    out_dir = args.get("output_dir") or ""
    backend = common.checkpoint_backend(config)
    seed = int(args.get("seed", 42))
    image_res = config.get("image_res", 384)
    sample_n = int(config.get("scst_sample_n", 5))
    bs = int(args.get("bs") or config.get("batch_size_train_scst",
                                          config.get("batch_size_train", 8)))
    train_ds = CaptioningSCSTDataset(
        config["train_file"], ImageTransform.train(image_res, seed=seed),
        config.get("image_root", ""), max_words=config.get("max_tokens", 30), n_gts=sample_n,
        seed=seed)
    train_loader = common.maybe_parallel_loader(SimpleLoader(
        train_ds, batch_size=bs, shuffle=True, drop_last=True, rank=info["rank"],
        world_size=info["world_size"], collate_fn=scst_collate), config)
    epochs = int(args.get("epoch") or config.get("schedular", {}).get("epochs", 3))
    opt_cfg = config.get("optimizer", Config())
    sched = create_scheduler(
        lr=float(opt_cfg.get("lr_scst", opt_cfg.get("lr", 1e-5))),
        num_training_steps=epochs * max(len(train_loader), 1),
        num_warmup_steps=config.get("schedular", {}).get("num_warmup_steps", 0))
    clip = float(config.get("accelerator", {}).get("CLIP_GRAD_NORM", 1.0) or 0) or None
    optimizer = create_optimizer(sparams, lr=sched,
                                 weight_decay=float(opt_cfg.get("weight_decay", 0.01)),
                                 grad_clip=clip)
    zs = (l0.forward_deterministic({"loga": l0_params["loga"]})
          if float(config.get("sparsity", 0.0)) > 0 else None)
    eos_id, pad_id = tokenizer.sep_token_id, tokenizer.pad_token_id
    sample_fn, grad_step = make_scst_step(
        student, optimizer, prompt_length=student.prompt_length, pad_token_id=pad_id,
        eos_id=eos_id, sample_n=sample_n, max_length=int(config.get("max_length", 20)),
        min_length=int(config.get("min_length", 5)),
        top_p=float(config.get("scst_top_p", 1.0)), zs=zs,
        dtype=common.compute_dtype(config), impl=config.get("attn_impl", "fused"))
    grad_step = common.build_train_step(grad_step, config)
    criterion = ScstRewardCriterion(sample_n=sample_n, baseline_type="greedy")
    prompt_ids = np.asarray(tokenizer([prompt])["input_ids"], np.int64)[:, :-1]  # drop [SEP]

    state = init_pretrain_state(sparams, optimizer)
    start_epoch = 0
    restored = (common.restore_full_state(out_dir, state)
                if args.get("resume") and out_dir else None)
    if restored is not None:
        state, extra = restored
        start_epoch = int(extra.get("epoch", -1)) + 1
        if "host_draws" in extra:
            _load_host_draws(train_ds, extra["host_draws"])
        print(f"### scst resumed from epoch {start_epoch}")
    reward_hist, epochs_run = [], []
    for epoch in range(start_epoch, epochs):
        train_loader.set_epoch(epoch)
        draws = _host_draws(train_ds)
        logger = MetricLogger()
        parts = {"sample_s": [], "reward_s": [], "grad_s": []}
        t_epoch = time.perf_counter()
        for i, (images, gt_lists) in enumerate(
                logger.log_every(train_loader, 10, f"SCST Epoch: [{epoch}]")):
            t0 = time.perf_counter()
            image = common.to_device(images, device)
            pids = common.to_device(np.repeat(prompt_ids, len(gt_lists), axis=0), device)
            sample_toks, greedy_toks = sample_fn(
                state.params, image, pids, common.step_generator(seed, epoch, i, device))
            sample_np, greedy_np = sample_toks.cpu().numpy(), greedy_toks.cpu().numpy()
            t1 = time.perf_counter()
            sampled = [tokenizer.decode(t, skip_special_tokens=True) for t in sample_np]
            greedy = [tokenizer.decode(t, skip_special_tokens=True) for t in greedy_np]
            adv = criterion.rewards(gt_lists, sampled, greedy)
            t2 = time.perf_counter()
            metrics = grad_step(state, {"image": image, "tokens": sample_toks,
                                        "advantages": common.to_device(adv, device)})
            metrics = {k: float(v) for k, v in metrics.items()}
            t3 = time.perf_counter()
            for key, seconds in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
                parts[key].append(seconds)
            logger.update(reward=criterion.get_score(), **metrics)
            reward_hist.append(criterion.get_score())
            # the loop reads the reward on the host every batch, so the
            # interrupted epoch is replayed whole on resume
            if common.preempted() if world == 1 else (
                    (i + 1) % 10 == 0 and common.preempted_sync()):
                _preempted_exit(out_dir, state, epoch, draws, backend)
        if world > 1 and common.preempted_sync():  # an epoch shorter than 10 batches
            _preempted_exit(out_dir, state, epoch, draws, backend)
        logger.synchronize_between_processes()
        common.log_stats({"epoch": epoch, "scst": True, **common.train_stats(logger)}, out_dir)
        common.save_full_state(out_dir, state, {"epoch": epoch, "scst": True,
                                                "host_draws": _host_draws(train_ds)},
                               backend=backend)
        epochs_run.append({"epoch": epoch, "steps": len(parts["grad_s"]), "batch": bs,
                           "train_s": time.perf_counter() - t_epoch, **parts})
    return {"state": state, "reward_history": reward_hist, "epochs": epochs_run}
