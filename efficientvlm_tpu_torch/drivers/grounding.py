"""The visual grounding fine-tune and its evaluation: the models, the gates,
the step, the boxes, the evaluation and the loop of
efficientvlm_tpu/drivers/grounding.py. The
student regresses the referred box (L1 + GIoU) under L0 gates at the
config's sparsity; loss = the box losses + the Lagrangian (task weight 1,
no teacher, loss_kd 0: the reference has no grounding KD recipe).

Batches: {"image" [B,H,W,3], "text_ids", "text_atts" [B,T], "target_bbox"
[B,4] (cx, cy, w, h in [0, 1])}. main runs on the device args["device"]
names (default cuda), with JAX's loop (one device a process).
"""

from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..data.datasets import GroundingBboxDataset, SimpleLoader
from ..data.tokenizer import build_tokenizer
from ..data.transforms import ImageTransform
from ..device import resolve_device
from ..evaluation.grounding import grounding_eval_bbox
from ..models.model_grounding import XVLMForGrounding
from ..pruning.l0_module import L0Module, XVLML0Module
from ..train.steps import TaskTrainStep, init_train_state, make_task_train_step
from . import common

TASK_WEIGHT, KD_WEIGHT = 1.0, 0.0


def build_models(config: Config):
    """(student, teacher) XVLMForGrounding (their init holds the bbox
    head); the step reads no teacher (KD_WEIGHT 0)."""
    vcfg, tcfg = common.model_configs(config)
    tv, tt = common.teacher_configs(config)
    return XVLMForGrounding(vcfg, tcfg, config), XVLMForGrounding(tv, tt, config)


def build_l0(config: Config) -> L0Module:
    """XVLML0Module over the student's towers, head gates per
    head_gate_group heads, the sparsity target."""
    vcfg, tcfg = common.model_configs(config)
    return XVLML0Module(
        vision_layers=vcfg["num_hidden_layers"], text_layers=tcfg["fusion_layer"],
        cross_layers=tcfg["num_hidden_layers"] - tcfg["fusion_layer"],
        hidden_size=tcfg["hidden_size"], intermediate_size=tcfg["intermediate_size"],
        num_heads=tcfg["num_attention_heads"], vision_hidden_size=vcfg["vision_width"],
        vision_intermediate_size=vcfg["intermediate_size"],
        vision_num_heads=vcfg["num_attention_heads"],
        target_sparsity=float(config.get("sparsity", 0.0)),
        head_group=int(config.get("head_gate_group", 1)))


def build_optimizers(params, config: Config, total_steps: int):
    """common.build_optimizers."""
    return common.build_optimizers(params, config, total_steps)


def build_step(config: Config, student: XVLMForGrounding, teacher, l0: L0Module, optimizers,
               *, teacher_params=None, frozen_zs: Optional[dict] = None, dtype=None,
               impl: str = "fused") -> TaskTrainStep:
    """The step: the student in train mode, loss = loss_bbox + loss_giou
    (both in the metrics); teacher and teacher_params, in the other task
    drivers' signature, are not read (no KD); frozen_zs is stop_prune."""

    def student_forward(params, zs, batch, generator):
        loss_bbox, loss_giou = student.forward(
            params, batch["image"], batch["text_ids"], batch["text_atts"],
            target_bbox=batch["target_bbox"], zs=zs, generator=generator, train=True,
            dtype=dtype, impl=impl)
        return {"loss": loss_bbox + loss_giou, "loss_bbox": loss_bbox, "loss_giou": loss_giou}

    return make_task_train_step(
        student_forward, lambda params, batch: {},
        lambda s, t: {"loss_kd": torch.zeros((), device=s["loss"].device)},
        l0, optimizers, teacher_params={}, task_weight=TASK_WEIGHT, kd_weight=KD_WEIGHT,
        frozen_zs=frozen_zs)


@torch.no_grad()
def predict(model: XVLMForGrounding, params, batch: dict, *, zs=None, dtype=None,
            impl: str = "fused") -> torch.Tensor:
    """The boxes [B, 4] (cx, cy, w, h in [0, 1]) of one evaluation batch
    ({"image", "text_ids", "text_atts"}); evaluation/grounding.
    grounding_eval_bbox scores them."""
    return model.forward(params, batch["image"], batch["text_ids"], batch["text_atts"],
                         train=False, zs=zs, dtype=dtype, impl=impl)


def evaluate(model: XVLMForGrounding, params, loader, tokenizer, config: Config, *, zs=None,
             dtype=None) -> list:
    """The evaluation split's boxes (efficientvlm_tpu/drivers/
    grounding.py:52-69), on the params' device: [{"ref_id", "pred" (cx, cy,
    w, h in [0, 1]), "width", "height"}]."""
    device = common.device_of(params)
    dtype = dtype or common.compute_dtype(config)
    results = []
    for images, captions, ref_ids, widths, heights in loader:
        tok = tokenizer(list(captions), padding="max_length", truncation=True,
                        max_length=config.get("max_tokens", 30))
        coords = predict(model, params, {
            "image": common.to_device(images, device),
            "text_ids": common.to_device(tok["input_ids"], device, torch.int64),
            "text_atts": common.to_device(tok["attention_mask"], device)},
            zs=zs, dtype=dtype, impl=config.get("attn_impl", "fused"))
        for rid, c, w, h in zip(ref_ids, coords.float().cpu().numpy(), widths, heights):
            results.append({"ref_id": int(rid), "pred": [float(v) for v in c],
                            "width": int(w), "height": int(h)})
    return results


def eval_metrics(results: list, config: Config) -> dict:
    """grounding_eval_bbox against config["ref_boxes"] (ref_id -> {"bbox",
    "split"}), or {} when the config names none."""
    if not config.get("ref_boxes"):
        return {}
    with open(config["ref_boxes"]) as f:
        gt = json.load(f)
    return grounding_eval_bbox(results, {int(k): v["bbox"] for k, v in gt.items()},
                               {int(k): v.get("split", "val") for k, v in gt.items()})


def make_batch(items, tokenizer, config: Config, device) -> dict:
    """A loader batch (images, captions, cxcywh targets) as the step's batch
    on `device`."""
    images, captions, targets = items
    tok = tokenizer(list(captions), padding="max_length", truncation=True,
                    max_length=config.get("max_tokens", 30))
    return {"image": common.to_device(images, device),
            "text_ids": common.to_device(tok["input_ids"], device, torch.int64),
            "text_atts": common.to_device(tok["attention_mask"], device),
            "target_bbox": common.to_device(np.stack(targets), device)}


def main(args: Config, config: Config) -> dict:
    """The fine-tune (efficientvlm_tpu/drivers/grounding.py:71-185): the
    student with its bbox head through maybe_load_params, the gates,
    --evaluate (the test boxes with a native checkpoint's stored gates or
    the init gates' deterministic ones, scored by grounding_eval_bbox over
    ref_boxes), the train set (ImageTransform.box, the careful flip),
    --resume, and per epoch the no-teacher loop, log.txt and the full state.
    Returns {"state", "epochs"}; with --evaluate {"results", and the
    metrics}."""
    info = common.setup(args, config)
    backend = common.checkpoint_backend(config)
    device = resolve_device(args.get("device"))
    out_dir = args.get("output_dir", "")
    seed = int(args.get("seed", 42))
    tokenizer = build_tokenizer(config.get("text_encoder", ""))
    image_res = config.get("image_res", 384)
    student, teacher = build_models(config)
    sparams = common.maybe_load_params(student, args, config,
                                       lambda: student.init(0, device=device), device=device,
                                       with_bbox_head=True)
    l0 = build_l0(config)
    l0_params = l0.init(2, device=device)
    test_ds = GroundingBboxDataset(config["test_file"], common.eval_transform(config, image_res),
                                   config.get("image_root", ""), image_res=image_res,
                                   mode="test")
    test_loader = SimpleLoader(test_ds, batch_size=config.get("batch_size_test", 16))

    if args.get("evaluate"):
        zs = common.eval_gates(l0, l0_params, args, config, device=device)
        t0 = time.perf_counter()
        results = evaluate(student, sparams, test_loader, tokenizer, config, zs=zs)
        metrics = eval_metrics(results, config)
        common.log_stats({"test": metrics, "eval_s": time.perf_counter() - t0}, out_dir)
        return {"results": results, **metrics}

    train_ds = GroundingBboxDataset(
        config["train_file"], ImageTransform.box(image_res, seed=seed),
        config.get("image_root", ""), image_res=image_res, mode="train",
        careful_hflip=bool(config.get("careful_hflip", True)), seed=seed)
    bs = int(args.get("bs") or config.get("batch_size_train", 16))
    train_loader = common.maybe_parallel_loader(SimpleLoader(
        train_ds, batch_size=bs, shuffle=True, drop_last=True, rank=info["rank"],
        world_size=info["world_size"]), config)
    epochs = int(args.get("epoch") or config.get("schedular", {}).get("epochs", 10))
    steps_per_epoch = max(len(train_loader), 1)
    l0.lagrangian_warmup = int(float(config.get("L0_schedular", {}).get(
        "lagrangian_warmup_epochs", 1)) * steps_per_epoch)
    optimizers = build_optimizers(sparams, config, epochs * steps_per_epoch)
    state = init_train_state(sparams, l0_params, optimizers)
    step = common.build_train_step(build_step(
        config, student, teacher, l0, optimizers, dtype=common.compute_dtype(config),
        impl=config.get("attn_impl", "fused")), config)
    state, start_epoch, resume_batches = common.resume_epochs(args, state)

    epochs_run = []
    prof = common.StepProfiler(config, out_dir)
    for epoch in range(start_epoch, epochs):
        state, logger, record = common.train_epoch(
            train_loader, step, state, lambda items: make_batch(items, tokenizer, config, device),
            prof, epoch=epoch, seed=seed, device=device, output_dir=out_dir, backend=backend,
            resume_batches=resume_batches if epoch == start_epoch else 0, batch_size=bs)
        common.log_stats({"epoch": epoch, **common.train_stats(logger)}, out_dir)
        common.save_full_state(out_dir, state, {"epoch": epoch}, backend=backend)
        epochs_run.append(record)
    return {"state": state, "epochs": epochs_run}
