"""The NLVR2 pruning fine-tune (stage 2, the reference's Eff_NLVR.py): the
models, the gates, the optimizers, the step, checkpoint import, the
evaluation and the loop of efficientvlm_tpu/drivers/nlvr.py. The 12L/12L teacher (6 text + 2 x 6
replicated cross layers) distils into the 6L/6L student (3 + 2 x 3);
loss = 0.8 x the cross-entropy of the pair label + 0.2 x nlvr_kd_losses +
the Lagrangian; cls_head, trained from scratch, takes lr_mult. With
`device_preprocess` the host ships uint8 images and the step crops, flips,
augments and normalises image0 and then image1 on the device first.

Batches: {"image0", "image1" [B,H,W,3], "text_ids", "text_atts" [B,T],
"targets" [B]}; the model reads the 2B image batch, image0 rows first.
main runs on the device args["device"] names (default cuda), with JAX's
loop but for these: --checkpoint may also name a native
.ckpt; --evaluate builds no teacher; with compute_dtype bf16 the frozen
teacher is stored in bf16; each epoch also scores the test split. The
domain task nlvr_domain runs this loop too, as run.py routes it: neither
package has a loop of XVLMForNLVRPretraining (ROADMAP C).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..data.datasets import NLVRDataset, SimpleLoader
from ..data.tokenizer import build_tokenizer
from ..data.transforms import ImageTransform
from ..device import resolve_device
from ..evaluation.grounding import nlvr_accuracy
from ..models.model_nlvr import XVLMForNLVR
from ..pruning.l0_module import L0Module, NLVRL0Module
from ..train import checkpoint as ckpt_io
from ..train.steps import (
    TaskTrainStep, init_train_state, make_task_train_step, nlvr_kd_losses, subset_teacher_taps,
)
from . import common
from .common import DevicePreprocess

TASK_WEIGHT, KD_WEIGHT = 0.8, 0.2
IMAGE_KEYS = ("image0", "image1")
INIT_PARAM_PATHS = ("cls_head",)


def build_models(config: Config):
    """(student, teacher) XVLMForNLVR over the towers' base configs (the
    replicated stack is built inside)."""
    vcfg, tcfg = common.model_configs(config)
    tv, tt = common.teacher_configs(config)
    return XVLMForNLVR(vcfg, tcfg, config), XVLMForNLVR(tv, tt, config)


def load_nlvr(model: XVLMForNLVR, ckpt_path, load_nlvr_pretrain: bool = False, *,
              device=None) -> Optional[dict]:
    """A reference-keyed torch checkpoint for `model` on `device` (default
    cuda), or None when the path is absent (efficientvlm_tpu/drivers/
    nlvr.py:76-92): the cross layers replicated into the pair stack (not
    for an NLVR domain pretrain), and a from-scratch cls_head (the
    model's init from seed 9) when the file has none."""
    if not (ckpt_path and os.path.exists(ckpt_path)):
        return None
    device = resolve_device(device)
    loaded = ckpt_io.nlvr_params_from_state_dict(
        ckpt_io.load_torch_state_dict(ckpt_path),
        vision_layers=model.vision_cfg["num_hidden_layers"],
        text_layers=model.base_text_cfg["num_hidden_layers"],
        fusion_layer=model.base_text_cfg["fusion_layer"],
        num_patches=model.vision_cfg.num_patches, load_nlvr_pretrain=load_nlvr_pretrain,
        device=device)
    if "cls_head" not in loaded:
        loaded["cls_head"] = model.init(9, device=device)["cls_head"]
    return loaded


def build_l0(config: Config) -> L0Module:
    """NLVRL0Module over the student's towers, head gates per
    head_gate_group heads, the sparsity target."""
    vcfg, tcfg = common.model_configs(config)
    return NLVRL0Module(
        vision_layers=vcfg["num_hidden_layers"], text_layers=tcfg["fusion_layer"],
        cross_layers=tcfg["num_hidden_layers"] - tcfg["fusion_layer"],
        hidden_size=tcfg["hidden_size"], intermediate_size=tcfg["intermediate_size"],
        num_heads=tcfg["num_attention_heads"], vision_hidden_size=vcfg["vision_width"],
        vision_intermediate_size=vcfg["intermediate_size"],
        vision_num_heads=vcfg["num_attention_heads"],
        target_sparsity=float(config.get("sparsity", 0.0)),
        head_group=int(config.get("head_gate_group", 1)))


def build_optimizers(params, config: Config, total_steps: int):
    """common.build_optimizers with cls_head at lr_mult."""
    return common.build_optimizers(params, config, total_steps,
                                   init_param_paths=INIT_PARAM_PATHS)


def images(batch: dict) -> torch.Tensor:
    """The 2B image batch the model reads: image0 rows, then image1 rows."""
    return torch.cat([batch["image0"], batch["image1"]], 0)


def build_step(config: Config, student: XVLMForNLVR, teacher: XVLMForNLVR, l0: L0Module,
               optimizers, *, teacher_params, frozen_zs: Optional[dict] = None,
               temperature: float = 1.0, dtype=None, impl: str = "fused"):
    """The step (a TaskTrainStep, in DevicePreprocess over image0 and image1
    when config["device_preprocess"] is set): the student in train mode with
    its KD taps, the teacher in eval mode with its maps (the kernels' probs
    forms), its taps cut to the student's depths right after its forward;
    frozen_zs is stop_prune."""
    depth, fusion = student.text_cfg["num_hidden_layers"], student.num_text_layers
    taps = dict(output_attentions=True, output_hidden_states=True, dtype=dtype, impl=impl)

    def student_forward(params, zs, batch, generator):
        return student.forward(params, images(batch), batch["text_ids"], batch["text_atts"],
                               batch["targets"], zs=zs, generator=generator, train=True, **taps)

    def teacher_forward(params, batch):
        out = teacher.forward(params, images(batch), batch["text_ids"], batch["text_atts"],
                              train=False, **taps)
        # the replicated text stack's taps map over its whole depth before
        # the KD splits them at the student's fusion layer
        return subset_teacher_taps(
            out, vision_layers=student.vision_cfg["num_hidden_layers"], text_fusion=fusion,
            cross_layers=depth - fusion,
            by_key={"text_hidden_states": depth, "text_attentions": depth})

    step: TaskTrainStep = make_task_train_step(
        student_forward, teacher_forward,
        lambda s, t: nlvr_kd_losses(s, t, fusion_layer_s=fusion, temperature=temperature),
        l0, optimizers, teacher_params=teacher_params, task_weight=TASK_WEIGHT,
        kd_weight=KD_WEIGHT, frozen_zs=frozen_zs)
    if config.get("device_preprocess"):
        return DevicePreprocess(step, int(config.get("image_res", 384)), image_keys=IMAGE_KEYS)
    return step


@torch.no_grad()
def predict(model: XVLMForNLVR, params, batch: dict, *, zs=None, dtype=None,
            impl: str = "fused") -> torch.Tensor:
    """The logits [B, 2] of one evaluation batch ({"image0", "image1",
    "text_ids", "text_atts"}); evaluation/grounding.nlvr_accuracy scores
    them."""
    return model.forward(params, images(batch), batch["text_ids"], batch["text_atts"],
                         train=False, zs=zs, dtype=dtype, impl=impl)


def evaluate(model: XVLMForNLVR, params, loader, tokenizer, config: Config, *, zs=None,
             dtype=None) -> float:
    """nlvr_accuracy of the loader's pairs (efficientvlm_tpu/drivers/
    nlvr.py:48-64): the logits of the two images concatenated on the batch
    axis, on the params' device."""
    device = common.device_of(params)
    dtype = dtype or common.compute_dtype(config)
    preds, targets = [], []
    for image0, image1, sentences, labels in loader:
        tok = tokenizer(list(sentences), padding="max_length", truncation=True,
                        max_length=config.get("max_tokens", 40))
        batch = {"image0": common.to_device(image0, device),
                 "image1": common.to_device(image1, device),
                 "text_ids": common.to_device(tok["input_ids"], device, torch.int64),
                 "text_atts": common.to_device(tok["attention_mask"], device)}
        logits = predict(model, params, batch, zs=zs, dtype=dtype,
                         impl=config.get("attn_impl", "fused"))
        preds.append(logits.float().cpu().numpy())
        targets.append(np.asarray(labels))
    return nlvr_accuracy(np.concatenate(preds), np.concatenate(targets))


def make_batch(items, tokenizer, config: Config, device) -> dict:
    """A loader batch (image0, image1, sentences, labels) as the step's
    batch on `device`."""
    image0, image1, sentences, labels = items
    tok = tokenizer(list(sentences), padding="max_length", truncation=True,
                    max_length=config.get("max_tokens", 40))
    return {"image0": common.to_device(image0, device),
            "image1": common.to_device(image1, device),
            "text_ids": common.to_device(tok["input_ids"], device, torch.int64),
            "text_atts": common.to_device(tok["attention_mask"], device),
            "targets": common.to_device(labels, device, torch.int64)}


def main(args: Config, config: Config) -> dict:
    """The fine-tune (efficientvlm_tpu/drivers/nlvr.py:66-216): the student
    (a native --checkpoint as stored, else a .th through load_nlvr with
    --load_nlvr_pretrain, else the seeded init) and the teacher
    (--teacher_chkpt), the gates, --evaluate (the test accuracy with a
    native checkpoint's stored gates or the init gates' deterministic ones),
    the optimizers with cls_head at lr_mult, --resume, and per epoch the
    loop, the validation and test accuracy, log.txt, the full state and the
    best snapshot (val_acc >= the best so far). Returns {"best_epoch",
    "best_acc", "state", "epochs"}; with --evaluate {"test_acc"}."""
    info = common.setup(args, config)
    backend = common.checkpoint_backend(config)
    device = resolve_device(args.get("device"))
    out_dir = args.get("output_dir", "")
    seed = int(args.get("seed", 42))
    tokenizer = build_tokenizer(config.get("text_encoder", ""))
    image_res = config.get("image_res", 384)
    tform_test = common.eval_transform(config, image_res)
    student, teacher = build_models(config)

    pretrain = bool(args.get("load_nlvr_pretrain"))
    sparams = common.load_student(
        student, args, lambda: student.init(0, device=device),
        lambda path: load_nlvr(student, path, pretrain, device=device), device=device)
    l0 = build_l0(config)
    l0_params = l0.init(2, device=device)
    root = config.get("image_root", "")
    val_ds = NLVRDataset(config["val_file"], tform_test, root)
    val_loader = SimpleLoader(val_ds, batch_size=config.get("batch_size_test", 16))
    test_ds = NLVRDataset(config["test_file"], tform_test, root)
    test_loader = SimpleLoader(test_ds, batch_size=config.get("batch_size_test", 16))

    if args.get("evaluate"):
        zs = common.eval_gates(l0, l0_params, args, Config(), device=device)
        acc = evaluate(student, sparams, test_loader, tokenizer, config, zs=zs)
        common.log_stats({"test_acc": acc}, out_dir)
        return {"test_acc": acc}

    dtype = common.compute_dtype(config)
    tparams = common.frozen_teacher(
        load_nlvr(teacher, args.get("teacher_chkpt"), pretrain, device=device)
        or teacher.init(1, device=device), dtype)
    train_ds = NLVRDataset(
        config["train_file"],
        common.preprocess_transform(config, default=ImageTransform.train(image_res, seed=seed)),
        root)
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
        config, student, teacher, l0, optimizers, teacher_params=tparams,
        temperature=float(args.get("temperature", 1.0)), dtype=dtype,
        impl=config.get("attn_impl", "fused")), config)
    state, start_epoch, resume_batches = common.resume_epochs(args, state)

    best, best_epoch, epochs_run = 0.0, 0, []
    prof = common.StepProfiler(config, out_dir)
    for epoch in range(start_epoch, epochs):
        state, logger, record = common.train_epoch(
            train_loader, step, state, lambda items: make_batch(items, tokenizer, config, device),
            prof, epoch=epoch, seed=seed, device=device, output_dir=out_dir, backend=backend,
            resume_batches=resume_batches if epoch == start_epoch else 0, batch_size=bs)
        zs = l0.forward_deterministic({"loga": state.loga})
        t0 = time.perf_counter()
        val_acc = evaluate(student, state.params, val_loader, tokenizer, config, zs=zs)
        test_acc = evaluate(student, state.params, test_loader, tokenizer, config, zs=zs)
        record["eval_s"] = time.perf_counter() - t0
        common.log_stats({"epoch": epoch, "val_acc": val_acc, "test_acc": test_acc,
                          **common.train_stats(logger)}, out_dir)
        common.save_full_state(out_dir, state, {"epoch": epoch}, backend=backend)
        if val_acc >= best:
            best, best_epoch = val_acc, epoch
            common.save_training_state(out_dir, "best", {
                "model": state.params, "l0": {"loga": state.loga, **state.lam}, "epoch": epoch})
        epochs_run.append(dict(record, val_acc=val_acc, test_acc=test_acc))
    return {"best_epoch": best_epoch, "best_acc": best, "state": state, "epochs": epochs_run}
