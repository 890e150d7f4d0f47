"""The VQA pruning fine-tune (stage 2, the reference's Eff_VQA.py): the
models, the gates, the step, checkpoint import, the answer-ranking
evaluation and the loop of efficientvlm_tpu/drivers/vqa.py. The 12L/12L teacher with a 6-layer
answer decoder distils into the 6L/6L student with num_dec_layers (3);
loss = 0.6 x the weighted answer loss + 0.4 x vqa_kd_losses + the
Lagrangian. With `device_preprocess` the host ships uint8 images and the
step crops, augments and normalises them on the device first, without the
flip (the reference's VQA transform has none).

Batches: {"image", "q_ids", "q_atts", "a_ids", "a_atts", "weights",
"k_index"}, the answers flattened by data/collate.vqa_collate. main runs
on the device args["device"] names (default cuda), with JAX's loop but for
these: the loader's batch is a rank's batch_size_train; --checkpoint
may also name a native .ckpt (a snapshot, evaluated with its stored gates,
or a physical export, evaluated dense); --evaluate builds no teacher; with
compute_dtype bf16 the frozen teacher is stored in bf16.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

from ..config import Config
from ..data.collate import vqa_collate
from ..data.datasets import SimpleLoader, VQADataset
from ..data.tokenizer import build_tokenizer
from ..data.transforms import ImageTransform
from ..data.utils import collect_result
from ..device import resolve_device
from ..models.model_generation import XVLMForVQA
from ..pruning.l0_module import L0Module, VQAL0Module
from ..train import checkpoint as ckpt_io
from ..train.steps import (
    TaskTrainStep, init_train_state, make_task_train_step, subset_teacher_taps, vqa_kd_losses,
)
from . import common
from .common import DevicePreprocess

TASK_WEIGHT, KD_WEIGHT = 0.6, 0.4


def build_models(config: Config):
    """(student, teacher) XVLMForVQA: the student's answer decoder has
    config["num_dec_layers"] layers (default: its cross depth), the
    teacher's config["teacher_num_dec_layers"] (default: its cross depth,
    12 - 6)."""
    vcfg, tcfg = common.model_configs(config)
    tv, tt = common.teacher_configs(config)
    student_cfg = Config(config, num_dec_layers=config.get(
        "num_dec_layers", tcfg["num_hidden_layers"] - tcfg["fusion_layer"]))
    teacher_cfg = Config(config, num_dec_layers=config.get(
        "teacher_num_dec_layers", tt["num_hidden_layers"] - tt["fusion_layer"]))
    return XVLMForVQA(vcfg, tcfg, student_cfg), XVLMForVQA(tv, tt, teacher_cfg)


def load_torch_params(model: XVLMForVQA, ckpt_path, use_stored_decoder: bool = True, *,
                      device=None) -> Optional[dict]:
    """A reference-keyed torch checkpoint for `model` on `device` (default
    cuda), or None when the path is absent (efficientvlm_tpu/drivers/
    vqa.py:38-60): the answer decoder derived from the cross layers, or with
    use_stored_decoder (the reference's is_eval: --evaluate or
    --load_vqa_pretrain) a VQA-shaped checkpoint's own decoder."""
    if not (ckpt_path and os.path.exists(ckpt_path)):
        return None
    device = resolve_device(device)
    return ckpt_io.vqa_params_from_state_dict(
        ckpt_io.load_torch_state_dict(ckpt_path),
        vision_layers=model.vision_cfg["num_hidden_layers"],
        text_layers=model.text_cfg["num_hidden_layers"],
        fusion_layer=model.text_cfg["fusion_layer"],
        num_dec_layers=model.decoder_cfg["num_hidden_layers"],
        num_patches=model.vision_cfg.num_patches, use_stored_decoder=use_stored_decoder,
        device=device)


def build_l0(config: Config) -> L0Module:
    """The student's gate layout: VQAL0Module over its towers and its
    answer decoder, head gates per head_gate_group heads, the sparsity
    target."""
    vcfg, tcfg = common.model_configs(config)
    cross = tcfg["num_hidden_layers"] - tcfg["fusion_layer"]
    return VQAL0Module(
        vision_layers=vcfg["num_hidden_layers"], text_layers=tcfg["fusion_layer"],
        cross_layers=cross, decoder_layers=config.get("num_dec_layers", cross),
        hidden_size=tcfg["hidden_size"], intermediate_size=tcfg["intermediate_size"],
        num_heads=tcfg["num_attention_heads"], vision_hidden_size=vcfg["vision_width"],
        vision_intermediate_size=vcfg["intermediate_size"],
        vision_num_heads=vcfg["num_attention_heads"],
        target_sparsity=float(config.get("sparsity", 0.0)),
        head_group=int(config.get("head_gate_group", 1)))


def build_optimizers(params, config: Config, total_steps: int):
    """common.build_optimizers."""
    return common.build_optimizers(params, config, total_steps)


def _forward_args(batch: dict) -> tuple:
    return tuple(batch[k] for k in ("image", "q_ids", "q_atts", "a_ids", "a_atts", "weights",
                                    "k_index"))


def build_step(config: Config, student: XVLMForVQA, teacher: XVLMForVQA, l0: L0Module,
               optimizers, *, teacher_params, frozen_zs: Optional[dict] = None,
               temperature: float = 1.0, dtype=None, impl: str = "fused"):
    """The step (a TaskTrainStep, in DevicePreprocess without the flip when
    config["device_preprocess"] is set): the student in train mode with its
    KD taps, the teacher in eval mode with its maps (the kernels' probs
    forms), its taps cut to the student's depths right after its forward.
    frozen_zs (l0.forward_deterministic at the stop epoch) is stop_prune."""
    tcfg = student.text_cfg
    fusion, depth = tcfg["fusion_layer"], tcfg["num_hidden_layers"]
    dec = student.decoder_cfg["num_hidden_layers"]
    taps = dict(output_attentions=True, output_hidden_states=True, dtype=dtype, impl=impl)

    def student_forward(params, zs, batch, generator):
        return student.forward_train(params, *_forward_args(batch), zs=zs, generator=generator,
                                     train=True, **taps)

    def teacher_forward(params, batch):
        out = teacher.forward_train(params, *_forward_args(batch), train=False, **taps)
        # the question stack's taps map over its whole depth before the KD
        # splits them at the student's fusion layer
        return subset_teacher_taps(
            out, vision_layers=student.vision_cfg["num_hidden_layers"], text_fusion=fusion,
            cross_layers=depth - fusion,
            by_key={"text_hidden_states": depth, "text_attentions": depth,
                    "decoder_hidden_states": dec, "decoder_attentions": dec,
                    "decoder_cross_attentions": dec})

    step: TaskTrainStep = make_task_train_step(
        student_forward, teacher_forward,
        lambda s, t: vqa_kd_losses(s, t, fusion_layer_s=fusion, temperature=temperature),
        l0, optimizers, teacher_params=teacher_params, task_weight=TASK_WEIGHT,
        kd_weight=KD_WEIGHT, frozen_zs=frozen_zs)
    if config.get("device_preprocess"):
        return DevicePreprocess(step, int(config.get("image_res", 480)), hflip=False)
    return step


@torch.no_grad()
def evaluation(model: XVLMForVQA, params, loader, tokenizer, config: Config, *, zs=None,
               dtype=None) -> list:
    """The answer ranking (efficientvlm_tpu/drivers/vqa.py:81-105, the
    reference's Eff_VQA.py:217-240): each question's top answer of the
    dataset's answer_list (each + "[SEP]", tokenized at padding "longest",
    max 20), ranked at k = min(k_test, len(answer_list)), on the params'
    device. Returns [{"question_id", "answer"}]."""
    answer_list = [a + "[SEP]" for a in loader.dataset.answer_list]
    ans = tokenizer(answer_list, padding="longest", truncation=True, max_length=20)
    k = min(int(config.get("k_test", 128)), len(answer_list))
    device = common.device_of(params)
    a_ids = common.to_device(ans["input_ids"], device, torch.int64)
    a_atts = common.to_device(ans["attention_mask"], device)
    dtype = dtype or common.compute_dtype(config)
    results = []
    for images, questions, qids in loader:
        tok = tokenizer(list(questions), padding="max_length", truncation=True,
                        max_length=config.get("max_tokens", 40))
        topk_ids, _ = model.forward_eval(
            params, common.to_device(images, device),
            common.to_device(tok["input_ids"], device, torch.int64),
            common.to_device(tok["attention_mask"], device), a_ids, a_atts, k=k, zs=zs,
            dtype=dtype, impl=config.get("attn_impl", "fused"))
        for qid, aid in zip(qids, topk_ids[:, 0].tolist()):
            results.append({"question_id": int(qid),
                            "answer": loader.dataset.answer_list[int(aid)]})
    return results


def make_batch(items, tokenizer, config: Config, device) -> dict:
    """A vqa_collate batch as the step's batch on `device`: questions at
    padding "max_length" (max_tokens), answers at max_length 20."""
    images, questions, answers, weights, k_index = items
    q = tokenizer(list(questions), padding="max_length", truncation=True,
                  max_length=config.get("max_tokens", 40))
    a = tokenizer(list(answers), padding="max_length", truncation=True, max_length=20)
    return {"image": common.to_device(images, device),
            "q_ids": common.to_device(q["input_ids"], device, torch.int64),
            "q_atts": common.to_device(q["attention_mask"], device),
            "a_ids": common.to_device(a["input_ids"], device, torch.int64),
            "a_atts": common.to_device(a["attention_mask"], device),
            "weights": common.to_device(weights, device),
            "k_index": common.to_device(k_index, device, torch.int64)}


def main(args: Config, config: Config) -> dict:
    """The fine-tune (efficientvlm_tpu/drivers/vqa.py:107-279): the student
    (common.load_student: a native --checkpoint as stored, a .th through
    load_torch_params, the seeded init) and the teacher (--teacher_chkpt, its stored decoder),
    the gates, --evaluate (the test split with a native checkpoint's stored
    gates, or the init gates' deterministic ones, merged by collect_result
    into vqa_result), the Lagrangian warm-up in steps, --resume, and per
    epoch: --stop_prune_epoch's freeze (forward_deterministic of the gates,
    the step rebuilt with frozen_zs once), the loop, log.txt, the epoch's
    snapshot, the full state and, from start_eval on, the evaluation merged
    into vqa_result_epoch<e>.json. Returns {"state", "epochs"} (each epoch's
    steps and seconds: loop, waiting for batches, evaluation); with
    --evaluate {"results"}."""
    info = common.setup(args, config)
    backend = common.checkpoint_backend(config)
    device = resolve_device(args.get("device"))
    out_dir = args.get("output_dir") or "output"
    seed = int(args.get("seed", 42))
    tokenizer = build_tokenizer(config.get("text_encoder", ""))
    image_res = config.get("image_res", 480)
    student, teacher = build_models(config)
    # the reference's is_eval (Eff_VQA.py:311): --evaluate or --load_vqa_pretrain
    stored = bool(args.get("evaluate") or args.get("load_vqa_pretrain"))
    sparams = common.load_student(
        student, args, lambda: student.init(0, device=device),
        lambda path: load_torch_params(student, path, stored, device=device), device=device)
    l0 = build_l0(config)
    l0_params = l0.init(2, device=device)
    test_ds = VQADataset(config["test_file"], common.eval_transform(config, image_res),
                         config.get("vqa_root", ""), config.get("vg_root", ""), split="test",
                         answer_list=config.get("answer_list", ""))
    test_loader = SimpleLoader(test_ds, batch_size=config.get("batch_size_test", 16))
    hdfs = args.get("output_hdfs", "")

    if args.get("evaluate"):
        zs = common.eval_gates(l0, l0_params, args, Config(), device=device)
        results = evaluation(student, sparams, test_loader, tokenizer, config, zs=zs)
        return {"results": collect_result(results, "vqa_result", out_dir, hdfs_wdir=hdfs,
                                          rank=info["rank"], world_size=info["world_size"])}

    dtype = common.compute_dtype(config)
    tparams = common.frozen_teacher(
        load_torch_params(teacher, args.get("teacher_chkpt"), device=device)
        or teacher.init(1, device=device), dtype)
    train_ds = VQADataset(
        config["train_file"],
        common.preprocess_transform(
            config, default=ImageTransform.train_wohflip(image_res, seed=seed)),
        config.get("vqa_root", ""), config.get("vg_root", ""), split="train", seed=seed)
    bs = int(args.get("bs") or config.get("batch_size_train", 8))
    train_loader = common.maybe_parallel_loader(SimpleLoader(
        train_ds, batch_size=bs, shuffle=True, drop_last=True, rank=info["rank"],
        world_size=info["world_size"], collate_fn=vqa_collate), config)
    epochs = int(args.get("epoch") or config.get("schedular", {}).get("epochs", 10))
    steps_per_epoch = max(len(train_loader), 1)
    l0.lagrangian_warmup = int(float(config.get("L0_schedular", {}).get(
        "lagrangian_warmup_epochs", 1)) * steps_per_epoch)
    optimizers = build_optimizers(sparams, config, epochs * steps_per_epoch)
    state = init_train_state(sparams, l0_params, optimizers)

    def make_step(frozen_zs=None):
        return common.build_train_step(build_step(
            config, student, teacher, l0, optimizers, teacher_params=tparams,
            frozen_zs=frozen_zs, temperature=float(args.get("temperature", 1.0)), dtype=dtype,
            impl=config.get("attn_impl", "fused")), config)

    step = make_step()
    state, start_epoch, resume_batches = common.resume_epochs(args, state)
    stop_prune_epoch = args.get("stop_prune_epoch")
    start_eval = int(config.get("start_eval", 0))
    frozen_zs, epochs_run = None, []
    prof = common.StepProfiler(config, out_dir)
    for epoch in range(start_epoch, epochs):
        if (stop_prune_epoch is not None and epoch >= int(stop_prune_epoch)
                and frozen_zs is None):
            # stop_prune (Eff_VQA.py:375-378): the rest of the fine-tune sees
            # the network the export will keep
            frozen_zs = l0.forward_deterministic({"loga": state.loga})
            step = make_step(frozen_zs)
            print(f"### stop_prune at epoch {epoch}: gates frozen deterministic")
        state, logger, record = common.train_epoch(
            train_loader, step, state, lambda items: make_batch(items, tokenizer, config, device),
            prof, epoch=epoch, seed=seed, device=device, output_dir=out_dir, backend=backend,
            resume_batches=resume_batches if epoch == start_epoch else 0, batch_size=bs)
        common.log_stats({"epoch": epoch, **common.train_stats(logger)}, out_dir)
        common.save_training_state(out_dir, epoch, {
            "model": state.params, "l0": {"loga": state.loga, **state.lam}, "epoch": epoch})
        common.save_full_state(out_dir, state, {"epoch": epoch}, backend=backend)
        if epoch >= start_eval:
            zs = (frozen_zs if frozen_zs is not None
                  else l0.forward_deterministic({"loga": state.loga}))
            t0 = time.perf_counter()
            results = evaluation(student, state.params, test_loader, tokenizer, config, zs=zs)
            record["eval_s"] = time.perf_counter() - t0
            merged = collect_result(results, f"vqa_result_epoch{epoch}", out_dir,
                                    hdfs_wdir=hdfs, rank=info["rank"],
                                    world_size=info["world_size"], save_result=True)
            common.log_stats({"epoch": epoch, "eval_result_file": str(merged)}, out_dir)
        epochs_run.append(record)
    return {"state": state, "epochs": epochs_run}
