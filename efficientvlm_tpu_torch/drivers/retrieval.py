"""The retrieval fine-tune (stage 2, ITR pruning with KD) and its two-stage
evaluation (port of efficientvlm_tpu/drivers/retrieval.py, the
reference's Eff_Retrieval.py): the models, the gates, evaluate and main.

main runs on the device args["device"] names (default cuda). It keeps
JAX's loop with these differences: the loader's batch is
batch_size_train (no mesh to pad to); `split_kd_step` needs no step of its
own, since the port's step already cuts the teacher's taps right after its
forward; with compute_dtype bf16 the frozen teacher is stored in bf16;
--evaluate builds no teacher; above one process the step is data parallel
(common.build_train_step; with `zero1` its optimizer state sharded over
the ranks) and the evaluation's rank-sharded score matrices are summed over
the ranks.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import Config
from ..data.datasets import RetrievalEvalDataset, RetrievalTrainDataset, SimpleLoader
from ..data.tokenizer import build_tokenizer
from ..data.transforms import ImageTransform
from ..device import resolve_device
from ..evaluation import retrieval as R
from ..models.model_retrieval import XVLMForRetrieval
from ..pruning.l0_module import L0Module, XVLML0Module
from ..train.steps import init_train_state, make_retrieval_train_step
from ..utils.dist import get_rank, get_world_size, host_group
from . import common


def build_models(config: Config):
    """(student, teacher) XVLMForRetrieval."""
    vcfg, tcfg = common.model_configs(config)
    tv, tt = common.teacher_configs(config)
    return XVLMForRetrieval(vcfg, tcfg, config), XVLMForRetrieval(tv, tt, config)


def build_l0(config: Config) -> L0Module:
    """The student's gate layout: head gates per head_gate_group heads, the
    sparsity target, the L0_schedular's init and temperature."""
    vcfg, tcfg = common.model_configs(config)
    l0_cfg = config.get("L0_schedular", Config())
    return XVLML0Module(
        vision_layers=vcfg["num_hidden_layers"], text_layers=tcfg["fusion_layer"],
        cross_layers=tcfg["num_hidden_layers"] - tcfg["fusion_layer"],
        hidden_size=tcfg["hidden_size"], intermediate_size=tcfg["intermediate_size"],
        num_heads=tcfg["num_attention_heads"], vision_hidden_size=vcfg["vision_width"],
        vision_intermediate_size=vcfg["intermediate_size"],
        vision_num_heads=vcfg["num_attention_heads"],
        droprate_init=float(l0_cfg.get("droprate_init", 0.5)),
        temperature=float(l0_cfg.get("temperature", 2.0 / 3.0)),
        target_sparsity=float(config.get("sparsity", 0.0)),
        head_group=int(config.get("head_gate_group", 1)))


def sum_over_ranks(scores: np.ndarray) -> np.ndarray:
    """A rank-sharded score matrix (this rank's rows filled, -100 elsewhere)
    summed over the ranks on the host group, as JAX's process_allgather(...)
    .sum(0) and the reference's all_reduce: every entry gains (world - 1) x
    -100, so each row's order is the filling rank's."""
    t = torch.from_numpy(np.ascontiguousarray(scores))
    torch.distributed.all_reduce(t, group=host_group())
    return t.numpy()


def evaluate(model, params, eval_loader, eval_dataset, tokenizer, config: Config, *, zs=None,
             dtype=None) -> dict:
    """The two-stage evaluation (ITC shortlist, k_test ITM rerank) and
    itm_eval's recalls, over eval_dataset's captions and eval_loader's
    images, on the params' device; above one process each rank reranks its
    share of the rows and the score matrices are summed over the ranks
    (sum_over_ranks)."""
    tok = tokenizer(eval_dataset.text, padding="max_length", truncation=True,
                    max_length=config.get("max_tokens", 40))
    ids, atts = np.asarray(tok["input_ids"], np.int64), np.asarray(tok["attention_mask"])
    impl = config.get("attn_impl", "fused")
    dtype = dtype or common.compute_dtype(config)
    text_feats, text_embeds = R.encode_texts(
        model, params, ids, atts, zs=zs, batch_size=config.get("batch_size_test_text", 64),
        dtype=dtype, impl=impl)
    image_feats, image_embeds = R.encode_images(
        model, params, (np.asarray(b[0]) for b in eval_loader), zs=zs, dtype=dtype, impl=impl)
    score_i2t, score_t2i = R.retrieval_scores(
        model, params, image_feats, image_embeds, text_feats, atts, text_embeds, zs=zs,
        k_test=config.get("k_test", 256), rank=get_rank(), world_size=get_world_size(),
        dtype=dtype, impl=impl)
    if get_world_size() > 1:
        score_i2t, score_t2i = sum_over_ranks(score_i2t), sum_over_ranks(score_t2i)
    return R.itm_eval(score_i2t, score_t2i, eval_dataset.txt2img, eval_dataset.img2txt)


def make_batch(items, tokenizer, config: Config, device) -> dict:
    """A loader batch (images, captions, image ids) as the step's batch on
    `device`: the captions tokenized at padding "longest" (ids int64)."""
    images, captions, idx = items
    tok = tokenizer(list(captions), padding="longest", truncation=True,
                    max_length=config.get("max_tokens", 40))
    return {"image": torch.from_numpy(np.asarray(images)).to(device),
            "text_ids": torch.from_numpy(np.asarray(tok["input_ids"], np.int64)).to(device),
            "text_atts": torch.from_numpy(np.asarray(tok["attention_mask"])).to(device),
            "idx": torch.from_numpy(np.asarray(idx)).to(device)}


def build_datasets(config: Config, seed: int):
    """(train, val, test) datasets: the train transform
    ImageTransform.train(image_res, seed) (or the uint8 one under
    device_preprocess), the evaluation transform for val and test."""
    image_res = config.get("image_res", 224)
    root = config.get("image_root", "")
    train = RetrievalTrainDataset(
        config["train_file"],
        common.preprocess_transform(config, default=ImageTransform.train(image_res, seed=seed)),
        root, max_words=config.get("max_tokens", 40))
    val = RetrievalEvalDataset(config["val_file"], common.eval_transform(config, image_res), root)
    test = RetrievalEvalDataset(config["test_file"], common.eval_transform(config, image_res),
                                root)
    return train, val, test


def main(args: Config, config: Config) -> dict:
    """The fine-tune: --checkpoint / --teacher_chkpt loaded through
    maybe_load_params, the gates, the Lagrangian warm-up in steps, the
    optimizers, --resume of the full state, --evaluate (the test split, with
    a native checkpoint's stored gates or none), and per epoch the train
    loop, the validation, log.txt (epoch, train_*, val_*, sparsity), the
    full state and the best snapshot. Returns {"best_epoch", "best_r_mean",
    "state", "epochs"}, "epochs" holding each epoch's steps and seconds
    (loop, waiting for batches, validation, save); with --evaluate, the
    test recalls."""
    info = common.setup(args, config)
    backend = common.checkpoint_backend(config)
    device = resolve_device(args.get("device"))
    out_dir = args.get("output_dir", "")
    seed = int(args.get("seed", 42))
    tokenizer = build_tokenizer(config.get("text_encoder", ""))
    train_ds, val_ds, test_ds = build_datasets(config, seed)
    bs = int(args.get("bs") or config.get("batch_size_train", 24))
    train_loader = common.maybe_parallel_loader(SimpleLoader(
        train_ds, batch_size=bs, shuffle=True, drop_last=True, rank=info["rank"],
        world_size=info["world_size"]), config)
    val_loader = SimpleLoader(val_ds, batch_size=config.get("batch_size_test", 24))
    test_loader = SimpleLoader(test_ds, batch_size=config.get("batch_size_test", 24))

    student, teacher = build_models(config)
    sparams = common.maybe_load_params(student, args, config,
                                       lambda: student.init(0, device=device), device=device)
    l0 = build_l0(config)
    epochs = int(args.get("epoch") or config.get("schedular", {}).get("epochs", 10))
    steps_per_epoch = max(len(train_loader), 1)
    l0.lagrangian_warmup = int(float(config.get("L0_schedular", {}).get(
        "lagrangian_warmup_epochs", 1)) * steps_per_epoch)
    optimizers = common.build_optimizers(sparams, config, epochs * steps_per_epoch)
    state = init_train_state(sparams, l0.init(2, device=device), optimizers)

    state, start_epoch, resume_batches = common.resume_epochs(args, state)

    if args.get("evaluate"):
        zs = common.eval_gates(l0, {"loga": state.loga}, args, config, device=device)
        results = evaluate(student, state.params, test_loader, test_ds, tokenizer, config, zs=zs)
        common.log_stats({"test": results}, out_dir)
        return results

    dtype = common.compute_dtype(config)
    tparams = common.frozen_teacher(common.maybe_load_params(
        teacher, Config({"checkpoint": args.get("teacher_chkpt")}), Config(),
        lambda: teacher.init(1, device=device), device=device), dtype)
    step = common.build_train_step(common.wrap_step_with_preprocess(
        make_retrieval_train_step(student, teacher, l0, optimizers, teacher_params=tparams,
                                  temperature=float(args.get("temperature", 1.0)), dtype=dtype,
                                  impl=config.get("attn_impl", "fused")), config), config)

    best, best_epoch, epochs_run = 0.0, 0, []
    prof = common.StepProfiler(config, out_dir)
    for epoch in range(start_epoch, epochs):
        state, logger, record = common.train_epoch(
            train_loader, step, state, lambda items: make_batch(items, tokenizer, config, device),
            prof, epoch=epoch, seed=seed, device=device, output_dir=out_dir, backend=backend,
            resume_batches=resume_batches if epoch == start_epoch else 0, batch_size=bs)

        zs = l0.forward_deterministic({"loga": state.loga})
        t0 = time.perf_counter()
        val_results = evaluate(student, state.params, val_loader, val_ds, tokenizer, config,
                               zs=zs)
        val_s = time.perf_counter() - t0
        stats = {"epoch": epoch, **common.train_stats(logger),
                 **{f"val_{k}": v for k, v in val_results.items()},
                 "sparsity": l0.calculate_model_size(zs)["pruned_model_sparsity"]}
        common.log_stats(stats, out_dir)
        t0 = time.perf_counter()
        common.save_full_state(out_dir, state, {"epoch": epoch}, backend=backend)
        save_s = time.perf_counter() - t0
        if val_results["r_mean"] >= best:
            best, best_epoch = val_results["r_mean"], epoch
            common.save_training_state(out_dir, "best", {
                "model": state.params, "l0": {"loga": state.loga, **state.lam}, "epoch": epoch})
        epochs_run.append(dict(record, val_s=val_s, save_s=save_s))
    common.log_stats({"best_epoch": best_epoch, "best_r_mean": best}, out_dir)
    return {"best_epoch": best_epoch, "best_r_mean": best, "state": state, "epochs": epochs_run}
