"""Data-parallel certification worker (port of efficientvlm_tpu/parallel/
multihost_check.py).

Runs the full retrieval pruning train step (the student with stochastic L0
gates, the frozen teacher, KD, ITC over the world batch, ITM, the
Lagrangian and three AdamWs) through drivers/common.build_train_step, in
each of N processes launched under torchrun's contract (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT), on one deterministic world batch per
step of which each rank takes its rows. It dumps the final params, log-alphas
and λs, each step's metrics and the step-1 gradients as the update saw them
(after the all-reduce) to an .npz, so that the ranks can be held to each
other (bit-equal) and to a run over fewer processes on the same world
batches (the reference's DDP contract, apex_ddp_accelerator.py:79-89, and
its world-batch AllGather, models/xvlm.py:55-75).

So that a run over N ranks computes the same function as one over 1, the
randomness is pinned alike on every rank: the concrete noise of each step is
drawn from a seed shared by the ranks (steps pass it as `noise`), the hard
negatives are each rank's rows paired (i <-> i xor 1, a derangement within
any even shard), and dropout is 0.

  torchrun --nproc_per_node 2 -m efficientvlm_tpu_torch.parallel.multihost_check \\
      --width tiny --device cpu --backend gloo --steps 3 --out /tmp/dp.npz

writes /tmp/dp.rank<r>.npz. --width full runs the shipped
configs/x-vlm-small-ft/Retrieval_coco.yaml (6L / 6L student, 12L / 12L
teacher, CLIP-ViT-B/16 at 384 px, 40 tokens) at --world-batch 24 in bf16
on the card; tiny runs JAX's tiny towers in f32. --init FILE starts from a
native file (train/checkpoint.save_pytree) holding {"student", "teacher",
"l0"} in place of the seeded init.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FULL_YAML = "configs/x-vlm-small-ft/Retrieval_coco.yaml"
TOKENS = {"tiny": 8, "full": 40}


def tiny_config():
    """JAX's tiny towers (vision 64 wide, 2 layers, 32 px / patch 8; text
    64 wide, 4 layers, vocab 128; dropout 0), the same for the teacher, and
    its optimizers' settings."""
    from ..config import Config, TextConfig, VisionConfig

    vcfg = VisionConfig.create(vision_width=64, num_attention_heads=4, intermediate_size=128,
                               num_hidden_layers=2, image_res=32, patch_size=8)
    tcfg = TextConfig.create(vocab_size=128, hidden_size=64, num_hidden_layers=4,
                             num_attention_heads=4, intermediate_size=128, encoder_width=64,
                             max_position_embeddings=32, hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)
    return Config({"embed_dim": 32, "image_res": 32, "vision": vcfg, "text": tcfg,
                   "teacher_vision": vcfg, "teacher_text": tcfg, "sparsity": 0.25,
                   "optimizer": {"lr": 1e-3, "reg_learning_rate": 0.01, "weight_decay": 0.01},
                   "schedular": {"num_warmup_steps": 0}})


def full_config():
    """The shipped Retrieval_coco.yaml with its towers, dropout 0."""
    from ..config import Config, TextConfig, load_task_config

    config = load_task_config(os.path.join(REPO_ROOT, FULL_YAML), repo_root=REPO_ROOT)
    config["text"] = TextConfig(Config(config["text"], hidden_dropout_prob=0.0,
                                       attention_probs_dropout_prob=0.0))
    return config


def pin_negatives(model) -> None:
    """Each row's hard negative is its pair's (i xor 1) in this rank's batch,
    for the image and the text alike."""

    def pick(generator, image_feat, text_feat, *, idx=None, temp):
        pair = torch.arange(image_feat.shape[0], device=image_feat.device) ^ 1
        return pair, pair

    model.sample_hard_negatives = pick


def world_batch(step: int, size: int, width: str, vocab: int, res: int) -> dict:
    """The deterministic world batch of `step` (every rank derives the same
    arrays and takes its rows): images in [0, 1), token ids with [CLS]
    first and padded tails, one image id per pair."""
    rs = np.random.RandomState(1000 + step)
    t = TOKENS[width]
    ids = rs.randint(4, vocab, (size, t)).astype(np.int64)
    ids[:, 0] = 1 if width == "tiny" else 101
    lens = rs.randint(t // 2, t + 1, size)
    lens[0] = t
    atts = (np.arange(t)[None] < lens[:, None]).astype(np.int64)
    return {"image": rs.rand(size, res, res, 3).astype(np.float32),
            "text_ids": ids * atts, "text_atts": atts, "idx": np.arange(size)}


def step_noise(step: int, groups: dict) -> dict:
    """The concrete noise of `step`, shared by the ranks."""
    rs = np.random.RandomState(2000 + step)
    return {k: rs.uniform(1e-6, 1 - 1e-6, g["shape"]).astype(np.float32)
            for k, g in groups.items()}


def launch_counts() -> dict:
    """The kernel wrappers' launch counts (the probs forms apart) and the
    probs forms' calls by the core that served them."""
    from ..kernels.bindings import fused_ffn, probs_routes
    from ..ops import flash_attention as FA
    from ..ops import fused_mha as F
    from ..ops.patch_embed import fused_patch_embed

    return {"patch_embed": fused_patch_embed.launches,
            "fused_self_attention": F.fused_self_attention.launches,
            "fused_cross_attention": F.fused_cross_attention.launches,
            "fused_cross_attention_grouped": F.fused_cross_attention_grouped.launches,
            "flash_attention": FA.flash_attention.launches,
            "flash_attention_grouped": FA.flash_attention_grouped.launches,
            "fused_self_attention_probs": F.fused_self_attention.probs_launches,
            "fused_cross_attention_probs": F.fused_cross_attention.probs_launches,
            "fused_cross_attention_bank": F.fused_cross_attention_bank.launches,
            "fused_ffn": fused_ffn.launches,
            **{f"route_{r}": n for r, n in probs_routes.items()}}


def _flat(tree, prefix: str) -> dict:
    from ..train.optim import tree_leaves_with_path

    # a copy: a CPU f32 tensor's numpy() shares the memory the optimizers update
    return {prefix + "/".join(str(p) for p in path): t.detach().float().cpu().numpy().copy()
            for path, t in tree_leaves_with_path(tree)}


def run(*, width: str = "tiny", steps: int = 3, world_batch_size: int = 4, device=None,
        backend=None, init: str = "", out: str = "") -> dict:
    """The certification run of this process; returns the dump's dict."""
    from ..device import resolve_device
    from ..drivers import common
    from ..drivers.retrieval import build_l0, build_models
    from ..train import checkpoint as ckpt_io
    from ..train.steps import init_train_state, make_retrieval_train_step
    from ..utils import dist as D

    info = D.init_distributed_mode(device=device, backend=backend)
    rank, world = info["rank"], info["world_size"]
    device = resolve_device(device)
    if world_batch_size % (2 * world):
        raise ValueError(f"--world-batch {world_batch_size} must split into even shards over "
                         f"{world} ranks")
    config = tiny_config() if width == "tiny" else full_config()
    student, teacher = build_models(config)
    for m in (student, teacher):
        pin_negatives(m)
    l0 = build_l0(config)
    l0.lagrangian_warmup = 10
    if init:
        start = ckpt_io.place(ckpt_io.load_pytree(init), device)
        sparams, tparams, l0_params = start["student"], start["teacher"], start["l0"]
    else:
        sparams, tparams = student.init(0, device=device), teacher.init(1, device=device)
        l0_params = l0.init(2, device=device)
    dtype = torch.bfloat16 if device.type == "cuda" else None
    impl = "fused" if device.type == "cuda" else "plain"
    optimizers = common.build_optimizers(sparams, config, 1000)
    state = init_train_state(sparams, l0_params, optimizers)
    step = common.build_train_step(make_retrieval_train_step(
        student, teacher, l0, optimizers, teacher_params=common.frozen_teacher(tparams, dtype),
        dtype=dtype, impl=impl), config)
    if step.data_parallel is not None:
        step.data_parallel.record = True  # the report reads each all-reduce's bytes and time

    first_grads = []
    apply = step.apply

    def recording_apply(st, grads):
        if not first_grads:
            first_grads.append([[None if g is None else g.detach().float().cpu() for g in group]
                                for group in grads])
        return apply(st, grads)

    step.apply = recording_apply
    local = world_batch_size // world
    rows = slice(rank * local, (rank + 1) * local)
    vcfg = config["vision"]
    metrics, step_ms = [], []
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    before = launch_counts()
    for t in range(steps):
        gb = world_batch(t, world_batch_size, width, config["text"]["vocab_size"],
                         vcfg["image_res"])
        batch = {k: torch.from_numpy(v[rows]).to(device) for k, v in gb.items()}
        if dtype is not None:
            batch["image"] = batch["image"].to(dtype)
        noise = {k: torch.from_numpy(v).to(device) for k, v in step_noise(t, l0.groups).items()}
        t0 = time.perf_counter()
        m = step(state, batch, common.step_generator(7, 0, t, device), noise=noise)
        if device.type == "cuda":
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    sync = step.data_parallel
    report = {"rank": rank, "world": world, "backend": D.dist.get_backend()
              if D.is_initialized() else None, "width": width, "local_batch": local,
              "step_ms": step_ms, "launches": launches,
              "allreduce_ms": sync.call_ms() if sync is not None else [],
              "allreduce_bytes": [b for b, _ in sync.calls] if sync is not None else [],
              "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                           if device.type == "cuda" else None)}
    dump = {**_flat(state.params, "params/"), **_flat(state.loga, "loga/"),
            **_flat(state.lam, "lam/")}
    for name, group in zip(("params", "loga", "lam"), first_grads[0]):
        for j, g in enumerate(group):
            if g is not None:
                dump[f"grad1/{name}/{j}"] = g.numpy()
    for k in metrics[0]:
        dump[f"metric/{k}"] = np.asarray([m_[k] for m_ in metrics])
    dump["report"] = np.asarray(json.dumps(report))
    if out:
        np.savez(out.replace(".npz", f".rank{rank}.npz") if D.is_initialized() else out,
                 **dump)
    print(f"multihost_check rank={rank}/{world} backend={report['backend']} width={width} "
          f"steps={steps} loss={metrics[-1]['loss']:.6f}", flush=True, force=True)
    D.destroy()
    return dump


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", default="tiny", choices=["tiny", "full"])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--world-batch", type=int, default=None,
                    help="rows a step over all ranks (default 4 tiny, 24 full)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--backend", default=None, help="nccl or gloo (default: nccl on the "
                                                    "card, gloo on the CPU)")
    ap.add_argument("--init", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    wb = args.world_batch or (4 if args.width == "tiny" else 24)
    run(width=args.width, steps=args.steps, world_batch_size=wb, device=args.device,
        backend=args.backend, init=args.init, out=args.out)


if __name__ == "__main__":
    main()
