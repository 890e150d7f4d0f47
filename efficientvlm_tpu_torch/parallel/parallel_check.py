"""Certification worker of the second part of distribution: ZeRO-1, the
sharded checkpoint backend, tensor parallelism, the sequence axis, the
pipeline and expert parallelism, each run sharded over the ranks of a
torchrun launch (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT)
beside the unsharded program it must equal, on the same inputs in the same
process.

  torchrun --nproc_per_node 2 -m efficientvlm_tpu_torch.parallel.parallel_check \\
      --parts zero1,sharded,tp,sp,pipeline,ep --width tiny --device cpu --out /tmp/pc

writes <out>/<part>.rank<r>.npz per part: the arrays to compare and a JSON
"report" (times, bytes, launches). The parts:

- zero1: the retrieval pruning step (multihost_check's: pinned noise and
  negatives, dropout 0) for `steps` steps over the same world batches, data
  parallel (GradientSync) and with zero1 (parallel/zero.py) from one init:
  each one's final params, log-alphas and λs, metrics and moment bytes;
- sharded: after the ZeRO-1 steps, the sharded backend (train/sharded_io)
  saved synchronously and in the background and restored into a fresh
  whole state, and the default backend's gathered file restored into the
  sharded state; "exact" flags of every restored leaf and the next step's
  params from the restored state against the uninterrupted one's;
- tp: the same step on one rank's whole params and tensor parallel over
  all the ranks (parallel/sharding.py) from one init: metrics per step,
  the step-1 gradients (the shards gathered) and the final params;
- sp: the ViT and BERT forwards with act_partition under
  sequence_parallel against the unsharded ones;
- pipeline: a BERT layer stack pipelined over the ranks (and, above two
  ranks, over pairs of ranks) against the sequential stack, forward and the
  gradients of sum(out ** 2);
- ep: moe_ffn_ep with the experts sharded over the ranks against moe_ffn.

--width tiny runs JAX's tiny configs in f32; full runs the shipped
Retrieval_coco.yaml widths in bf16 on the kernels (the card). --init
({student, teacher, l0}) starts zero1, sharded and tp from a given init
(the CPU tests write JAX's, to hold zero1 and tp to JAX's step) and
--inputs gives sp, pipeline and ep their params and inputs (JAX's in the
CPU tests); without them each part draws its own from fixed seeds.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from . import multihost_check as M

FULL = dict(world_batch=24, tp_batch=12, steps=3, sp_batch=16, pp_batch=8, pp_layers=12,
            pp_micro=4, moe_experts=8, moe_tokens=(4, 40))
TINY = dict(world_batch=4, tp_batch=4, steps=3, sp_batch=8, pp_batch=8, pp_layers=4,
            pp_micro=4, moe_experts=4, moe_tokens=(1, 6))


def _dump(out: str, part: str, rank: int, arrays: dict, report: dict) -> None:
    if out:
        np.savez(os.path.join(out, f"{part}.rank{rank}.npz"), **arrays,
                 report=np.asarray(json.dumps(report, default=float)))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy().copy()  # a CPU f32 tensor's would share memory


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_clone(v) for v in tree]
    return tree.detach().clone() if torch.is_tensor(tree) else tree


class _Setup:
    """The retrieval pruning step's pieces for one width, from --init or
    the seeds multihost_check uses."""

    def __init__(self, width: str, device, init: str):
        from ..drivers.retrieval import build_l0, build_models
        from ..train import checkpoint as ckpt_io

        self.width, self.device = width, device
        self.config = M.tiny_config() if width == "tiny" else M.full_config()
        self.student, self.teacher = build_models(self.config)
        for m in (self.student, self.teacher):
            M.pin_negatives(m)
        self.l0 = build_l0(self.config)
        self.l0.lagrangian_warmup = 10
        if init:
            start = ckpt_io.place(ckpt_io.load_pytree(init), device)
            self.sparams, self.tparams, self.l0_params = (start["student"], start["teacher"],
                                                          start["l0"])
        else:
            self.sparams = self.student.init(0, device=device)
            self.tparams = self.teacher.init(1, device=device)
            self.l0_params = self.l0.init(2, device=device)
        self.dtype = torch.bfloat16 if device.type == "cuda" else None
        self.impl = "fused" if device.type == "cuda" else "plain"

    def state(self, params=None):
        from ..drivers import common
        from ..train.steps import init_train_state

        params = _clone(self.sparams) if params is None else params
        optimizers = common.build_optimizers(params, self.config, 1000)
        return optimizers, init_train_state(params, _clone(self.l0_params), optimizers)

    def step(self, optimizers, teacher_params=None):
        from ..drivers import common
        from ..train.steps import make_retrieval_train_step

        tp = self.tparams if teacher_params is None else teacher_params
        return make_retrieval_train_step(self.student, self.teacher, self.l0, optimizers,
                                         teacher_params=common.frozen_teacher(tp, self.dtype),
                                         dtype=self.dtype, impl=self.impl)

    def batch(self, t: int, size: int, rows: slice):
        gb = M.world_batch(t, size, self.width, self.config["text"]["vocab_size"],
                           self.config["vision"]["image_res"])
        batch = {k: torch.from_numpy(v[rows]).to(self.device) for k, v in gb.items()}
        if self.dtype is not None:
            batch["image"] = batch["image"].to(self.dtype)
        noise = {k: torch.from_numpy(v).to(self.device)
                 for k, v in M.step_noise(t, self.l0.groups).items()}
        return batch, noise

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()


def _generator(t: int, device) -> torch.Generator:
    """Step t's generator, the same on every rank (the ranks of these parts
    step as one replica, or must draw alike to equal one rank)."""
    return torch.Generator(device=device).manual_seed(7000 + t)


def _leaves(state, prefix: str = "") -> dict:
    return {**M._flat(state.params, prefix + "params/"), **M._flat(state.loga, prefix + "loga/"),
            **M._flat(state.lam, prefix + "lam/")}


def _state_exact(a, b) -> bool:
    """Every tensor of two states equal (the optimizer states included)."""
    from ..train import checkpoint as ckpt_io

    def walk(x, y):
        if isinstance(x, dict):
            return set(x) == set(y) and all(walk(x[k], y[k]) for k in x)
        if isinstance(x, (list, tuple)):
            return len(x) == len(y) and all(walk(u, v) for u, v in zip(x, y))
        if torch.is_tensor(x):
            return x.shape == y.shape and bool(torch.equal(x.cpu().float(), y.cpu().float()))
        return x == y

    return walk(ckpt_io.to_cpu(a), ckpt_io.to_cpu(b))


# ---------------------------------------------------------------------------
# ZeRO-1 and the sharded backend


def part_zero1(ctx: dict, sharded: bool) -> None:
    from ..config import Config
    from ..drivers import common
    from ..parallel import zero as Z
    from ..utils import dist as D

    s, size, rank, world = ctx["setup"], ctx["sizes"], ctx["rank"], ctx["world"]
    local = size["world_batch"] // world
    rows = slice(rank * local, (rank + 1) * local)
    arrays, report = {}, {}
    states = {}
    before = M.launch_counts()
    for mode in ("dp", "zero1"):
        optimizers, state = s.state()
        step = common.build_train_step(s.step(optimizers), Config({"zero1": mode == "zero1"}))
        ms = []
        for t in range(size["steps"]):
            batch, noise = s.batch(t, size["world_batch"], rows)
            t0 = time.perf_counter()
            m = step(state, batch, _generator(t, s.device), noise=noise)
            s.sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            for k, v in m.items():
                arrays.setdefault(f"{mode}/metric/{k}", []).append(float(v))
        arrays.update(_leaves(state, mode + "/"))
        report[f"{mode}_step_ms"] = ms
        report[f"{mode}_moment_bytes"] = Z.sharded_moment_bytes(state)
        report[f"{mode}_calls_recorded"] = len(step.data_parallel.calls)
        states[mode] = (state, step)
    zstate, zstep = states["zero1"]
    report["zero1_sharded"] = Z.is_sharded(zstate)
    report["wrappers"] = _zero1_wrappers(ctx)
    _roundtrip(ctx, zstate, report)
    if sharded:
        _sharded(ctx, zstate, zstep, arrays, report)
    report["launches"] = {k: v - before[k] for k, v in M.launch_counts().items()}
    _dump(ctx["out"], "zero1", rank, {k: np.asarray(v) for k, v in arrays.items()}, report)
    del states
    D.barrier()


def _zero1_wrappers(ctx: dict) -> dict:
    """ApplyIfFinite and MultiSteps inside ZeRO-1: a non-finite gradient in
    one rank's slice skips the update on every rank; accumulation applies
    once in two steps. Returns each case's leaf, as every rank ends it."""
    from dataclasses import dataclass

    from ..parallel import zero as Z
    from ..train.optim import AdamW, ApplyIfFinite, MultiSteps

    @dataclass
    class _State:
        params: list
        opt_state: dict

    rank, device, out = ctx["rank"], ctx["setup"].device, {}
    for name, inner in (("skip", ApplyIfFinite(AdamW(0.1, grad_clip=1.0), 1)),
                        ("accumulate", MultiSteps(AdamW(0.1, grad_clip=1.0), 2))):
        p = torch.ones(4, 6, device=device)
        opt = Z.Zero1(inner)
        state = Z.shard_moments(_State([p], opt.init([p])))
        for t in range(2):
            g = torch.full((4, 6), float(t + 1 + rank), device=device)
            if name == "skip" and t == 0 and rank == 1:
                g[3, 5] = float("nan")  # in rank 1's slice only
            opt.step([p], [g], state.opt_state)
            out[f"{name}/{t}"] = p.flatten().tolist()
    return out


def _roundtrip(ctx: dict, zstate, report: dict) -> None:
    """The default backend gathers the moments into one file from rank 0;
    it restores into a sharded template and into a whole one."""
    from ..drivers import common
    from ..parallel import zero as Z
    from ..utils import dist as D

    s = ctx["setup"]
    root = os.path.join(ctx["out"] or ".", "single")
    if ctx["rank"] == 0:
        os.makedirs(root, exist_ok=True)
    D.barrier()
    common.save_full_state(root, zstate, {"epoch": 5})
    D.barrier()
    _, whole = s.state()
    back, extra = common.restore_full_state(root, Z.shard_moments(whole))
    report["msgpack_exact"] = _state_exact(back, zstate) and int(extra["epoch"]) == 5
    _, whole = s.state()
    back, _ = common.restore_full_state(root, whole)
    report["msgpack_whole_exact"] = _state_exact(back, Z.gather_moments(zstate))


def _dir_bytes(path: str, rank: int) -> int:
    names = [f"shards.rank{rank}.pt"] + (["replicated.pt", "manifest.json"] if rank == 0 else [])
    return sum(os.path.getsize(os.path.join(path, n)) for n in names)


def _sharded(ctx: dict, zstate, zstep, arrays: dict, report: dict) -> None:
    """The sharded backend around the ZeRO-1 state (see the module note)."""
    from ..config import Config
    from ..drivers import common
    from ..utils import dist as D

    s, size, rank, world = ctx["setup"], ctx["sizes"], ctx["rank"], ctx["world"]
    root = os.path.join(ctx["out"] or ".", "ckpt")
    if rank == 0:
        os.makedirs(root, exist_ok=True)
    D.barrier()
    s.sync()
    t0 = time.perf_counter()
    common.save_full_state(root, zstate, {"epoch": np.int64(3), "note": "sync"},
                           backend="orbax")
    report["sharded_save_s"] = time.perf_counter() - t0
    path = os.path.join(root, common.SHARDED_DIR)
    report["sharded_bytes"] = _dir_bytes(path, rank)
    _, template = s.state()
    t0 = time.perf_counter()
    restored, extra = common.restore_full_state(root, template)
    report["sharded_restore_s"] = time.perf_counter() - t0
    report["sharded_exact"] = _state_exact(restored, zstate)
    report["sharded_extra"] = extra
    t0 = time.perf_counter()
    common.save_full_state(root, zstate, {"epoch": 4}, backend="orbax", background=True)
    report["background_handoff_s"] = time.perf_counter() - t0
    common.wait_for_saves()
    report["background_total_s"] = time.perf_counter() - t0
    _, template = s.state()
    again, extra2 = common.restore_full_state(root, template)
    report["background_exact"] = _state_exact(again, zstate) and extra2["epoch"] == 4
    # the next step from the restored state against the uninterrupted one
    local = size["world_batch"] // world
    rows = slice(rank * local, (rank + 1) * local)
    t = size["steps"]
    batch, noise = s.batch(t, size["world_batch"], rows)
    zstep(zstate, batch, _generator(t, s.device), noise=noise)
    rstep = common.build_train_step(s.step(s.state(again.params)[0]), Config({"zero1": True}))
    rstep(again, batch, _generator(t, s.device), noise=noise)
    s.sync()
    report["next_step_exact"] = _state_exact(again, zstate)
    arrays.update(_leaves(again, "resumed/"))


# ---------------------------------------------------------------------------
# tensor parallelism


def part_tp(ctx: dict) -> None:
    from ..parallel import sharding as S
    from ..utils import dist as D

    s, size, rank = ctx["setup"], ctx["sizes"], ctx["rank"]
    rows = slice(0, size["tp_batch"])
    arrays, report = {}, {}
    for mode in ("one", "tp"):
        if mode == "one":
            optimizers, state = s.state()
            step, teacher = s.step(optimizers), None
        else:
            local = S.shard_params(_clone(s.sparams))
            optimizers, state = s.state(local)
            step = S.TensorParallelStep(s.step(optimizers, S.shard_params(s.tparams)), local)
        grads1 = []
        inner = step.step if mode == "tp" else step
        apply = inner.apply

        def recording(st, grads, apply=apply, grads1=grads1):
            if not grads1:
                grads1.append([[None if g is None else g.detach().clone() for g in group_]
                               for group_ in grads])
            return apply(st, grads)

        inner.apply = recording
        before = M.launch_counts()
        ms = []
        for t in range(size["steps"]):
            batch, noise = s.batch(t, size["tp_batch"], rows)
            t0 = time.perf_counter()
            m = step(state, batch, _generator(t, s.device), noise=noise)
            s.sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            for k, v in m.items():
                arrays.setdefault(f"{mode}/metric/{k}", []).append(float(v))
            if t == 0:
                arrays.update(M._flat(state.params if mode == "one" else
                                    S.gather_params(state.params), f"{mode}/step1/params/"))
                arrays.update(_first_moments(state, mode == "tp", f"{mode}/mu1/"))
        report[f"{mode}_launches"] = {k: v - before[k] for k, v in M.launch_counts().items()}
        report[f"{mode}_step_ms"] = ms
        params = state.params if mode == "one" else S.gather_params(state.params)
        grads = grads1[0]
        if mode == "tp":
            specs = [S.spec_for(p, t) for p, t in _paths(state.params)]
            grads[0] = [g if d is None or g is None else D.gather_dim(g, d)
                        for g, d in zip(grads[0], specs)]
        arrays.update(M._flat(params, f"{mode}/params/"))
        arrays.update(M._flat(state.loga, f"{mode}/loga/"))
        arrays.update(M._flat(state.lam, f"{mode}/lam/"))
        for name, gs in zip(("params", "loga", "lam"), grads):
            for j, g in enumerate(gs):
                if g is not None:
                    arrays[f"{mode}/grad1/{name}/{j}"] = _np(g)
        del step, state, optimizers
        if s.device.type == "cuda":
            torch.cuda.empty_cache()
    _dump(ctx["out"], "tp", rank, {k: np.asarray(v) for k, v in arrays.items()}, report)
    D.barrier()


def _first_moments(state, tp: bool, prefix: str) -> dict:
    """The three optimizers' first moments, keyed as the leaves they belong
    to (<prefix><group>/<path>); a tp state's sharded ones gathered."""
    from ..parallel import sharding as S
    from ..train.optim import path_str, tree_leaves_with_path
    from ..utils import dist as D

    out = {}
    for group, tree, opt_state in (("params", state.params, state.opt_state),
                                   ("loga", state.loga, state.l0_state),
                                   ("lam", state.lam, state.lam_state)):
        while "mu" not in opt_state:  # ApplyIfFinite / MultiSteps
            opt_state = opt_state["inner"]
        for (p, t), mu in zip(tree_leaves_with_path(tree), opt_state["mu"]):
            d = S.spec_for(path_str(p), t) if tp else None
            out[prefix + group + "/" + "/".join(map(str, p))] = _np(
                mu if d is None else D.gather_dim(mu, d))
    return out


def _paths(tree):
    from ..train.optim import path_str, tree_leaves_with_path

    return [(path_str(p), t) for p, t in tree_leaves_with_path(tree)]


def part_vocab(ctx: dict) -> None:
    """A vocab-parallel embedding and MLM loss (the BERT embeddings and the
    MLM head over vocab shards) against the unsharded ones: the loss and
    the gradients of the word table and the decoder."""
    from ..config import TextConfig
    from ..models import bert as B
    from ..parallel import sharding as S
    from ..utils import dist as D

    rank, device = ctx["rank"], ctx["setup"].device
    tiny = ctx["setup"].width == "tiny"
    cfg = TextConfig.create(vocab_size=128 if tiny else 30522, hidden_size=64 if tiny else 768,
                            num_hidden_layers=1, num_attention_heads=4 if tiny else 12,
                            intermediate_size=128 if tiny else 3072,
                            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    gen = torch.Generator(device=device).manual_seed(5)
    params = B.init_bert(gen, cfg, with_mlm_head=True, device=device)
    b, t = (4, 12) if tiny else (16, 40)
    ids = torch.randint(1, cfg["vocab_size"], (b, t), generator=gen, device=device)
    labels = torch.where(torch.rand(b, t, generator=gen, device=device) < 0.3, ids, -100)

    def loss_of(p):
        h = B.bert_embeddings(p["embeddings"], ids, cfg)
        logits = B.mlm_head_apply(p["cls"], h, cfg)
        return B.mlm_cross_entropy(logits, labels)

    def grads(p, loss):
        leaves = [p["embeddings"]["word"]["embedding"], p["cls"]["decoder"]["kernel"],
                  p["cls"]["transform"]["dense"]["kernel"]]
        return torch.autograd.grad(loss, leaves)

    full = _clone(params)
    for t_ in (full["embeddings"]["word"]["embedding"], full["cls"]["decoder"]["kernel"],
               full["cls"]["transform"]["dense"]["kernel"]):
        t_.requires_grad_(True)
    ref = loss_of(full)
    ref_g = grads(full, ref)
    local = S.shard_params(_clone(params))
    for t_ in (local["embeddings"]["word"]["embedding"], local["cls"]["decoder"]["kernel"],
               local["cls"]["transform"]["dense"]["kernel"]):
        t_.requires_grad_(True)
    with S.tensor_parallel():
        got = loss_of(local)
        g = grads(local, got)
    gw, gd = D.gather_dim(g[0], 0), D.gather_dim(g[1], 1)
    arrays = {"ref_loss": _np(ref), "loss": _np(got), "ref_word": _np(ref_g[0]),
              "word": _np(gw), "ref_decoder": _np(ref_g[1]), "decoder": _np(gd),
              "ref_dense": _np(ref_g[2]), "dense": _np(g[2])}
    _dump(ctx["out"], "vocab", rank, arrays, {})


# ---------------------------------------------------------------------------
# the sequence axis, the pipeline, expert parallelism


def _inputs(ctx: dict) -> dict:
    if "inputs" not in ctx:
        from ..train import checkpoint as ckpt_io

        path = ctx.get("inputs_path")
        ctx["inputs"] = ckpt_io.place(ckpt_io.load_pytree(path), ctx["setup"].device) \
            if path else {}
    return ctx["inputs"]


def part_sp(ctx: dict) -> None:
    from ..config import TextConfig, VisionConfig
    from ..models import bert as B
    from ..models import vit as V
    from ..parallel import sharding as S

    s, size, rank = ctx["setup"], ctx["sizes"], ctx["rank"]
    inp, device, dtype, impl = _inputs(ctx), s.device, s.dtype, s.impl
    if s.width == "tiny":
        vkw = dict(vision_width=64, num_attention_heads=4, intermediate_size=96,
                   num_hidden_layers=2, image_res=32, patch_size=8)
        tkw = dict(vocab_size=60, hidden_size=64, num_hidden_layers=4, fusion_layer=2,
                   num_attention_heads=4, intermediate_size=96, encoder_width=64,
                   max_position_embeddings=32, hidden_dropout_prob=0.0,
                   attention_probs_dropout_prob=0.0)
        vcfg, tcfg = VisionConfig.create(**vkw), TextConfig.create(**tkw)
    else:
        vcfg, tcfg = s.student.vision_cfg, s.student.text_cfg
    vsp = VisionConfig({**vcfg, "act_partition": ["data", "seq"]})
    tsp = TextConfig({**tcfg, "act_partition": ["data", "seq"]})
    gen = torch.Generator(device=device).manual_seed(11)
    if "vit" in inp:
        vp, images = inp["vit"], inp["images"]
        bp, ids, atts, enc, enc_atts = (inp[k] for k in ("bert", "ids", "atts", "enc",
                                                         "enc_atts"))
    else:
        vp = V.init_vit(gen, vcfg, device=device)
        b, r = size["sp_batch"], vcfg["image_res"]
        images = torch.rand(b, r, r, 3, generator=gen, device=device)
        bp = B.init_bert(gen, tcfg, device=device)
        t = 16 if s.width == "tiny" else 40
        ids = torch.randint(1, tcfg["vocab_size"], (b, t), generator=gen, device=device)
        atts = torch.ones(b, t, dtype=torch.long, device=device)
        atts[::2, t // 2 + 5:] = 0
        enc = torch.randn(b, vcfg.num_patches + 1, tcfg["encoder_width"], generator=gen,
                          device=device) * 0.5
        enc_atts = torch.ones(enc.shape[:2], dtype=torch.long, device=device)
    if dtype is not None:
        images, enc = images.to(dtype), enc.to(dtype)
    kw = dict(dtype=dtype, impl=impl)
    bkw = dict(attention_mask=atts, encoder_hidden=enc, encoder_attention_mask=enc_atts, **kw)
    report = {}
    with torch.no_grad():
        ref_v = V.vit_apply(vp, images, vcfg, **kw)["last_hidden"]
        ref_t = B.bert_apply(bp, ids, tcfg, **bkw)["last_hidden"]
        s.sync()
        before = M.launch_counts()
        t0 = time.perf_counter()
        with S.sequence_parallel():
            got_v = V.vit_apply(vp, images, vsp, **kw)["last_hidden"]
            got_t = B.bert_apply(bp, ids, tsp, **bkw)["last_hidden"]
        s.sync()
        report["sp_ms"] = (time.perf_counter() - t0) * 1e3
        report["launches"] = {k: v - before[k] for k, v in M.launch_counts().items()}
    _dump(ctx["out"], "sp", rank, {"ref_vit": _np(ref_v), "vit": _np(got_v),
                                   "ref_bert": _np(ref_t), "bert": _np(got_t)}, report)


def _pp_config(width: str, layers: int):
    from ..config import TextConfig

    if width == "tiny":
        return TextConfig.create(vocab_size=64, hidden_size=64, num_hidden_layers=layers,
                                 num_attention_heads=4, intermediate_size=128, encoder_width=64,
                                 fusion_layer=layers, max_position_embeddings=16,
                                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    return TextConfig.create(num_hidden_layers=layers, fusion_layer=layers,
                             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def part_pipeline(ctx: dict) -> None:
    from ..models.bert import bert_layer_apply, init_bert_layer
    from ..parallel import pipeline as P
    from ..utils import dist as D

    s, size, rank, world = ctx["setup"], ctx["sizes"], ctx["rank"], ctx["world"]
    inp, device, dtype, impl = _inputs(ctx), s.device, s.dtype, s.impl
    cfg = _pp_config(s.width, size["pp_layers"])
    if "layers" in inp:
        layers, x, bias = inp["layers"], inp["x"], inp["bias"]
    else:
        gen = torch.Generator(device=device).manual_seed(13)
        layers = [init_bert_layer(gen, cfg, i, device=device) for i in range(size["pp_layers"])]
        x = torch.randn(size["pp_batch"], 40, cfg["hidden_size"], generator=gen, device=device)
        mask = torch.ones(size["pp_batch"], 40, device=device)
        mask[:, -7:] = 0
        bias = (1.0 - mask[:, None, None, :]) * -1e9

    def layer_fn(lp, h, aux):
        return bert_layer_apply(lp, h, cfg, bias=aux, dtype=dtype, impl=impl)[0]

    def sequential(stacked):
        h = x
        for i in range(size["pp_layers"]):
            h = layer_fn(P.layer_at(stacked, i), h, bias)
        return h

    def grads_of(fn):
        stacked = P.stack_layers(layers)
        leaves = [t.requires_grad_(True) for _, t in _paths(stacked)]
        out = fn(stacked)
        g = torch.autograd.grad(out.float().square().sum(), leaves)
        return out, g

    arrays, report = {}, {}
    ref, ref_g = grads_of(sequential)
    arrays["ref_out"] = _np(ref)
    for j, g in enumerate(ref_g):
        arrays[f"ref_grad/{j}"] = _np(g)
    if world > 2:  # as many stages as layers, and two stages on each pair of ranks
        pairs = [D.dist.new_group([r, r + 1]) for r in range(0, world, 2)]
        pair = pairs[rank // 2]
        cases = [("all", None, 2), ("pairs", pair, size["pp_micro"]), ("pairs_m1", pair, 1)]
    else:
        cases = [("all", None, size["pp_micro"]), ("all_m1", None, 1)]
    before = M.launch_counts()
    for name, group, n_micro in cases:
        s.sync()
        t0 = time.perf_counter()
        out, g = grads_of(lambda st: P.pipelined_stack_forward(layer_fn, st, x, bias,
                                                               n_micro=n_micro, group=group))
        s.sync()
        report[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
        arrays[f"{name}/out"] = _np(out)
        for j, gj in enumerate(g):
            arrays[f"{name}/grad/{j}"] = _np(gj)
    report["launches"] = {k: v - before[k] for k, v in M.launch_counts().items()}
    _dump(ctx["out"], "pipeline", rank, arrays, report)
    D.barrier()


def part_ep(ctx: dict) -> None:
    from ..ops import moe as MOE
    from ..utils import dist as D

    s, size, rank, world = ctx["setup"], ctx["sizes"], ctx["rank"], ctx["world"]
    inp, device = _inputs(ctx), s.device
    if "moe" in inp:
        params, h = inp["moe"], inp["h"]
        capacities = [float(c) for c in inp["capacity"]]
    else:
        gen = torch.Generator(device=device).manual_seed(17)
        params = MOE.init_moe_ffn(gen, hidden=768, ffn=3072, num_experts=size["moe_experts"],
                                  device=device)
        for k in ("bi", "bo"):
            params[k] = torch.randn(params[k].shape, generator=gen, device=device) * 0.1
        b, t = size["moe_tokens"]
        h = torch.randn(b * world, t, 768, generator=gen, device=device)
        capacities = [1.25, 0.5]  # the second drops tokens
    arrays, report = {}, {}
    with torch.no_grad():
        x = h.reshape(-1, h.shape[-1])
        n = x.shape[0] // world
        local = MOE.shard_experts(params)
        for i, cf in enumerate(capacities):
            ref, ref_aux = MOE.moe_ffn(params, h, capacity_factor=cf)
            s.sync()
            t0 = time.perf_counter()
            out, aux = MOE.moe_ffn_ep(local, x[rank * n:(rank + 1) * n], capacity_factor=cf)
            s.sync()
            report[f"ep_ms/{i}"] = (time.perf_counter() - t0) * 1e3
            arrays.update({f"{i}/ref": _np(ref.reshape(-1, ref.shape[-1])),
                           f"{i}/out": _np(D.gather_dim(out, 0)), f"{i}/ref_aux": _np(ref_aux),
                           f"{i}/aux": _np(aux)})
    _dump(ctx["out"], "ep", rank, arrays, report)


PARTS = ("zero1", "sharded", "tp", "vocab", "sp", "pipeline", "ep")


def run(*, parts, width: str = "tiny", device=None, backend=None, init: str = "",
        inputs: str = "", out: str = "") -> None:
    from ..device import resolve_device
    from ..utils import dist as D

    info = D.init_distributed_mode(device=device, backend=backend)
    device = resolve_device(device)
    ctx = {"rank": info["rank"], "world": info["world_size"], "out": out,
           "sizes": TINY if width == "tiny" else FULL, "inputs_path": inputs,
           "setup": _Setup(width, device, init)}
    if out and ctx["rank"] == 0:
        os.makedirs(out, exist_ok=True)
    D.barrier()
    for part in parts:
        t0 = time.perf_counter()
        if part in ("zero1", "sharded"):
            if part == "sharded" and "zero1" in parts:
                continue
            part_zero1(ctx, sharded="sharded" in parts)
        else:
            {"tp": part_tp, "vocab": part_vocab, "sp": part_sp, "pipeline": part_pipeline,
             "ep": part_ep}[part](ctx)
        print(f"parallel_check rank={ctx['rank']}/{ctx['world']} part={part} "
              f"{time.perf_counter() - t0:.1f} s", flush=True, force=True)
    D.destroy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default=",".join(PARTS))
    ap.add_argument("--width", default="tiny", choices=["tiny", "full"])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--backend", default=None, help="nccl or gloo (default: nccl on the "
                                                    "card, gloo on the CPU)")
    ap.add_argument("--init", default="", help="{student, teacher, l0} of the step parts")
    ap.add_argument("--inputs", default="", help="params and inputs of sp / pipeline / ep")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    parts = [p for p in args.parts.split(",") if p]
    unknown = set(parts) - set(PARTS)
    if unknown:
        raise SystemExit(f"unknown parts {sorted(unknown)}; known: {', '.join(PARTS)}")
    run(parts=parts, width=args.width, device=args.device, backend=args.backend,
        init=args.init, inputs=args.inputs, out=args.out)


if __name__ == "__main__":
    main()
