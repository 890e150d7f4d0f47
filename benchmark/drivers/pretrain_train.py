"""Window driver: X-VLM-base pretraining with its Swin-B tower, the steps
that drivers/gd.main builds for a "pretrain" task with use_swin, run by
its loop body drivers/gd.train_steps over in-memory streams.

Set-up: the model's params from the seed (layout below), the AdamW of
build_optimizers over the configuration's schedule read at the traffic's
start_step (past the warm-up; the moments start from zero), the general
step (gd.build_step: the device preprocessing at pretraining's crop scale,
then PretrainTrainStep) and the region step, as main builds them; a pool of
`pool` batches of each kind made on the card:
- image-text: B uint8 images at the shipped resolution (the host's uint8
  transform: image_res x 1.15), captions of the traffic's lengths padded to
  the batch's longest, MLM masks (masks_of);
- region: max_images f32 images as the host's box transform ships them
  and B texts over them (region_batch): whole-image captions (is_image 1,
  image_atts all on, box the whole image) and region phrases whose boxes
  cover 1-49 of the 7 x 7 region patches, image_atts on those patches.
Then the first checked_steps steps through train_steps: they warm every
shape and are the ones checked.

The process keeps one intra-op CPU thread (torch.set_num_threads(1)), as
torchrun starts each rank of the data-parallel job the configuration
stands for (OMP_NUM_THREADS=1).

Window: train_steps over the pools, cycled, step after step from the one
after the checked steps until --seconds have passed; each step is a region
step or not by gd.is_region_step(RNG_SEED, step, iter_perc), and draws
from step_generator(RNG_SEED, 0, step): the configuration's seed, so the
mix of steps is the same in every run and --seed moves the data and the
weights. A traced run then runs profile_steps more steps on the device's
trace alone and as many under the full profiler with the program's spans
annotated.

After the window: the peak memory, the program freed, and the reference
(reference/xvlm_pretrain.py, f32, TF32 off) following the checked steps
from the same weights, inputs and generator states, compared by `compare`.
"""

from __future__ import annotations

import itertools
import sys
import time

from benchmark.drivers.retrieval_eval import port_config
from benchmark.drivers.retrieval_train import NoProfiler, offset_schedule

B1 = 0.9  # AdamW's first-moment decay: after one step mu = (1 - B1) * g
MASK_ID = 103  # BERT's [MASK]


# --------------------------------------------------------------------------
# weights
# --------------------------------------------------------------------------


def swin_layout(vcfg: dict) -> dict:
    """The Swin tower's tree of (kind, shape, std) leaves, at benchmark/
    params.py's scales; the relative-position tables at the embeddings'."""
    from benchmark import params as P

    p, e, w = vcfg["patch_size"], vcfg["embed_dim"], vcfg["window_size"]
    out = {"patch_embed": {"kernel": ("w", (p, p, 3, e), (p * p * 3) ** -0.5),
                           "bias": ("b", (e,), 0.1)},
           "patch_norm": P._ln(e), "stages": []}
    c = e
    for si, (depth, heads) in enumerate(zip(vcfg["depths"], vcfg["num_heads"])):
        hidden = int(c * vcfg["mlp_ratio"])
        stage = {"blocks": [{"ln1": P._ln(c), "qkv": P._dense(c, 3 * c), "proj": P._dense(c, c),
                             "rel_bias": ("e", ((2 * w - 1) ** 2, heads), 0.5),
                             "ln2": P._ln(c), "fc1": P._dense(c, hidden),
                             "fc2": P._dense(hidden, c)} for _ in range(depth)]}
        if si < len(vcfg["depths"]) - 1:
            stage["downsample"] = {"reduction": P._dense(4 * c, 2 * c, bias=False),
                                   "norm": P._ln(4 * c)}
            c *= 2
        out["stages"].append(stage)
    out["norm"] = P._ln(c)
    return out


def layout(cfg: dict) -> dict:
    """X-VLM-base's tree: the Swin tower, the text tower with its MLM head,
    the projections, temp and the ITM and bbox heads."""
    from benchmark import params as P

    v = cfg["vision"]
    stub = dict(cfg, vision={"vision_width": v["vision_width"], "patch_size": v["image_res"],
                             "image_res": v["image_res"], "intermediate_size": 1,
                             "num_hidden_layers": 0})
    out = P.xvlm_layout(stub, mlm_head=True, bbox_head=True)
    out["vision"] = swin_layout(v)
    return out


def rel_paths(cfg: dict) -> list:
    """The indices, in tree order, of the relative-position tables."""
    from benchmark import params as P

    return [i for i, (path, _) in enumerate(P._leaves(layout(cfg))) if path[-1] == "rel_bias"]


# --------------------------------------------------------------------------
# traffic
# --------------------------------------------------------------------------


def masks_of(ids, lens, cfg: dict, g):
    """(text_ids_masked, masked_pos, masked_ids) of captions ids [n, T] of
    lengths lens: min(max_masks, max(1, round((len - 1) * mask_prob)))
    distinct word positions (not [CLS], not [SEP]) drawn from g, each 80%
    [MASK], 10% a random word, 10% kept; masked_pos 0 and masked_ids -100
    in the unused slots."""
    import torch

    from benchmark import captions

    n, t = ids.shape
    m = int(cfg["max_masks"])
    dev = ids.device
    want = torch.clamp(torch.round((lens - 1).float() * float(cfg["mask_prob"])), min=1,
                       max=m).long()
    pos = torch.arange(t, device=dev)[None]
    score = torch.rand((n, t), generator=g, device=dev)
    score = torch.where((pos >= 1) & (pos < lens[:, None] - 1), score, -1.0)
    picked = score.topk(m, dim=1).indices
    used = torch.arange(m, device=dev)[None] < want[:, None]
    masked_pos = torch.where(used, picked, 0)
    masked_ids = torch.where(used, ids.gather(1, picked), -100)
    u = torch.rand((n, m), generator=g, device=dev)
    rand_ids = torch.randint(captions.FIRST_WORD_ID, cfg["text"]["vocab_size"], (n, m),
                             generator=g, device=dev)
    new = torch.where(u < 0.8, MASK_ID, torch.where(u < 0.9, rand_ids, ids.gather(1, picked)))
    rows = torch.arange(n, device=dev)[:, None].expand(n, m)
    masked = ids.clone()
    masked[rows[used], picked[used]] = new[used]
    return masked, masked_pos, masked_ids


def texts(spec: dict, n: int, cfg: dict, g, device):
    from benchmark import captions

    lens = captions.lengths_in_order(spec, n, cfg["max_tokens"], g, device)
    return lens, captions.tokens(lens, int(lens.max()), cfg["text"]["vocab_size"], g, device)


def general_batch(cfg: dict, tr: dict, g, device) -> dict:
    import torch

    b, res = cfg["images"]["batch_size"], tr["shipped_res"]
    lens, (ids, atts) = texts(tr["captions"], b, cfg, g, device)
    masked, pos, mids = masks_of(ids, lens, cfg, g)
    return {"image": torch.randint(0, 256, (b, res, res, 3), generator=g, device=device,
                                   dtype=torch.uint8),
            "text_ids": ids, "text_atts": atts, "text_ids_masked": masked,
            "masked_pos": pos, "masked_ids": mids}


def region_batch(cfg: dict, tr: dict, g, device) -> dict:
    """max_images images and B texts. Each image offers max_regions rows,
    its whole-image caption and max_regions - 1 region phrases (the port's
    RegionTextDataset: the caption first, then elements up to
    max_regions), and the batch keeps B of those rows at random: B /
    max_regions of them are whole-image captions on average, here that
    mean rounded, each on its own image, and the rest region phrases drawn
    from the other slots without replacement; the rows in an order drawn
    from g. A region covers a rectangle of the region grid's patches
    (1 to all of them); its box in pixels reaches into its first and last
    patch, so the port's RegionTextDataset.get_image_attns gives the same
    patches."""
    import torch

    n_img, b = cfg["regions"]["max_images"], cfg["regions"]["batch_size"]
    res, ps = cfg["image_res"], cfg["patch_size"]
    grid = res // ps
    per = cfg["regions"]["max_regions"] - 1
    if b > n_img * (per + 1):
        raise ValueError(f"{b} texts exceed {n_img} images' {per + 1} rows each")
    whole = int(b / (per + 1) + 0.5)
    w_img = torch.randperm(n_img, generator=g, device=device)[:whole]
    slots = torch.randperm(n_img * per, generator=g, device=device)[:b - whole]
    group = torch.cat([w_img, slots // per])
    is_image = torch.cat([torch.ones(whole, dtype=torch.int32, device=device),
                          torch.zeros(b - whole, dtype=torch.int32, device=device)])
    r = b - whole
    span = torch.randint(1, grid + 1, (2, r), generator=g, device=device)  # columns, rows
    first = (torch.rand((2, r), generator=g, device=device) * (grid - span + 1)).long()
    lo = first * ps + torch.rand((2, r), generator=g, device=device) * (ps / 2)
    hi = (first + span - 1) * ps + ps / 2 + torch.rand((2, r), generator=g,
                                                       device=device) * (ps / 2)
    x, y, w, h = lo[0], lo[1], hi[0] - lo[0], hi[1] - lo[1]
    box = torch.stack([(x + w / 2) / res, (y + h / 2) / res, w / res, h / res], 1)
    cells = torch.arange(grid, device=device)
    col_in = (cells[None] >= first[0, :, None]) & (cells[None] < (first[0] + span[0])[:, None])
    row_in = (cells[None] >= first[1, :, None]) & (cells[None] < (first[1] + span[1])[:, None])
    patch = (row_in[:, :, None] & col_in[:, None, :]).reshape(r, grid * grid)
    atts = torch.cat([torch.ones((b, 1), dtype=torch.int32, device=device),
                      torch.cat([torch.ones((whole, grid * grid), dtype=torch.int32,
                                            device=device), patch.int()])], 1)
    bbox = torch.cat([torch.tensor([[0.5, 0.5, 1.0, 1.0]], device=device).expand(whole, 4),
                      box.float()])
    wl, (wids, watts) = texts(tr["captions"], whole, cfg, g, device)
    rl, (rids, ratts) = texts(tr["region_captions"], r, cfg, g, device)
    width = max(wids.shape[1], rids.shape[1])
    pad = lambda x: torch.nn.functional.pad(x, (0, width - x.shape[1]))  # noqa: E731
    lens, ids, tatts = torch.cat([wl, rl]), torch.cat([pad(wids), pad(rids)]), \
        torch.cat([pad(watts), pad(ratts)])
    masked, pos, mids = masks_of(ids, lens, cfg, g)
    order = torch.randperm(b, generator=g, device=device)
    rows = {"idx_to_group_img": group.long(), "text_ids": ids, "text_atts": tatts,
            "text_ids_masked": masked, "masked_pos": pos, "masked_ids": mids,
            "image_atts": atts, "target_bbox": bbox, "is_image": is_image}
    out = {k: v[order] for k, v in rows.items()}
    out["image"] = torch.randn((n_img, res, res, 3), generator=g, device=device)
    return out


def make_pools(ctx, cfg: dict, tr: dict, device) -> dict:
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(ctx.sub_seed("pool"))
    return {"general": [general_batch(cfg, tr, g, device) for _ in range(tr["pool"])],
            "region": [region_batch(cfg, tr, g, device) for _ in range(tr["pool"])]}


# --------------------------------------------------------------------------
# the program
# --------------------------------------------------------------------------


class Recorder:
    """A step as the loop calls it (the step inside any device
    preprocessing), recording what the check reads over the first
    `checked` steps of either kind: the batch it computed with, the
    generator's state, its metrics, the params before the first step and
    after it, the first moments of the relative-position tables after it,
    and the hard negatives the model drew."""

    def __init__(self, model, checked: int, rel: list):
        self.checked, self.rel = checked, rel
        self.calls = 0
        self.steps = []   # (region, batch, generator state, metrics as floats)
        self.negatives = []
        self.before = self.after_first = self.first_rel_mu = None
        self.model = model
        orig = model.sample_hard_negatives

        def draw(*a, **kw):
            res = orig(*a, **kw)
            if self.calls < self.checked:
                self.negatives.append(tuple(x.clone() for x in res))
            return res

        model.sample_hard_negatives = draw

    def wrap(self, step, region: bool):
        from efficientvlm_tpu_torch.train.optim import tree_leaves

        def call(state, batch, generator=None):
            if self.calls >= self.checked:
                return step(state, batch, generator)
            if self.calls == 0:
                self.before = [x.detach().clone() for x in tree_leaves(state.params)]
            gstate = generator.get_state()
            metrics = step(state, batch, generator)
            self.steps.append((region, dict(batch), gstate,
                               {k: float(v) for k, v in metrics.items()}))
            if self.calls == 0:
                self.after_first = [x.detach().clone() for x in tree_leaves(state.params)]
                self.first_rel_mu = [state.opt_state["mu"][i].clone() for i in self.rel]
            self.calls += 1
            return metrics

        return call

    def release(self) -> None:
        del self.model.sample_hard_negatives


class PretrainCell:
    """The cell's program side: set-up from the seed, the checked steps and
    the window's loop."""

    def __init__(self, ctx):
        import torch

        from efficientvlm_tpu_torch.drivers import common
        from efficientvlm_tpu_torch.drivers import gd
        from efficientvlm_tpu_torch.models.model_pretrain import XVLMForPretrain
        from efficientvlm_tpu_torch.train.steps import init_pretrain_state

        self.ctx, self.gd = ctx, gd
        self.train_steps = gd.train_steps  # a port without the loop function stops here
        # one CPU thread for torch's own ops, as torchrun starts each rank of the
        # data-parallel job: idle worker threads would contend with the host's
        # launches, which pace this step
        torch.set_num_threads(1)
        cfg, tr = self.cfg, self.tr = ctx.config, ctx.traffic
        self.device = device = torch.device(ctx.device)
        config = self.config = port_config(cfg)
        self.model = XVLMForPretrain(*common.model_configs(config), config)
        ctx.mark("import the program")
        self.start_step = int(tr["start_step"])
        self.total_steps = gd.total_steps(config)
        self.seed = int(cfg["accelerator"]["RNG_SEED"])
        self.iter_perc = float(cfg["regions"]["iter_perc"])
        dtype = common.compute_dtype(config)
        params = self.inputs()
        ctx.mark("weights")
        optimizer = common.build_optimizers(params, config, self.total_steps)[0]
        optimizer.lr = offset_schedule(optimizer.lr, self.start_step)
        self.state = init_pretrain_state(params, optimizer)
        self.state.step = self.start_step
        kw = dict(dtype=dtype, impl=config.get("attn_impl", "fused"))
        general = common.build_train_step(gd.build_step(config, self.model, optimizer, **kw),
                                          config)
        region = common.build_train_step(gd.build_step(config, self.model, optimizer,
                                                       with_bbox=True, **kw), config)
        self.rec = Recorder(self.model, int(tr["checked_steps"]), rel_paths(cfg))
        if isinstance(general, common.DevicePreprocess):
            general.step = self.rec.wrap(general.step, False)
        else:
            general = self.rec.wrap(general, False)
        self.general, self.region = general, self.rec.wrap(region, True)
        self.pools = make_pools(ctx, cfg, tr, device)
        self.streams = (itertools.cycle(self.pools["general"]),
                        itertools.cycle(self.pools["region"]))
        self.batch = cfg["images"]["batch_size"]
        ctx.mark("state, steps and batches")

    def inputs(self) -> dict:
        from benchmark import params as P

        return P.materialize(layout(self.cfg), self.ctx.sub_seed("weights"), self.device)

    def is_region(self, step: int) -> bool:
        return self.gd.is_region_step(self.seed, step, self.iter_perc)

    def loop(self, steps) -> dict:
        from efficientvlm_tpu_torch.utils.logger import MetricLogger

        return self.train_steps(steps, self.state, self.streams[0], self.streams[1],
                                   self.general, self.region, seed=self.seed,
                                   iter_perc=self.iter_perc, device=self.device,
                                   logger=MetricLogger(), prof=NoProfiler(), log_freq=10 ** 9)

    def checked_steps(self) -> None:
        first = self.start_step
        self.loop(range(first, first + int(self.tr["checked_steps"])))
        self.rec.release()

    def free_program(self) -> None:
        import torch

        self.state = self.general = self.region = self.model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, num=None, trainer=None):
        """The reference's Trainer (or `trainer`, a subclass) from the same
        weights (f32 unless `num`)."""
        from benchmark.reference import xvlm as ref
        from benchmark.reference import xvlm_pretrain as RP

        ref.exact_f32()
        return (trainer or RP.Trainer)(num or ref.F32(), self.cfg, self.inputs(),
                                       total_steps=self.total_steps, start_step=self.start_step)

    def follow(self, trainer) -> None:
        """The reference over the checked steps, from each step's batch and
        generator state, with the program's negatives."""
        import torch

        for (region, batch, gstate, _), neg in zip(self.rec.steps, self.rec.negatives):
            g = torch.Generator(device=self.device)
            g.set_state(gstate)
            trainer.step(batch, g, neg, region=region)

    def program_side(self) -> dict:
        r = self.rec
        return {"parts": [m for *_, m in r.steps], "before": r.before,
                "after_first": r.after_first,
                "first_rel_grads": [m / (1 - B1) for m in r.first_rel_mu]}


def reference_side(trainer, rel: list) -> dict:
    return {"parts": trainer.parts, "before": trainer.before,
            "after_first": trainer.after_first, "first_grads": trainer.opt.first_grads,
            "first_rel_grads": [trainer.opt.first_grads[i] for i in rel]}


# --------------------------------------------------------------------------
# the comparison
# --------------------------------------------------------------------------

TERMS = ("loss_itc", "loss_itm", "loss_mlm", "loss_bbox", "loss_giou")


def _gap(got: list, want: list) -> float:
    """|| got - want || / || want || over the tensors taken together."""
    diff = sum(float((a.float() - b.float()).square().sum()) for a, b in zip(got, want))
    norm = sum(float(b.float().square().sum()) for b in want)
    return (diff / norm) ** 0.5 if norm > 0 else float("inf")


def compare(prog: dict, ref: dict, negatives: list, steps: list) -> dict:
    """The numbers that decide `correct` (limits in benchmark/limits/
    <cell>.json):

    - loss_gap.<term>: each loss term of each checked step against the
      reference's, relative, the largest over the steps (bbox and GIoU on
      the region steps); loss_gap_total the same of their sum;
    - first_change_gap: the first update's change of all the params,
      ||change - reference change|| / ||reference change||: 0 where they
      agree, 1 for a state left unchanged;
    - rel_pos_grad_gap: the first gradient of the Swin tower's
      relative-position tables (the program's from its first moments,
      mu / (1 - b1)), || g - g_ref || / || g_ref || over the tables;
    - negatives_positive: the hard negatives the program drew that are the
      row's own pair, or rows without one (the draw the reference takes
      from the program, checked by itself); an exact count.

    For the record: the gaps of the losses that have no limit, which
    loss_gap_total holds in their sum (ITM and the box losses: bf16 moves
    them as far as fp8 does on some seeds; MLM: the planted faults move it
    past 10 x bf16's largest reading on some seeds only, PERF.md); the
    share of the first change's elements whose sign is not the
    reference's (Adam's first update is about lr times the gradient's
    sign, so first_change_gap is about 2 x its square root);
    and the median, over those elements, of the reference gradient's
    magnitude over its leaf's RMS (well under 1 where the flips are the
    smallest gradients, rounding's)."""
    import torch

    out = {}
    for term in TERMS:
        gaps = [abs(p[term] - r[term]) / abs(r[term])
                for p, r in zip(prog["parts"], ref["parts"]) if term in r]
        if gaps:
            out[f"loss_gap.{term[5:]}"] = max(gaps)
    out["loss_gap_total"] = max(abs(p["loss"] - r["loss"]) / abs(r["loss"])
                                for p, r in zip(prog["parts"], ref["parts"]))
    change = lambda side: [a - b for a, b in zip(side["after_first"], side["before"])]  # noqa
    pc, rc = change(prog), change(ref)
    out["first_change_gap"] = _gap(pc, rc)
    flips, ratios = 0, []
    for a, b, g in zip(pc, rc, ref.get("first_grads", [None] * len(rc))):
        flip = torch.sign(a) != torch.sign(b)
        flips += int(flip.sum())
        if g is not None and bool(flip.any()):
            g = g.float()
            ratios.append(g[flip].abs() / g.square().mean().sqrt().clamp(min=1e-30))
    out["first_flip_share"] = flips / sum(b.numel() for b in rc)
    if ratios:  # where the flips sit: their reference gradient against its leaf's RMS
        out["first_flip_grad_ratio"] = float(torch.cat(ratios).float().median())
    out["rel_pos_grad_gap"] = _gap(prog["first_rel_grads"], ref["first_rel_grads"])
    bad = 0
    for (neg_image, neg_text), (_, batch, _, _) in zip(negatives, steps):
        n = batch["text_ids"].shape[0]
        if neg_image.shape != (n,) or neg_text.shape != (n,):
            bad += 2 * n
            continue
        own = torch.arange(n, device=neg_image.device)
        bad += int((neg_image == own).sum()) + int((neg_text == own).sum())
    out["negatives_positive"] = float(bad)
    return out


def half_batch(trainer_cls):
    """A fault for tools/limits.py: the trainer's steps on the first half
    of each batch's texts (and, on image-text steps, of its images), with
    their own negatives."""

    class HalfBatch(trainer_cls):
        def step(self, batch, g, negatives, *, region):
            n = batch["text_ids"].shape[0] // 2
            half = {k: v if k == "image" and region else v[:n] for k, v in batch.items()}
            return super().step(half, g, None, region=region)

    return HalfBatch


def readings(ctx, side: str = "program") -> dict:
    """The comparison's numbers for one seed without the timed window, of
    `side`: the program's checked steps, "control" (the fp8 reference in
    the program's place), or a fault planted in the f32 reference in the
    program's place ("half_batch", "altered": benchmark/tools/faults.py's
    swapped ITM logits)."""
    import contextlib

    from benchmark.reference import xvlm as ref
    from benchmark.reference import xvlm_pretrain as RP
    from benchmark.tools import faults

    cell = PretrainCell(ctx)
    cell.checked_steps()
    cell.free_program()
    rel = rel_paths(cell.cfg)
    truth = cell.reference()
    cell.follow(truth)
    if side == "program":
        got = cell.program_side()
        for k, (p, r) in enumerate(zip(got["parts"], truth.parts)):
            print(f"step {k}: " + ", ".join(f"{n} {p[n]:.6g}/{r[n]:.6g}" for n in r),
                  file=sys.stderr, flush=True)
    else:
        trainer = cell.reference(ref.Fp8() if side == "control" else None,
                                 half_batch(RP.Trainer) if side == "half_batch"
                                 else None)
        with faults.altered_itm() if side == "altered" else contextlib.nullcontext():
            cell.follow(trainer)
        got = reference_side(trainer, rel)
    return compare(got, reference_side(truth, rel), cell.rec.negatives, cell.rec.steps)


def run(ctx) -> None:
    import torch

    from efficientvlm_tpu_torch.train import profiler

    from benchmark import trace as T
    from benchmark.work import swin as W

    cell = PretrainCell(ctx)
    cell.checked_steps()
    ctx.mark("checked steps (the warm-up)")
    tr = ctx.traffic
    first = cell.start_step + int(tr["checked_steps"])
    done, window, marks, profiled = [0], [None], [], []

    def steps():
        """Step indices from `first` until --seconds have passed; in a
        traced run then profile_steps more on the device's trace alone and
        as many under the full profiler, the program's spans annotated."""
        i = first
        while not done[0] or time.time() - t0 < ctx.seconds:
            yield i
            i += 1
            done[0] += 1
            marks.append(time.time())
        ctx.sync()
        window[0] = time.time() - t0
        ctx.window_closed()
        if not ctx.trace:
            return
        n = int(tr["profile_steps"])
        with ctx.device_slice():
            for _ in range(n):
                yield i
                i += 1
        with profiler.recording(annotate=True), ctx.profiled():
            for _ in range(n):
                profiled.append(cell.is_region(i))
                yield i
                i += 1

    t0 = ctx.start_window()
    cell.loop(steps())
    n, window = done[0], window[0]
    ctx.e2e["train_samples_per_s"] = n * cell.batch / window
    ctx.attempted = n * cell.batch
    if cell.device.type == "cuda":
        ctx.memory_peak = torch.cuda.max_memory_allocated()
    thirds = [sum(1 for m in marks if t0 + window * k / 3 <= m < t0 + window * (k + 1) / 3)
              for k in range(3)]
    kinds = [cell.is_region(s) for s in range(first, first + n)]
    print(f"{n} steps ({sum(kinds)} region) in {window:.3f} s; steps a third of the window "
          f"{thirds}", flush=True)

    pools = cell.pools
    cell.free_program()
    rel = rel_paths(cell.cfg)
    trainer = cell.reference()
    cell.follow(trainer)
    numbers = compare(cell.program_side(), reference_side(trainer, rel), cell.rec.negatives,
                      cell.rec.steps)
    for name, lim in ctx.limits.items():
        ctx.checks.append((name, numbers[name], float(lim["limit"])))

    cfg = cell.cfg

    def step_flops(region: bool) -> float:
        pool = pools["region" if region else "general"][0]
        images = pool["image"].shape[0]
        return W.pretrain_step_flops(cfg, texts=cell.batch, images=images,
                                     text_len=int(pool["text_ids"].shape[1]),
                                     masks=int(pool["masked_pos"].shape[1]),
                                     region=region)["total"]

    flops = {k: step_flops(k) for k in (False, True)}
    attn = {k: W.window_attention_work(cfg["vision"], cfg["regions"]["max_images"] if k
                                       else cell.batch) for k in (False, True)}
    ctx.layer.update(mfu_flops=sum(flops[k] for k in kinds), window_s=window,
                     steps_profiled=len(profiled),
                     swin_attention_work={"flops": sum(attn[k]["flops"] for k in profiled),
                                          "bytes": sum(attn[k]["bytes"] for k in profiled)})
    if ctx.trace_data is not None:
        ctx.layer["trace"] = ctx.trace_data
        ctx.layer["trace_summary"] = T.summary(ctx.trace_data)
        spans = [f"evlm.swin.stage{i}" for i in range(len(cfg["vision"]["depths"]))]
        spans += ["evlm.swin.region", "evlm.swin.attention", "evlm.step.backward",
                  "evlm.step.apply"]
        under = {n: T.device_seconds_under(ctx.trace_data, n) for n in spans}
        print(f"device s under spans in the profiled steps {under}; busy "
              f"{ctx.layer['trace_summary']['busy_s']:.6g} s", file=sys.stderr, flush=True)
    print(f"step FLOP general {flops[False]:.4g} region {flops[True]:.4g}; checks {numbers}",
          file=sys.stderr, flush=True)
