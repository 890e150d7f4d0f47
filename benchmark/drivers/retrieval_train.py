"""Window driver: the retrieval pruning fine-tune (stage 2), the step that
drivers/retrieval.main builds, run by drivers/common.run_train_epoch.

Set-up: the dense student's params (its MLM head too, as the model's init
has it), the frozen teacher in the compute dtype and the starting gate
log-alphas from the seed; the gates, the optimizers and the step as main
builds them (build_train_step(wrap_step_with_preprocess(
make_retrieval_train_step(...)))); a pool of batches made on the card
(f32 images as the host transform ships them, captions of the traffic's
lengths padded to the batch's longest, image ids drawn from the train
set's); then the first steps, through run_train_epoch as the window runs
it: they warm every shape and are the ones checked. The run sits at the
traffic's start_epoch: the state's step (the Lagrangian's schedule) and the
lr schedule's count start there, past both warm-ups, as in most steps of a
real fine-tune; the moments and multipliers start from zero.

Window: run_train_epoch over the pool, cycled, until --seconds have passed;
a traced run then runs a few more steps in the same loop on the device's
trace alone (busy and idle), and as many under the full profiler.

After the window: the peak memory, the program's state freed, and the
reference (reference/xvlm_train.py, f32) following the checked steps from
the same inputs and the same generator streams, compared by
reference/retrieval_train.compare.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from benchmark.drivers.retrieval_eval import CallRecorder, port_config


def step_seed(seed: int, epoch: int, index: int) -> int:
    """The seed of the generator of batch `index` of `epoch` in one process
    (the fine-tune loop's convention: one generator a step)."""
    return int(np.random.SeedSequence([int(seed), int(epoch), int(index)]).generate_state(
        1, np.uint64)[0])


def teacher_cfg(cfg: dict) -> dict:
    return dict(cfg, vision=cfg["teacher_vision"], text=cfg["teacher_text"])


def make_pool(ctx, cfg: dict, tr: dict, device) -> list:
    """`pool` batches on the card: images [B, R, R, 3] f32; captions of the
    traffic's lengths (benchmark/captions.py: every batch holds the B
    quantiles of the distribution in an order drawn from the seed, so every
    batch pads to the same longest), padded to the batch's longest as
    make_batch pads them; image ids from the train set's."""
    import torch

    from benchmark import captions

    g = torch.Generator(device=device)
    g.manual_seed(ctx.sub_seed("pool"))
    b, res = cfg["batch_size_train"], cfg["image_res"]
    out = []
    for _ in range(tr["pool"]):
        lens = captions.lengths_in_order(tr["captions"], b, cfg["max_tokens"], g, device)
        ids, atts = captions.tokens(lens, int(lens.max()), cfg["text"]["vocab_size"], g, device)
        out.append({"image": torch.randn((b, res, res, 3), generator=g, device=device),
                    "text_ids": ids, "text_atts": atts,
                    "idx": torch.randint(0, tr["train_images"], (b,), generator=g,
                                         device=device)})
    return out


def offset_schedule(schedule, start: int):
    """The schedule of the update count, read `start` updates on."""
    return lambda count: schedule(count + start)


class Recorder:
    """The step as the loop calls it, recording what the check reads: each
    step's loss, the optimizers' first moments after the first step (the
    first gradients as each optimizer got them) and the trees before the
    first and after the last checked step; and the hard negatives that the
    teacher and the student drew."""

    def __init__(self, step, student, teacher, checked: int):
        self.step, self.checked, self.calls = step, checked, 0
        self.losses, self.first_mu, self.before, self.after = [], None, None, None
        self.parts = []  # each checked step's metrics, as floats
        self.negatives = {"teacher": [], "student": []}
        self.models = {"teacher": teacher, "student": student}
        for who, m in self.models.items():
            orig = m.sample_hard_negatives
            m.sample_hard_negatives = self._recording(orig, self.negatives[who])

    def _recording(self, orig, out):
        def draw(*a, **kw):
            res = orig(*a, **kw)
            if self.calls < self.checked:
                out.append(tuple(x.clone() for x in res))
            return res

        return draw

    @staticmethod
    def trees(state) -> dict:
        from efficientvlm_tpu_torch.train.optim import tree_leaves

        return {"params": [x.detach().clone() for x in tree_leaves(state.params)],
                "loga": [x.detach().clone() for x in tree_leaves(state.loga)],
                "lam": [x.detach().clone() for x in tree_leaves(state.lam)]}

    def __call__(self, state, batch, generator):
        if self.calls == 0:
            self.before = self.trees(state)
        metrics = self.step(state, batch, generator)
        if self.calls < self.checked:
            self.losses.append(metrics["loss"].detach().clone())
            self.parts.append({k: float(v) for k, v in metrics.items()})
        if self.calls == 0:
            mu = lambda s: [x.clone() for x in s["mu"]]  # noqa: E731
            self.first_mu = {"params": mu(state.opt_state), "loga": mu(state.l0_state),
                             "lam": mu(state.lam_state)}
        self.calls += 1
        if self.calls == self.checked:
            self.after = self.trees(state)
        return metrics

    def release(self) -> None:
        for m in self.models.values():
            del m.sample_hard_negatives


class NoProfiler:
    """run_train_epoch's profiler hook, idle: the benchmark profiles its own
    slice."""

    def tick(self) -> None:
        pass


class TrainCell:
    """The cell's program side: set-up from the seed, the checked steps and
    the window's loop."""

    def __init__(self, ctx):
        import torch

        from efficientvlm_tpu_torch.drivers import common
        from efficientvlm_tpu_torch.drivers import retrieval as DR
        from efficientvlm_tpu_torch.train.steps import init_train_state, make_retrieval_train_step

        from benchmark import params as P

        self.ctx, self.common = ctx, common
        cfg, tr = self.cfg, self.tr = ctx.config, ctx.traffic
        self.device = device = torch.device(ctx.device)
        config = port_config(cfg)
        self.student, self.teacher = DR.build_models(config)
        l0 = DR.build_l0(config)
        ctx.mark("import the program")
        spe = int(cfg["steps_per_epoch"])
        l0.lagrangian_warmup = int(float(cfg["L0_schedular"]["lagrangian_warmup_epochs"]) * spe)
        self.total_steps = int(cfg["schedular"]["epochs"]) * spe
        self.warmup_steps = l0.lagrangian_warmup
        self.start_step = int(tr["start_epoch"]) * spe
        dtype = common.compute_dtype(config)
        params = self.inputs_student()
        tparams = common.frozen_teacher(self.inputs_teacher(), dtype)
        loga = P.init_loga(cfg, ctx.sub_seed("loga"), device)
        ctx.mark("weights")
        zero = lambda: torch.zeros((), device=device)  # noqa: E731
        optimizers = common.build_optimizers(params, config, self.total_steps)
        # start_epoch into the run: the schedules read the global step
        optimizers[0].lr = offset_schedule(optimizers[0].lr, self.start_step)
        self.state = init_train_state(params, {"loga": loga, "lambda_1": zero(),
                                               "lambda_2": zero()}, optimizers)
        self.state.step = self.start_step
        step = common.build_train_step(common.wrap_step_with_preprocess(
            make_retrieval_train_step(self.student, self.teacher, l0, optimizers,
                                      teacher_params=tparams, temperature=1.0, dtype=dtype,
                                      impl=cfg.get("attn_impl", "fused")), config), config)
        self.pool = make_pool(ctx, cfg, tr, device)
        self.rec = Recorder(step, self.student, self.teacher, tr["checked_steps"])
        self.batch = cfg["batch_size_train"]
        ctx.mark("state, step and batches")

    def inputs_student(self) -> dict:
        from benchmark import params as P

        return P.materialize(P.xvlm_layout(self.cfg, mlm_head=True),
                             self.ctx.sub_seed("weights"), self.device)

    def inputs_teacher(self) -> dict:
        from benchmark import params as P

        return P.materialize(P.xvlm_layout(teacher_cfg(self.cfg)), self.ctx.sub_seed("teacher"),
                             self.device)

    def epoch(self, batches, epoch: int) -> None:
        from efficientvlm_tpu_torch.utils.logger import MetricLogger

        self.common.run_train_epoch(batches, MetricLogger(), self.rec, self.state, lambda b: b,
                                    NoProfiler(), epoch=epoch, seed=self.ctx.seed,
                                    device=self.device, log_freq=10 ** 9)

    def checked_steps(self) -> None:
        """The first steps, as the window runs them (in epoch start_epoch)."""
        self.epoch(self.pool[:self.tr["checked_steps"]], int(self.tr["start_epoch"]))
        self.rec.release()

    def free_program(self) -> None:
        import torch

        self.state = self.rec.step = self.student = self.teacher = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, num=None, trainer=None):
        """The reference's Trainer (or `trainer`, a subclass) from the same
        inputs (f32 unless `num`)."""
        from benchmark import params as P
        from benchmark.reference import xvlm as ref
        from benchmark.reference import xvlm_train as RT

        ref.exact_f32()
        teacher = self.inputs_teacher()
        if self.cfg.get("compute_dtype", "bf16") == "bf16":  # the values the frozen teacher keeps
            teacher = RT.rounded_bf16(teacher)
        loga = P.init_loga(self.cfg, self.ctx.sub_seed("loga"), self.device)
        return (trainer or RT.Trainer)(num or ref.F32(), self.cfg, self.inputs_student(),
                                       teacher, loga, total_steps=self.total_steps,
                                       warmup_steps=self.warmup_steps,
                                       start_step=self.start_step)

    def follow(self, trainer) -> list:
        """The reference's losses over the checked steps, with each step's
        generator stream and the program's negatives."""
        import torch

        losses = []
        for s in range(self.tr["checked_steps"]):
            g = torch.Generator(device=self.device).manual_seed(
                step_seed(self.ctx.seed, int(self.tr["start_epoch"]), s))
            losses.append(trainer.step(self.pool[s], g, self.rec.negatives["teacher"][s],
                                       self.rec.negatives["student"][s]))
        return losses

    def program_side(self) -> dict:
        r = self.rec
        return {"losses": [float(x) for x in r.losses], "first_mu": r.first_mu,
                "before": r.before, "after": r.after}


def readings(ctx, side: str = "program") -> dict:
    """The comparison's numbers for one seed without the timed window, of
    `side`: the program's checked steps, "control" (the fp8 reference in
    the program's place) or a fault of tools/faults.py planted in the f32
    reference in the program's place."""
    import contextlib

    from benchmark.reference import retrieval_train as C
    from benchmark.reference import xvlm as ref
    from benchmark.tools import faults

    cell = TrainCell(ctx)
    cell.checked_steps()
    cell.free_program()
    ref_run = cell.reference()
    ref_losses = cell.follow(ref_run)
    if side == "program":
        got = cell.program_side()
    else:
        trainer = cell.reference(ref.Fp8() if side == "control" else None,
                                 faults.HalfBatch if side == "half_batch" else None)
        plant = faults.altered_itm() if side == "altered" else contextlib.nullcontext()
        with plant:
            got = C.trainer_side(trainer, cell.follow(trainer))
    if side == "program":
        for k, (p, r) in enumerate(zip(cell.rec.parts, ref_run.parts)):
            print(f"step {k}: " + ", ".join(f"{n} {p[n]:.6g}/{r[n]:.6g}" for n in r),
                  file=sys.stderr, flush=True)
        C.worst_leaves(cell.program_side(), C.trainer_side(ref_run, ref_losses), cell.cfg)
    return C.compare(got, C.trainer_side(ref_run, ref_losses), cell.rec.negatives, cell.pool)


def run(ctx) -> None:
    import torch

    from benchmark import trace as T
    from benchmark.reference import retrieval_train as C
    from benchmark.work import xvlm as W

    cell = TrainCell(ctx)
    cell.checked_steps()
    ctx.mark("checked steps (the warm-up)")
    tr = ctx.traffic
    done, calls, window, marks = [0], [None], [None], []
    nxt = lambda i: cell.pool[(done[0] + i) % len(cell.pool)]  # noqa: E731

    def batches():
        """The pool, cycled, until --seconds have passed; in a traced run
        then `profile_steps` more on the device's trace alone and as many
        under the full profiler."""
        while not done[0] or time.time() - t0 < ctx.seconds:
            yield cell.pool[done[0] % len(cell.pool)]
            done[0] += 1
            marks.append(time.time())
        ctx.sync()
        window[0] = time.time() - t0
        ctx.window_closed()
        if not ctx.trace:
            return
        steps = tr["profile_steps"]
        with ctx.device_slice():
            for i in range(steps):
                yield nxt(i)
        with CallRecorder() as rec, ctx.profiled():
            for i in range(steps, 2 * steps):
                yield nxt(i)
        calls[0] = rec.calls

    t0 = ctx.start_window()
    cell.epoch(batches(), int(tr["start_epoch"]) + 1)
    n, window = done[0], window[0]
    ctx.e2e["train_samples_per_s"] = n * cell.batch / window
    ctx.attempted = n * cell.batch
    if cell.device.type == "cuda":
        ctx.memory_peak = torch.cuda.max_memory_allocated()
    thirds = [sum(1 for m in marks if t0 + window * k / 3 <= m < t0 + window * (k + 1) / 3)
              for k in range(3)]
    print(f"{n} steps in {window:.3f} s; steps a third of the window {thirds}", flush=True)

    cell.free_program()
    trainer = cell.reference()
    numbers = C.compare(cell.program_side(), C.trainer_side(trainer, cell.follow(trainer)),
                        cell.rec.negatives, cell.pool)
    for name, lim in ctx.limits.items():
        ctx.checks.append((name, numbers[name], float(lim["limit"])))

    flops = W.train_step_flops(cell.cfg, teacher_cfg(cell.cfg), batch=cell.batch,
                               text_len=int(cell.pool[0]["text_ids"].shape[1]))
    ctx.layer.update(mfu_flops=flops["total"] * n, window_s=window,
                     fused_calls=calls[0],
                     steps_profiled=tr["profile_steps"])
    if ctx.trace_data is not None:
        ctx.layer["trace"] = ctx.trace_data
        ctx.layer["trace_summary"] = T.summary(ctx.trace_data)
    print(f"step FLOP {flops}; checks {numbers}", file=sys.stderr, flush=True)
