"""Window driver: the pruned student's two-stage retrieval evaluation,
drivers/retrieval.evaluate itself.

Set-up: the dense student's params and the gate log-alphas from the seed,
L0Module.forward_deterministic's gates, the physical export
(pruning/export.prune_xvlm_params, as the export CLI calls it), the bank
(images at the configuration's resolution as the evaluation loader ships
them, f32 normalised; captions_per_image captions an image, their lengths
from the traffic's distribution, benchmark/captions.py), what evaluate
reads fed from memory (a loader of the bank's image batches, a dataset of
its captions and links, a tokenizer of its rows), and a warm-up of the
window's shapes: the encoders over the bank and one rerank chunk each way.

Window: evaluate's passes back to back, with the port's own arguments
(encode_texts, encode_images, retrieval_scores, itm_eval). The window ends
with the pass in progress when --seconds have passed. While it runs, Taps
keeps each pass's ITC features and score matrices and, in a traced run,
puts a synchronised span around each of those calls. A traced run then
runs one pass on the device's trace alone (busy and idle) and one under
the full profiler (breakdown, kernel roofline).

After the window: the peak memory, the program's tree freed, and the
reference (reference/xvlm.py, f32, TF32 off) over the same dense params,
log-alphas and bank, compared by reference/retrieval_eval.compare on rows
drawn from the seed.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import sys
import time

import numpy as np


def port_config(cfg: dict):
    """The port's Config of a configuration file."""
    from efficientvlm_tpu_torch.config import Config, TextConfig, VisionConfig

    towers = {"vision": VisionConfig, "text": TextConfig, "teacher_vision": VisionConfig,
              "teacher_text": TextConfig}
    out = Config.from_dict({k: v for k, v in cfg.items() if k not in towers})
    for key, cls in towers.items():
        if key in cfg:
            out[key] = cls.create(**cfg[key])
    return out


def make_bank(ctx, cfg: dict, tr: dict, device):
    """(images [N, R, R, 3] f32 numpy, ids [N*c, T] int64, atts [N*c, T],
    txt2img, img2txt) from the seed: the captions' lengths from the
    traffic's distribution (benchmark/captions.py), each padded to
    max_tokens as evaluate's tokenizer call pads them."""
    import torch

    from benchmark import captions

    g = torch.Generator(device=device)
    g.manual_seed(ctx.sub_seed("bank"))
    n_img, res, t = tr["images"], cfg["image_res"], cfg["max_tokens"]
    n_txt = n_img * tr["captions_per_image"]
    images = torch.randn((n_img, res, res, 3), generator=g, device=device).cpu().numpy()
    lens = captions.lengths_in_order(tr["captions"], n_txt, t, g, device)
    ids, atts = captions.tokens(lens, t, cfg["text"]["vocab_size"], g, device)
    txt2img = np.arange(n_txt) // tr["captions_per_image"]
    img2txt = [list(range(i * tr["captions_per_image"], (i + 1) * tr["captions_per_image"]))
               for i in range(n_img)]
    return images, ids.cpu().numpy(), atts.cpu().numpy(), txt2img, img2txt


class Bank:
    """What evaluate reads of its dataset: the captions (here their row
    numbers in the tokenised bank) and the image-caption links."""

    def __init__(self, n_txt: int, txt2img, img2txt):
        self.text, self.txt2img, self.img2txt = list(range(n_txt)), txt2img, img2txt


class BankTokenizer:
    """evaluate's tokenizer over the bank: the captions' rows of the ids and
    masks made from the seed, at the padding evaluate asks for."""

    def __init__(self, ids: np.ndarray, atts: np.ndarray):
        self.ids, self.atts = ids, atts

    def __call__(self, rows, padding, truncation, max_length):
        if padding != "max_length" or max_length != self.ids.shape[1]:
            raise ValueError(f"the bank is tokenised at max_length {self.ids.shape[1]}, "
                             f"asked {padding} / {max_length}")
        rows = np.asarray(rows)
        return {"input_ids": self.ids[rows], "attention_mask": self.atts[rows]}


class Taps:
    """While active, evaluate's calls into evaluation/retrieval run under
    the benchmark's spans (traced runs: synchronised at both ends), and
    each retrieval_scores call's ITC features and score matrices are kept,
    a pass each, for the check."""

    SPANS = {"encode_texts": "eval.encode", "encode_images": "eval.encode",
             "retrieval_scores": "eval.rerank", "itm_eval": "eval.itm_eval"}

    def __init__(self, ctx, R, *, spans: bool = True):
        self.ctx, self.R, self.spans, self.orig, self.passes = ctx, R, spans, {}, []

    def _wrap(self, name):
        orig, span = getattr(self.R, name), self.SPANS[name]

        @functools.wraps(orig)
        def tapped(*a, **kw):
            with self.ctx.span(span) if self.spans else contextlib.nullcontext():
                out = orig(*a, **kw)
            if name == "retrieval_scores":
                got = inspect.signature(orig).bind(*a, **kw).arguments
                self.passes.append((got["image_embeds"], got["text_embeds"], *out))
            return out

        return tapped

    def __enter__(self):
        for name in self.SPANS:
            self.orig[name] = getattr(self.R, name)
            setattr(self.R, name, self._wrap(name))
        return self

    def __exit__(self, *exc):
        for name, f in self.orig.items():
            setattr(self.R, name, f)
        return False


class CallRecorder:
    """Records the shape of every call into csrc/fused_mha.cu (through
    kernels/bindings.fused_attention) and wraps each in a benchmark span,
    while active: the roofline reader counts the calls' work and charges
    them the device time launched under the span."""

    SPAN = "evlm.fused_attention"

    def __init__(self):
        from efficientvlm_tpu_torch.kernels import bindings

        self.bindings, self.orig, self.calls = bindings, bindings.fused_attention, []

    def __enter__(self):
        import torch

        orig, calls = self.orig, self.calls

        def recorded(x, enc, w, key_bias, gates, **kw):
            heads = kw["heads"]
            calls.append(dict(batch=kw["batch"], tq=kw["tq"], s=kw["s"], d=x.shape[1],
                              de=enc.shape[1], heads=heads, dh=w["wq"].shape[1] // heads,
                              self_attn=enc.data_ptr() == x.data_ptr(),
                              ln=kw.get("ln") is not None, probs=bool(kw.get("probs")),
                              vec_bytes=w["bq"].element_size()))
            with torch.profiler.record_function(self.SPAN):
                return orig(x, enc, w, key_bias, gates, **kw)

        self.bindings.fused_attention = recorded
        return self

    def __exit__(self, *exc):
        self.bindings.fused_attention = self.orig
        return False


def counters() -> int:
    from efficientvlm_tpu_torch.ops import fused_mha as M

    return (M.fused_self_attention.launches + M.fused_cross_attention.launches
            + M.fused_cross_attention_grouped.launches)


class EvalCell:
    """The cell's program side: set-up from the seed, the warm-up, one
    evaluation pass through drivers/retrieval.evaluate; and its check
    against the reference."""

    def __init__(self, ctx):
        import torch

        from efficientvlm_tpu_torch.drivers import common
        from efficientvlm_tpu_torch.drivers import retrieval as DR
        from efficientvlm_tpu_torch.evaluation import retrieval as R
        from efficientvlm_tpu_torch.pruning.export import prune_xvlm_params

        from benchmark import params as P

        ctx.mark("import the program")
        self.ctx, self.R, self.DR = ctx, R, DR
        cfg, tr = self.cfg, self.tr = ctx.config, ctx.traffic
        self.device = device = torch.device(ctx.device)
        self.config = config = port_config(cfg)
        self.student, _ = DR.build_models(config)
        l0 = DR.build_l0(config)
        fusion = cfg["text"]["fusion_layer"]
        head_dim = cfg["text"]["hidden_size"] // cfg["text"]["num_attention_heads"]
        self.kw = dict(zs=None, dtype=common.compute_dtype(config),
                       impl=config.get("attn_impl", "fused"))

        self.dense = P.materialize(P.xvlm_layout(cfg), ctx.sub_seed("weights"), device)
        self.loga = P.draw_loga(cfg, tr["gate_zeros"], *tr["loga_range"], ctx.sub_seed("loga"),
                                device)
        ctx.mark("weights and gates")
        want = {k: tuple(g["shape"]) for k, g in l0.groups.items()}
        if want != {k: tuple(v.shape) for k, v in self.loga.items()}:
            raise RuntimeError(f"gate layout {want} differs from the benchmark's")
        zs = l0.forward_deterministic({"loga": self.loga})
        self.sparsity = l0.calculate_model_size(zs)["pruned_model_sparsity"]
        self.pruned = prune_xvlm_params(self.dense, {k: v.cpu().numpy() for k, v in zs.items()},
                                        fusion_layer=fusion, head_dim=head_dim)
        ctx.mark("export")
        self.images, self.ids, self.atts, self.txt2img, self.img2txt = make_bank(
            ctx, cfg, tr, device)
        self.n_img, self.n_txt = self.images.shape[0], self.ids.shape[0]
        bs = cfg["batch_size_test"]
        self.loader = [(self.images[i:i + bs],) for i in range(0, self.n_img, bs)]
        self.dataset = Bank(self.n_txt, self.txt2img, self.img2txt)
        self.tokenizer = BankTokenizer(self.ids, self.atts)
        self.k = (min(cfg["k_test"], self.n_txt), min(cfg["k_test"], self.n_img))
        self.pairs_per_pass = self.n_img * self.k[0] + self.n_txt * self.k[1]

    def one_pass(self) -> None:
        """One evaluation pass, as drivers/retrieval.evaluate runs it."""
        self.DR.evaluate(self.student, self.pruned, self.loader, self.dataset, self.tokenizer,
                         self.config)

    def warm(self) -> None:
        """The encoders over the bank and one rerank chunk each way, at
        retrieval_scores' chunk size."""
        import torch

        R = self.R
        rows_per_call = inspect.signature(R.retrieval_scores).parameters["rows_per_call"].default
        tf, te = R.encode_texts(self.student, self.pruned, self.ids, self.atts,
                                batch_size=self.config.get("batch_size_test_text", 64), **self.kw)
        imf, ime = R.encode_images(self.student, self.pruned, (b[0] for b in self.loader),
                                   **self.kw)
        dtype = self.kw["dtype"] or torch.float32
        with torch.inference_mode():
            img_bank, txt_bank = (torch.as_tensor(x, device=self.device).to(dtype)
                                  for x in (imf, tf))
            att_bank = torch.as_tensor(self.atts, device=self.device).to(torch.int32)
            rows = torch.arange(rows_per_call, device=self.device)
            sims = ime @ te.T
            for chunk, s, k in ((R.i2t_chunk, sims, self.k[0]), (R.t2i_chunk, sims.T, self.k[1])):
                cand = torch.as_tensor(np.argsort(-s[:rows_per_call], axis=1)[:, :k],
                                       device=self.device)
                chunk(self.student, self.pruned, img_bank, txt_bank, att_bank, rows, cand,
                      **self.kw).float().cpu()

    def free_program(self) -> None:
        import torch

        self.pruned = self.student = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, num=None):
        """The reference's Evaluation of the bank (f32 unless `num` says)."""
        from benchmark.reference import xvlm as ref

        ref.exact_f32()
        return ref.Evaluation(num or ref.F32(), self.dense, self.cfg, self.loga, self.images,
                              self.ids, self.atts, device=self.device)

    def rows(self, n_passes: int):
        from benchmark.reference import retrieval_eval as C

        c = self.tr["check"]
        return C.sample_rows(self.ctx.sub_seed("check"), n_passes, self.n_img, self.n_txt,
                             c["i2t_rows"], c["t2i_rows"])

    def kept(self) -> dict:
        from benchmark.reference import xvlm as ref

        return ref.kept(ref.gates({k: v.cpu().numpy() for k, v in self.loga.items()}, self.cfg))


def run(ctx) -> None:
    import torch

    from benchmark import trace as T
    from benchmark.reference import retrieval_eval as C
    from benchmark.work import xvlm as W

    cell = EvalCell(ctx)
    ctx.mark("bank")
    cell.warm()
    ctx.mark("warm-up")
    calls = None
    before = counters()
    with Taps(ctx, cell.R) as taps:
        t0 = ctx.start_window()
        ends = []
        while not ends or time.time() - t0 < ctx.seconds:
            cell.one_pass()
            ends.append(time.time())
        ctx.sync()
        window = time.time() - t0
    ctx.window_closed()
    n = len(ends)
    ctx.e2e["eval_pairs_per_s"] = n * cell.pairs_per_pass / window
    ctx.attempted = n * cell.pairs_per_pass
    if cell.device.type == "cuda":
        ctx.memory_peak = torch.cuda.max_memory_allocated()
    print(f"export sparsity {cell.sparsity:.4f}; {n} passes in {window:.3f} s "
          f"({', '.join(f'{b - a:.3f}' for a, b in zip([t0] + ends, ends))} s each); "
          f"{(counters() - before) / n:.0f} fused_mha calls a pass", flush=True)
    passes = taps.passes
    if ctx.trace:  # after the window: one pass on the device's trace alone, one fully profiled
        with Taps(ctx, cell.R, spans=False) as more:
            with ctx.device_slice():
                cell.one_pass()
            with CallRecorder() as rec, ctx.profiled():
                cell.one_pass()
        calls, passes = rec.calls, passes + more.passes

    cell.free_program()
    k_i2t, k_t2i = cell.k
    numbers = C.compare(cell.reference(), passes, cell.rows(len(passes)), cell.k)
    ctx.failed = sum(C.malformed_rows(a, k_i2t) * k_i2t + C.malformed_rows(b, k_t2i) * k_t2i
                     for _, _, a, b in passes)
    for name in ("itc_gap", "shortlist_gap", "itm_gap", "malformed_rows"):
        ctx.checks.append((name, numbers[name], float(ctx.limits[name]["limit"])))

    kept = cell.kept()
    flops = W.eval_pass_flops(cell.cfg, kept, n_img=cell.n_img, n_txt=cell.n_txt,
                              text_len=cell.cfg["max_tokens"], pairs=cell.pairs_per_pass)
    ctx.layer.update(mfu_flops=flops["total"] * n, window_s=window, fused_calls=calls,
                     spanned_passes=n)
    if ctx.trace_data is not None:
        ctx.layer["trace"] = ctx.trace_data
        ctx.layer["trace_summary"] = T.summary(ctx.trace_data)
    print(f"kept widths {kept}; pass FLOP {flops}", file=sys.stderr, flush=True)


def readings(ctx, side: str = "program") -> dict:
    """The comparison's numbers for one seed without the timed window, of
    `side`: the program's one pass, or "control", the fp8 reference in its
    place."""
    from benchmark.reference import retrieval_eval as C
    from benchmark.reference import xvlm as ref

    cell = EvalCell(ctx)
    if side == "control":
        cell.free_program()
        rows = cell.rows(1)
        passes = C.control_passes(cell.reference(ref.Fp8()), rows, cell.k, 1)
        return C.compare(cell.reference(), passes, rows, cell.k, structure=False)
    with Taps(ctx, cell.R, spans=False) as taps:
        cell.one_pass()
    cell.free_program()
    return C.compare(cell.reference(), taps.passes, cell.rows(1), cell.k)
