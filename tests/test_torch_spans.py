"""The program's spans and copy counters on the CPU
(efficientvlm_tpu_torch/train/profiler.py span / recording, the spans of
evaluation/retrieval.py and its copied_bytes):

- off, a span logs nothing and leaves no range in a torch.profiler
  profile; on, spans nest with their parents' indices, a name may cover
  several ranges, recordings nest and a span of another thread is not
  logged;
- the clock: under a profiler that records host activity, a logged span
  starts within 20 us (median) of its record_function event;
- drivers/retrieval.evaluate on tiny towers emits the evaluation's span
  tree, and copied_bytes moves by the bytes of every array it uploads and
  fetches.

The train loop's and the step's spans: tests/test_torch_driver.py."""

import statistics
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from efficientvlm_tpu_torch import config as tcfg
from efficientvlm_tpu_torch.drivers import retrieval as TDR
from efficientvlm_tpu_torch.evaluation import retrieval as TR
from efficientvlm_tpu_torch.models.model_retrieval import XVLMForRetrieval
from efficientvlm_tpu_torch.train import profiler as P

torch.set_num_threads(1)


def _profiled_names(fn) -> list:
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name() for e in prof.profiler.kineto_results.events()]


def _work():
    x = torch.ones(8, 8)
    with P.span("evlm.test.outer"):
        with P.span("evlm.test.inner"):
            x = x @ x
    return x


def test_spans_off_log_nothing_and_leave_no_range():
    assert P.span("evlm.a") is P.span("evlm.b")  # the shared no-op
    names = _profiled_names(_work)
    assert any("mm" in n for n in names)
    assert not [n for n in names if n.startswith("evlm.")]
    with P.recording() as log:
        pass
    names = _profiled_names(_work)  # after a recording: off again
    assert log == [] and not [n for n in names if n.startswith("evlm.")]


def test_spans_log_only_unless_annotated():
    with P.recording() as log:
        names = _profiled_names(_work)
    assert [s[0] for s in log] == ["evlm.test.outer", "evlm.test.inner"]
    assert not [n for n in names if n.startswith("evlm.")]
    with P.recording(annotate=True) as log:
        names = _profiled_names(_work)
    assert {"evlm.test.outer", "evlm.test.inner"} <= set(names)


def test_spans_nest_and_a_name_covers_several_ranges():
    with P.recording() as log:
        with P.span("a"):
            with P.span("b"):
                with P.span("c"):
                    pass
            with P.span("b"):
                pass
        with P.span("d"):
            pass
    assert [(n, p) for n, p, _, _ in log] == [("a", None), ("b", 0), ("c", 1), ("b", 0),
                                             ("d", None)]
    for name, parent, t0, t1 in log:
        assert t0 <= t1
        if parent is not None:
            assert log[parent][2] <= t0 and t1 <= log[parent][3]
    b = [t1 - t0 for n, _, t0, t1 in log if n == "b"]
    assert len(b) == 2 and sum(b) <= log[0][3] - log[0][2]
    assert log[3][2] >= log[1][3]  # the second range of b starts after the first ends


def test_recordings_nest_and_restore():
    with P.recording() as outer:
        with P.span("a"):
            with P.recording() as inner:
                with P.span("b"):
                    pass
            with P.span("c"):
                pass
    assert [(n, p) for n, p, _, _ in outer] == [("a", None), ("c", 0)]
    assert [(n, p) for n, p, _, _ in inner] == [("b", None)]
    assert P.span("x") is P.span("y")


def test_a_span_of_another_thread_is_not_logged():
    def other():
        with P.span("elsewhere"):
            pass

    with P.recording() as log:
        with P.span("here"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    assert [s[0] for s in log] == ["here"]


def test_a_span_starts_with_its_profiler_event():
    """Spans and the profiler's host events share one clock: the median gap
    between a logged start and its record_function event's start is under
    20 us, over 40 spans."""
    x = torch.ones(16, 16)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with P.recording(annotate=True) as log:
            for i in range(40):
                with P.span(f"evlm.clock.{i}"):
                    x = torch.tanh(x @ x)
    starts = {e.name(): e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name().startswith("evlm.clock.")}
    assert len(starts) == 40 and len(log) == 40
    gaps = [abs(t0 - starts[name]) / 1e3 for name, _, t0, _ in log]
    assert statistics.median(gaps) < 20.0, gaps


# ---------------------------------------------------------------------------
# the evaluation's spans and copies
# ---------------------------------------------------------------------------

VISION = dict(vision_width=32, num_attention_heads=2, intermediate_size=64,
              num_hidden_layers=2, image_res=16, patch_size=8)
TEXT = dict(vocab_size=60, hidden_size=32, num_hidden_layers=4, num_attention_heads=2,
            intermediate_size=64, encoder_width=32, fusion_layer=2,
            max_position_embeddings=16, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
N_IMG, PER, T_LEN, K, RPC = 5, 2, 8, 3, 4  # RPC: retrieval_scores' rows_per_call


class _Captions:
    def __init__(self, n_img: int, per: int):
        self.text = list(range(n_img * per))
        self.txt2img = [i // per for i in self.text]
        self.img2txt = [list(range(i * per, (i + 1) * per)) for i in range(n_img)]


def _tokenizer(ids, atts):
    def tok(rows, padding, truncation, max_length):
        assert padding == "max_length" and max_length == ids.shape[1]
        return {"input_ids": ids[rows], "attention_mask": atts[rows]}

    return tok


def test_evaluate_records_its_spans_and_copies(monkeypatch):
    config = tcfg.Config({"embed_dim": 16, "max_tokens": T_LEN, "batch_size_test_text": 4,
                          "k_test": K, "compute_dtype": "f32"})
    model = XVLMForRetrieval(tcfg.VisionConfig.create(**VISION), tcfg.TextConfig.create(**TEXT),
                             config)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(0)
    images = rng.standard_normal((N_IMG, 16, 16, 3)).astype(np.float32)
    loader = [(images[i:i + 2],) for i in range(0, N_IMG, 2)]
    n_txt = N_IMG * PER
    ids = rng.integers(1, 60, (n_txt, T_LEN)).astype(np.int64)
    atts = np.ones((n_txt, T_LEN), np.int64)
    atts[::3, T_LEN - 3:] = 0
    banks = []
    orig = TR.retrieval_scores

    def seen(model, params, image_feats, image_embeds, text_feats, text_atts, text_embeds,
             **kw):
        banks.append((image_feats, image_embeds, text_feats, text_atts, text_embeds))
        return orig(model, params, image_feats, image_embeds, text_feats, text_atts,
                    text_embeds, **kw)

    monkeypatch.setattr(TR, "retrieval_scores", seen)
    before = dict(TR.copied_bytes)
    with P.recording() as log:
        out = TDR.evaluate(model, params, loader, _Captions(N_IMG, PER),
                           _tokenizer(ids, atts), config)
    assert 0.0 <= out["r_mean"] <= 100.0

    top = [(i, n) for i, (n, p, _, _) in enumerate(log) if p is None]
    assert [n for _, n in top] == ["evlm.eval.encode_texts", "evlm.eval.encode_images",
                                   "evlm.eval.rerank", "evlm.eval.recall"]
    under = {n: Counter(c for c, p, _, _ in log if p == i) for i, n in top}
    text_batches, image_batches = -(-n_txt // 4), len(loader)
    chunks = -(-N_IMG // RPC) + -(-n_txt // RPC)
    assert under["evlm.eval.encode_texts"] == {"evlm.encode.upload": text_batches,
                                               "evlm.encode.fetch": 2 * text_batches}
    assert under["evlm.eval.encode_images"] == {"evlm.encode.upload": image_batches,
                                                "evlm.encode.fetch": 2 * image_batches}
    assert under["evlm.eval.rerank"] == {"evlm.rerank.shortlist": 1 + chunks,
                                         "evlm.rerank.bank": 1, "evlm.rerank.chunk": chunks,
                                         "evlm.rerank.fetch": chunks,
                                         "evlm.rerank.scatter": chunks}
    assert under["evlm.eval.recall"] == {}
    assert {log[p][0] for _, p, _, _ in log if p is not None} <= {n for _, n in top}

    (image_feats, image_embeds, text_feats, text_atts, text_embeds), = banks
    k_i2t, k_t2i = min(K, n_txt), min(K, N_IMG)
    index_bytes = 8 * RPC * (-(-N_IMG // RPC) * (1 + k_i2t) + -(-n_txt // RPC) * (1 + k_t2i))
    score_bytes = 4 * RPC * (-(-N_IMG // RPC) * k_i2t + -(-n_txt // RPC) * k_t2i)
    h2d = (ids.nbytes + atts.nbytes + images.nbytes  # the encoders' inputs
           + image_feats.nbytes + text_feats.nbytes + text_atts.nbytes  # the rerank's banks
           + index_bytes)
    d2h = (text_feats.nbytes + text_embeds.nbytes + image_feats.nbytes + image_embeds.nbytes
           + score_bytes)
    assert TR.copied_bytes["h2d"] - before["h2d"] == h2d
    assert TR.copied_bytes["d2h"] - before["d2h"] == d2h


@pytest.mark.parametrize("annotate", [False, True])
def test_trace_records_spans_as_ranges(tmp_path, annotate):
    """profiler.trace runs its block under recording(annotate=True): the
    spans show in its Chrome trace whether or not a recording was already
    open, and the outer one resumes after it."""
    import json

    with P.recording(annotate=annotate) as outer:
        with P.trace(str(tmp_path / "tr")):
            _work()
        with P.span("after"):
            pass
    with open(tmp_path / "tr" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"evlm.test.outer", "evlm.test.inner"} <= names
    assert [s[0] for s in outer] == ["after"]
