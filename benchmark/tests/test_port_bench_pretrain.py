"""The X-VLM-base Swin pretraining cell at a tiny size on the CPU: the
reference follows the port's checked steps (image-text and region) to f32
rounding when the port computes in f32, a whole run comes out correct and
a traced run reports the whole-step share, runs with the timed path broken
underneath come out not correct, and the fp8 control fails a limit.

The whole runs compute in f32, as test_port_bench_train's do: at widths of
16-32 bf16's rounding reads larger than at the cell's size, against which
the limits are set. The swapped-ITM fault (tools/faults.altered_itm) is
read at the cell's size on the card, where it moves the whole loss by
0.147-0.237 and the first update by 0.46-1.0 (PERF.md); at these widths
the ITM logits sit near zero, so swapping them moves the whole loss by
about 0.02 and the first update by about 0.35, under the cell's limits."""

import argparse
import copy

import pytest

from benchmark import run as H
from benchmark.tests.conftest import _read

CELL = "xvlmb-swin-pretrain-b128"
ARGS = ["--workload", CELL, "--seed", "8589934601", "--seconds", "0.5"]


def tiny_spec(dtype: str = "f32") -> dict:
    """The cell with a 2-stage Swin (32 px, patch 4, window 4: the first
    stage shifts, the second's window is its grid), a 4-layer BERT fused at
    2, 4 image-text pairs and 6 region texts over 3 images a step, pools of
    2, 3 checked steps from step 39,956 (a region step, then two image-text
    steps)."""
    spec = H.cell_spec(_read("BENCHMARK.json"), CELL)
    cfg, tr = copy.deepcopy(spec["config"]), copy.deepcopy(spec["traffic"])
    cfg["vision"].update(image_res=32, embed_dim=16, depths=[2, 2], num_heads=[2, 4],
                         window_size=4, vision_width=32)
    cfg["text"].update(vocab_size=1200, hidden_size=32, num_attention_heads=4,
                       intermediate_size=64, num_hidden_layers=4, fusion_layer=2,
                       encoder_width=32, max_position_embeddings=32)
    cfg.update(image_res=32, patch_size=8, embed_dim=16, max_tokens=12, max_masks=3,
               compute_dtype=dtype, images={"batch_size": 4},
               regions=dict(cfg["regions"], batch_size=6, max_images=3))
    tr.update(captions={"words_min": 2, "words_mean": 5.0, "tokens_over_words": 3},
              region_captions={"words_min": 1, "words_mean": 2.0, "tokens_over_words": 2},
              shipped_res=36, pool=2, profile_steps=2)
    spec.update(config=cfg, traffic=tr)
    return spec


def driver():
    return H.load_file(H.os.path.join(H.HERE, "drivers", "pretrain_train.py"),
                       "benchmark_driver_pretrain_train")


def ctx(spec, seed=11):
    return H.Context(argparse.Namespace(seed=seed, seconds=0.0, trace=0, workload=CELL), spec,
                     "cpu")


def test_checked_steps_hold_both_kinds():
    d, spec = driver(), tiny_spec()
    cell = d.PretrainCell(ctx(spec))
    first = cell.start_step
    kinds = [cell.is_region(s) for s in range(first, first + spec["traffic"]["checked_steps"])]
    assert True in kinds and False in kinds


def test_reference_follows_the_port_in_f32():
    got = driver().readings(ctx(tiny_spec()))
    for k, v in got.items():
        if k.startswith("loss_gap"):
            assert v < 1e-5, k
    assert {"loss_gap.bbox", "loss_gap.giou", "loss_gap.itc"} <= set(got)
    assert got["first_change_gap"] < 1e-3 and got["rel_pos_grad_gap"] < 1e-4
    assert got["negatives_positive"] == 0


def test_sound_run_is_correct():
    code, res = H.run(ARGS, device="cpu", spec=tiny_spec())
    assert code == 0 and res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert set(res["checks"]) == set(tiny_spec()["limits"])


def test_traced_run_reports_the_whole_step_share():
    code, res = H.run(ARGS + ["--trace", "1"], device="cpu", spec=tiny_spec())
    assert code == 0 and res["correct"] is True
    assert 0 < res["metrics"]["mfu.pretrain"]["value"] and "breakdown" in res


def _unchanged(monkeypatch):
    from efficientvlm_tpu_torch.train import steps

    monkeypatch.setattr(steps.PretrainTrainStep, "apply", lambda self, state, grads: state)


def _half_batch(monkeypatch):
    from efficientvlm_tpu_torch.train import steps

    orig = steps.PretrainTrainStep.__call__

    def half(self, state, batch, generator=None, **kw):
        n = batch["text_ids"].shape[0] // 2
        keep = "image" if self.with_bbox else None
        return orig(self, state, {k: v if k == keep else v[:n] for k, v in batch.items()},
                    generator, **kw)

    monkeypatch.setattr(steps.PretrainTrainStep, "__call__", half)


def _unweighted_region(monkeypatch):
    """The region rows' [CLS] as the plain mean of the image's tokens."""
    import torch

    from efficientvlm_tpu_torch.models import swin

    orig = swin.region_rows

    def rows(seq, idx, image_atts):
        return orig(seq, idx, torch.ones_like(image_atts))

    monkeypatch.setattr(swin, "region_rows", rows)


def _no_rel_bias(monkeypatch):
    """The tower's window attention without its relative-position bias."""
    import torch

    from efficientvlm_tpu_torch.models import swin

    orig = swin.window_attention

    def attention(bp, *a, **kw):
        return orig(dict(bp, rel_bias=torch.zeros_like(bp["rel_bias"])), *a, **kw)

    monkeypatch.setattr(swin, "window_attention", attention)


@pytest.mark.parametrize("plant", [_unchanged, _half_batch, _unweighted_region,
                                   _no_rel_bias],
                         ids=["unchanged", "half_batch", "unweighted_region", "no_rel_bias"])
def test_broken_timed_path_is_not_correct(monkeypatch, plant):
    plant(monkeypatch)
    code, res = H.run(ARGS, device="cpu", spec=tiny_spec())
    assert code == 0 and res["correct"] is False


@pytest.mark.parametrize("seed", [3, 4])
def test_control_fails_a_limit(seed):
    spec = tiny_spec("bf16")
    numbers = driver().readings(ctx(spec, seed), "control")
    assert any(numbers[k] > lim["limit"] for k, lim in spec["limits"].items())
