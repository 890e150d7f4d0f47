"""The traffic's generators and schedules by hand: caption lengths from
the stated distribution (the seed draws their order, never the lengths),
each training batch padded to the same longest, and the fine-tune's lr
schedule read at the cell's global step, the reference's as the port's."""

import argparse

import numpy as np
import pytest
import torch

from benchmark import captions
from benchmark import run as H
from benchmark.reference import xvlm_train as RT

COCO = {"words_min": 8, "words_mean": 10.5, "tokens_over_words": 3}


def test_quantile_lengths_by_hand():
    # words over 8: geometric, P(one more) = 2.5 / 3.5; quantiles 1/8 .. 7/8 of 4
    got = captions.quantile_lengths(COCO, 4, 40)
    # P(over <= k) = 1 - (2.5 / 3.5)^(k + 1): k 0: 0.2857, 1: 0.4898, 2: 0.6356,
    # 5: 0.8672, 6: 0.9051; plus 3 tokens
    assert got.tolist() == [11, 12, 13, 17]
    many = captions.quantile_lengths(COCO, 20000, 40)
    assert many.min() == 11 and abs(many.mean() - 13.5) < 0.05
    assert captions.quantile_lengths(COCO, 24, 16).max() == 16  # cut as the tokenizer cuts


def test_seed_draws_the_order_not_the_lengths():
    a, b = (captions.lengths_in_order(COCO, 1280, 40, torch.Generator().manual_seed(s), "cpu")
            for s in (1, 2 ** 31 + 5))
    assert not torch.equal(a, b) and torch.equal(a.sort().values, b.sort().values)


def test_tokens_mark_cls_sep_and_padding():
    ids, atts = captions.tokens(torch.tensor([3, 5]), 6, 2000, torch.Generator().manual_seed(0),
                                "cpu")
    assert atts.sum(1).tolist() == [3, 5]
    assert ids[:, 0].tolist() == [captions.CLS] * 2
    assert ids[0, 2] == captions.SEP and ids[1, 4] == captions.SEP
    assert (ids[atts == 0] == captions.PAD).all() and ids[0, 1] >= captions.FIRST_WORD_ID


def test_every_training_batch_pads_to_the_same_longest(train_spec):
    from benchmark.drivers import retrieval_train as D

    cfg, tr = train_spec["config"], dict(train_spec["traffic"], captions=COCO)
    cfg = dict(cfg, batch_size_train=24, max_tokens=40)
    ctx = H.Context(argparse.Namespace(seed=2 ** 33 + 1, seconds=0.0, trace=0,
                                       workload="itr-prune-b24"), train_spec, "cpu")
    pool = D.make_pool(ctx, cfg, tr, "cpu")
    assert {b["text_ids"].shape[1] for b in pool} == {22}  # the top quantile of 24, under 40
    assert all(sorted(b["text_atts"].sum(1).tolist()) ==
               captions.quantile_lengths(COCO, 24, 40).tolist() for b in pool)


def test_reference_schedule_by_hand():
    lr = RT.linear_schedule(1.0, 1000, 0.1)
    assert lr(0) == 0.0 and lr(50) == pytest.approx(0.5) and lr(100) == pytest.approx(1.0)
    assert lr(550) == pytest.approx(0.5) and lr(1000) == 0.0
    later = RT.linear_schedule(1.0, 1000, 0.1, start=200)
    assert later(0) == pytest.approx(800 / 900) and later(3) == pytest.approx(797 / 900)


def test_the_cell_schedule_is_the_ports_read_later():
    from efficientvlm_tpu_torch.train.scheduler import create_scheduler

    from benchmark.drivers.retrieval_train import offset_schedule

    total, start = 236140, 47228
    port = offset_schedule(create_scheduler(lr=3e-5, num_training_steps=total,
                                            num_warmup_steps=0.1), start)
    ref = RT.linear_schedule(3e-5, total, 0.1, start)
    assert all(port(c) == pytest.approx(ref(c), rel=1e-12) for c in (0, 1, 2, 500))
    assert ref(0) == pytest.approx(3e-5 * (total - start) / (total - 23614))
    assert np.isclose(ref(0) / 3e-5, 0.8889, atol=1e-4)
