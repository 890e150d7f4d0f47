"""Fixtures of the benchmark's own tests: a tiny copy of each cell that
runs on the CPU, and the look for a card (made inside a fixture, never
while a module is imported)."""

import copy
import json
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _read(path):
    with open(os.path.join(ROOT, path)) as f:
        return json.load(f)


def tiny_eval_spec():
    """itr-eval-k256 shrunk to widths of 64, 2 ViT layers at 32 px and a
    4-layer BERT (fusion at 2), a bank of 8 images and 16 captions, k 8,
    every row checked; its limits as committed."""
    from benchmark import run as H

    spec = H.cell_spec(_read("BENCHMARK.json"), "itr-eval-k256")
    cfg, tr = copy.deepcopy(spec["config"]), copy.deepcopy(spec["traffic"])
    cfg["vision"].update(vision_width=64, patch_size=8, num_attention_heads=4,
                         intermediate_size=128, num_hidden_layers=2, local_attn_depth=1,
                         image_res=32)
    cfg["text"].update(vocab_size=2000, hidden_size=64, num_attention_heads=4,
                       intermediate_size=128, num_hidden_layers=4, fusion_layer=2,
                       encoder_width=64, max_position_embeddings=64)
    cfg.update(image_res=32, embed_dim=32, max_tokens=12, k_test=8, batch_size_test=3,
               batch_size_test_text=5)
    tr.update(images=8, captions_per_image=2,
              captions={"words_min": 2, "words_mean": 5.0, "tokens_over_words": 3},
              check={"i2t_rows": 100, "t2i_rows": 100},
              gate_zeros={"vision_head": [0, 1], "text_head": [1, 0], "cross_head": [0, 1, 1, 0],
                          "vision_intermediate": [30, 34], "text_intermediate": [32, 30],
                          "cross_intermediate": [28, 36]})
    spec.update(config=cfg, traffic=tr)
    return spec


def tiny_train_spec():
    """itr-prune-b24 shrunk as tiny_eval_spec shrinks the towers, a teacher
    twice as deep (4 ViT layers, 8 BERT layers fused at 4), 4 pairs a step
    of 5-12 tokens, a pool of 4 batches, 3 checked steps at step 200 of 1,000
    (the warm-ups 100 steps long)."""
    from benchmark import run as H

    spec = H.cell_spec(_read("BENCHMARK.json"), "itr-prune-b24")
    cfg = tiny_eval_spec()["config"]
    cfg["teacher_vision"] = dict(cfg["vision"], num_hidden_layers=4, local_attn_depth=2)
    cfg["teacher_text"] = dict(cfg["text"], num_hidden_layers=8, fusion_layer=4)
    cfg.update(batch_size_train=4, steps_per_epoch=100)
    tr = dict(spec["traffic"], captions={"words_min": 2, "words_mean": 5.0, "tokens_over_words": 3},
              pool=4, train_images=50, profile_steps=2)
    spec.update(config=cfg, traffic=tr)
    return spec


@pytest.fixture
def train_spec():
    return tiny_train_spec()


@pytest.fixture
def eval_spec():
    return tiny_eval_spec()


@pytest.fixture
def cuda():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
