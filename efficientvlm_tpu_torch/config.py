"""Model configs: dict views over the reference's vision / text config keys.

The port's own copy of `Config`, `VisionConfig` and `TextConfig`; the keys
and defaults are those of configs/config_clipvit*.json and HF BertConfig.
"""

from __future__ import annotations

from typing import Any


class Config(dict):
    """dict with attribute access (reference AttrDict)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value


class VisionConfig(Config):
    """Keys of configs/config_clipvit*.json."""

    DEFAULTS = dict(
        vision_width=768,
        patch_size=16,
        hidden_act="quick_gelu",
        num_attention_heads=12,
        attention_dropout=0.0,
        intermediate_size=3072,
        num_hidden_layers=12,
        local_attn_depth=0,
        image_res=224,
    )

    @classmethod
    def create(cls, **kw) -> "VisionConfig":
        cfg = dict(cls.DEFAULTS)
        cfg.update(kw)
        return cls(cfg)

    @property
    def num_patches(self) -> int:
        return (self["image_res"] // self["patch_size"]) ** 2


class TextConfig(Config):
    """BERT-base config keys + X-VLM fusion_layer / encoder_width.

    fusion_layer defaults to num_hidden_layers // 2; the cross-attention K/V
    width is encoder_width (the vision width).
    """

    DEFAULTS = dict(
        vocab_size=30522,
        hidden_size=768,
        num_hidden_layers=12,
        num_attention_heads=12,
        intermediate_size=3072,
        hidden_act="gelu",
        hidden_dropout_prob=0.1,
        attention_probs_dropout_prob=0.1,
        max_position_embeddings=512,
        type_vocab_size=2,
        layer_norm_eps=1e-12,
        pad_token_id=0,
        encoder_width=768,
        fusion_layer=6,
    )

    @classmethod
    def create(cls, **kw) -> "TextConfig":
        cfg = dict(cls.DEFAULTS)
        cfg.update(kw)
        if "fusion_layer" not in kw:
            cfg["fusion_layer"] = cfg["num_hidden_layers"] // 2
        return cls(cfg)
