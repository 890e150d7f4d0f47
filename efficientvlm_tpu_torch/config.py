"""Config system: YAML task configs and JSON tower configs (port of
efficientvlm_tpu/config.py).

The port's own copy of `Config`, `VisionConfig`, `TextConfig` and the
loaders; the keys and defaults are those of configs/config_clipvit*.json,
HF BertConfig and the task YAMLs under configs/. YAML is read with PyYAML's
safe_load, as the JAX package reads it.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

import yaml


class Config(dict):
    """dict with attribute access (reference AttrDict)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, Mapping) and not isinstance(value, Config):
            return Config({k: Config._wrap(v) for k, v in value.items()})
        if isinstance(value, list):
            return [Config._wrap(v) for v in value]
        return value

    @classmethod
    def from_dict(cls, d: Mapping) -> "Config":
        return cls._wrap(dict(d))

    def to_dict(self) -> dict:
        def unwrap(v):
            if isinstance(v, dict):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, list):
                return [unwrap(x) for x in v]
            return v

        return unwrap(self)


def load_yaml(path: str) -> Config:
    with open(path) as f:
        return Config.from_dict(yaml.safe_load(f))


def load_json(path: str) -> Config:
    with open(path) as f:
        return Config.from_dict(json.load(f))


def read_json(path: str) -> Config:
    """The reference's utils.read_json."""
    return load_json(path)


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

    @classmethod
    def from_bert_json(cls, path: str, **overrides) -> "TextConfig":
        raw = load_json(path)
        keep = {k: raw[k] for k in cls.DEFAULTS if k in raw}
        keep.update(overrides)
        return cls.create(**keep)


def load_task_config(yaml_path: str, repo_root: str | None = None) -> Config:
    """A task YAML with its towers resolved (relative paths from repo_root,
    default the YAML's grandparent directory): "vision" from vision_config
    at the YAML's image_res, "text" from text_config (BERT-base when absent)
    with text_num_hidden_layers layers over the vision width, and the
    optional teacher_vision_config / teacher_text_config."""
    cfg = load_yaml(yaml_path)
    root = repo_root or os.path.dirname(os.path.dirname(os.path.abspath(yaml_path)))

    def resolve(p: str) -> str:
        return p if os.path.isabs(p) else os.path.join(root, p)

    if "vision_config" in cfg and os.path.exists(resolve(cfg["vision_config"])):
        cfg["vision"] = VisionConfig.create(image_res=cfg.get("image_res", 224),
                                            **load_json(resolve(cfg["vision_config"])))
    text_kw = dict(num_hidden_layers=cfg.get("text_num_hidden_layers", 12))
    if "vision" in cfg:
        text_kw["encoder_width"] = cfg["vision"]["vision_width"]
    text_cfg_path = cfg.get("text_config")
    if text_cfg_path and os.path.exists(resolve(text_cfg_path)):
        cfg["text"] = TextConfig.from_bert_json(resolve(text_cfg_path), **text_kw)
    else:
        cfg["text"] = TextConfig.create(**text_kw)
    if cfg.get("teacher_vision_config"):
        cfg["teacher_vision"] = VisionConfig.create(
            image_res=cfg.get("image_res", 224), **load_json(resolve(cfg["teacher_vision_config"])))
    if cfg.get("teacher_text_config"):
        tkw = dict(num_hidden_layers=cfg.get("teacher_text_num_hidden_layers", 12))
        if "teacher_vision" in cfg:
            tkw["encoder_width"] = cfg["teacher_vision"]["vision_width"]
        cfg["teacher_text"] = TextConfig.from_bert_json(resolve(cfg["teacher_text_config"]), **tkw)
    return cfg
