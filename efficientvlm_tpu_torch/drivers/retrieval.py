"""The retrieval fine-tune's models and gates (port of build_models /
build_l0 of efficientvlm_tpu/drivers/retrieval.py)."""

from __future__ import annotations

from ..config import Config
from ..models.model_retrieval import XVLMForRetrieval
from ..pruning.l0_module import L0Module, XVLML0Module
from . import common


def build_models(config: Config):
    """(student, teacher) XVLMForRetrieval."""
    vcfg, tcfg = common.model_configs(config)
    tv, tt = common.teacher_configs(config)
    return XVLMForRetrieval(vcfg, tcfg, config), XVLMForRetrieval(tv, tt, config)


def build_l0(config: Config) -> L0Module:
    """The student's gate layout: head gates per head_gate_group heads, the
    sparsity target, the L0_schedular's init and temperature."""
    vcfg, tcfg = common.model_configs(config)
    l0_cfg = config.get("L0_schedular", Config())
    return XVLML0Module(
        vision_layers=vcfg["num_hidden_layers"], text_layers=tcfg["fusion_layer"],
        cross_layers=tcfg["num_hidden_layers"] - tcfg["fusion_layer"],
        hidden_size=tcfg["hidden_size"], intermediate_size=tcfg["intermediate_size"],
        num_heads=tcfg["num_attention_heads"], vision_hidden_size=vcfg["vision_width"],
        vision_intermediate_size=vcfg["intermediate_size"],
        vision_num_heads=vcfg["num_attention_heads"],
        droprate_init=float(l0_cfg.get("droprate_init", 0.5)),
        temperature=float(l0_cfg.get("temperature", 2.0 / 3.0)),
        target_sparsity=float(config.get("sparsity", 0.0)),
        head_group=int(config.get("head_gate_group", 1)))
