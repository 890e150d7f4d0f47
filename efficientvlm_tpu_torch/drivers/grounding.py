"""The visual grounding fine-tune and its evaluation: the models, the gates,
the step and the boxes of efficientvlm_tpu/drivers/grounding.py. The
student regresses the referred box (L1 + GIoU) under L0 gates at the
config's sparsity; loss = the box losses + the Lagrangian (task weight 1,
no teacher, loss_kd 0: the reference has no grounding KD recipe).

Batches: {"image" [B,H,W,3], "text_ids", "text_atts" [B,T], "target_bbox"
[B,4] (cx, cy, w, h in [0, 1])}. The epoch loop, the tokenizer, the box
dataset with its careful flip and checkpoint import come with later
slices.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import Config
from ..models.model_grounding import XVLMForGrounding
from ..pruning.l0_module import L0Module, XVLML0Module
from ..train.steps import TaskTrainStep, make_task_train_step
from . import common

TASK_WEIGHT, KD_WEIGHT = 1.0, 0.0


def build_models(config: Config):
    """(student, teacher) XVLMForGrounding (their init holds the bbox
    head); the step reads no teacher (KD_WEIGHT 0)."""
    vcfg, tcfg = common.model_configs(config)
    tv, tt = common.teacher_configs(config)
    return XVLMForGrounding(vcfg, tcfg, config), XVLMForGrounding(tv, tt, config)


def build_l0(config: Config) -> L0Module:
    """XVLML0Module over the student's towers, head gates per
    head_gate_group heads, the sparsity target."""
    vcfg, tcfg = common.model_configs(config)
    return XVLML0Module(
        vision_layers=vcfg["num_hidden_layers"], text_layers=tcfg["fusion_layer"],
        cross_layers=tcfg["num_hidden_layers"] - tcfg["fusion_layer"],
        hidden_size=tcfg["hidden_size"], intermediate_size=tcfg["intermediate_size"],
        num_heads=tcfg["num_attention_heads"], vision_hidden_size=vcfg["vision_width"],
        vision_intermediate_size=vcfg["intermediate_size"],
        vision_num_heads=vcfg["num_attention_heads"],
        target_sparsity=float(config.get("sparsity", 0.0)),
        head_group=int(config.get("head_gate_group", 1)))


def build_optimizers(params, config: Config, total_steps: int):
    """common.build_optimizers."""
    return common.build_optimizers(params, config, total_steps)


def build_step(config: Config, student: XVLMForGrounding, teacher, l0: L0Module, optimizers,
               *, teacher_params=None, frozen_zs: Optional[dict] = None, dtype=None,
               impl: str = "fused") -> TaskTrainStep:
    """The step: the student in train mode, loss = loss_bbox + loss_giou
    (both in the metrics); teacher and teacher_params, in the other task
    drivers' signature, are not read (no KD); frozen_zs is stop_prune."""

    def student_forward(params, zs, batch, generator):
        loss_bbox, loss_giou = student.forward(
            params, batch["image"], batch["text_ids"], batch["text_atts"],
            target_bbox=batch["target_bbox"], zs=zs, generator=generator, train=True,
            dtype=dtype, impl=impl)
        return {"loss": loss_bbox + loss_giou, "loss_bbox": loss_bbox, "loss_giou": loss_giou}

    return make_task_train_step(
        student_forward, lambda params, batch: {},
        lambda s, t: {"loss_kd": torch.zeros((), device=s["loss"].device)},
        l0, optimizers, teacher_params={}, task_weight=TASK_WEIGHT, kd_weight=KD_WEIGHT,
        frozen_zs=frozen_zs)


@torch.no_grad()
def predict(model: XVLMForGrounding, params, batch: dict, *, zs=None, dtype=None,
            impl: str = "fused") -> torch.Tensor:
    """The boxes [B, 4] (cx, cy, w, h in [0, 1]) of one evaluation batch
    ({"image", "text_ids", "text_atts"}); evaluation/grounding.
    grounding_eval_bbox scores them."""
    return model.forward(params, batch["image"], batch["text_ids"], batch["text_atts"],
                         train=False, zs=zs, dtype=dtype, impl=impl)
