"""The NLVR2 pruning fine-tune (stage 2) and its evaluation: the models, the
gates, the optimizers, the step and the logits of
efficientvlm_tpu/drivers/nlvr.py. The 12L/12L teacher (6 text + 2 x 6
replicated cross layers) distils into the 6L/6L student (3 + 2 x 3);
loss = 0.8 x the cross-entropy of the pair label + 0.2 x nlvr_kd_losses +
the Lagrangian; cls_head, trained from scratch, takes lr_mult. With
`device_preprocess` the host ships uint8 images and the step crops, flips,
augments and normalises image0 and then image1 on the device first.

Batches: {"image0", "image1" [B,H,W,3], "text_ids", "text_atts" [B,T],
"targets" [B]}; the model reads the 2B image batch, image0 rows first. The
epoch loop, the tokenizer, the dataset and checkpoint import come with
later slices.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import Config
from ..models.model_nlvr import XVLMForNLVR
from ..pruning.l0_module import L0Module, NLVRL0Module
from ..train.steps import TaskTrainStep, make_task_train_step, nlvr_kd_losses, subset_teacher_taps
from . import common
from .common import DevicePreprocess

TASK_WEIGHT, KD_WEIGHT = 0.8, 0.2
IMAGE_KEYS = ("image0", "image1")
INIT_PARAM_PATHS = ("cls_head",)


def build_models(config: Config):
    """(student, teacher) XVLMForNLVR over the towers' base configs (the
    replicated stack is built inside)."""
    vcfg, tcfg = common.model_configs(config)
    tv, tt = common.teacher_configs(config)
    return XVLMForNLVR(vcfg, tcfg, config), XVLMForNLVR(tv, tt, config)


def build_l0(config: Config) -> L0Module:
    """NLVRL0Module over the student's towers, head gates per
    head_gate_group heads, the sparsity target."""
    vcfg, tcfg = common.model_configs(config)
    return NLVRL0Module(
        vision_layers=vcfg["num_hidden_layers"], text_layers=tcfg["fusion_layer"],
        cross_layers=tcfg["num_hidden_layers"] - tcfg["fusion_layer"],
        hidden_size=tcfg["hidden_size"], intermediate_size=tcfg["intermediate_size"],
        num_heads=tcfg["num_attention_heads"], vision_hidden_size=vcfg["vision_width"],
        vision_intermediate_size=vcfg["intermediate_size"],
        vision_num_heads=vcfg["num_attention_heads"],
        target_sparsity=float(config.get("sparsity", 0.0)),
        head_group=int(config.get("head_gate_group", 1)))


def build_optimizers(params, config: Config, total_steps: int):
    """common.build_optimizers with cls_head at lr_mult."""
    return common.build_optimizers(params, config, total_steps,
                                   init_param_paths=INIT_PARAM_PATHS)


def images(batch: dict) -> torch.Tensor:
    """The 2B image batch the model reads: image0 rows, then image1 rows."""
    return torch.cat([batch["image0"], batch["image1"]], 0)


def build_step(config: Config, student: XVLMForNLVR, teacher: XVLMForNLVR, l0: L0Module,
               optimizers, *, teacher_params, frozen_zs: Optional[dict] = None, dtype=None,
               impl: str = "fused"):
    """The step (a TaskTrainStep, in DevicePreprocess over image0 and image1
    when config["device_preprocess"] is set): the student in train mode with
    its KD taps, the teacher in eval mode with its maps (the kernels' probs
    forms), its taps cut to the student's depths right after its forward;
    frozen_zs is stop_prune."""
    depth, fusion = student.text_cfg["num_hidden_layers"], student.num_text_layers
    taps = dict(output_attentions=True, output_hidden_states=True, dtype=dtype, impl=impl)

    def student_forward(params, zs, batch, generator):
        return student.forward(params, images(batch), batch["text_ids"], batch["text_atts"],
                               batch["targets"], zs=zs, generator=generator, train=True, **taps)

    def teacher_forward(params, batch):
        out = teacher.forward(params, images(batch), batch["text_ids"], batch["text_atts"],
                              train=False, **taps)
        # the replicated text stack's taps map over its whole depth before
        # the KD splits them at the student's fusion layer
        return subset_teacher_taps(
            out, vision_layers=student.vision_cfg["num_hidden_layers"], text_fusion=fusion,
            cross_layers=depth - fusion,
            by_key={"text_hidden_states": depth, "text_attentions": depth})

    step: TaskTrainStep = make_task_train_step(
        student_forward, teacher_forward,
        lambda s, t: nlvr_kd_losses(s, t, fusion_layer_s=fusion),
        l0, optimizers, teacher_params=teacher_params, task_weight=TASK_WEIGHT,
        kd_weight=KD_WEIGHT, frozen_zs=frozen_zs)
    if config.get("device_preprocess"):
        return DevicePreprocess(step, int(config.get("image_res", 384)), image_keys=IMAGE_KEYS)
    return step


@torch.no_grad()
def predict(model: XVLMForNLVR, params, batch: dict, *, zs=None, dtype=None,
            impl: str = "fused") -> torch.Tensor:
    """The logits [B, 2] of one evaluation batch ({"image0", "image1",
    "text_ids", "text_atts"}); evaluation/grounding.nlvr_accuracy scores
    them."""
    return model.forward(params, images(batch), batch["text_ids"], batch["text_atts"],
                         train=False, zs=zs, dtype=dtype, impl=impl)
