"""The captioning pruning fine-tune (stage 2): the models, the gates and the
step of efficientvlm_tpu/drivers/captioning.py. The 12L/12L teacher
distils into the 6L/6L student; the decoder is the whole fusion text stack
(layers [0, fusion) text-only, the rest cross-attending into the image), so
the gates are XVLML0Module's over that stack. loss = 0.7 x the caption LM
loss (prompt and PAD masked, label smoothing) + 0.3 x captioning_kd_losses
+ the Lagrangian. With `device_preprocess` the step crops, flips, augments
and normalises uint8 images on the device first.

Batches: {"image", "caption_ids", "caption_atts"}; config["prompt_length"]
is the prompt's token count without [SEP] (efficientvlm_tpu/drivers/
captioning.py takes it from the tokenizer). Beam-search evaluation, SCST and checkpoint
import come with later slices.
"""

from __future__ import annotations

from typing import Optional

from ..config import Config
from ..models.model_generation import XVLMForCaptioning
from ..pruning.l0_module import L0Module, XVLML0Module
from ..train.steps import (
    TaskTrainStep, captioning_kd_losses, make_task_train_step, subset_teacher_taps,
)
from . import common
from .common import DevicePreprocess

TASK_WEIGHT, KD_WEIGHT = 0.7, 0.3


def build_models(config: Config):
    """(student, teacher) XVLMForCaptioning, with the config's
    label_smoothing and prompt_length."""
    vcfg, tcfg = common.model_configs(config)
    tv, tt = common.teacher_configs(config)
    return XVLMForCaptioning(vcfg, tcfg, config), XVLMForCaptioning(tv, tt, config)


def build_l0(config: Config) -> L0Module:
    """XVLML0Module over the student's vision tower and its decoder's
    text / cross layout, head gates per head_gate_group heads."""
    vcfg, tcfg = common.model_configs(config)
    return XVLML0Module(
        vision_layers=vcfg["num_hidden_layers"], text_layers=tcfg["fusion_layer"],
        cross_layers=tcfg["num_hidden_layers"] - tcfg["fusion_layer"],
        hidden_size=tcfg["hidden_size"], intermediate_size=tcfg["intermediate_size"],
        num_heads=tcfg["num_attention_heads"],
        target_sparsity=float(config.get("sparsity", 0.0)),
        head_group=int(config.get("head_gate_group", 1)))


def build_optimizers(params, config: Config, total_steps: int):
    """common.build_optimizers."""
    return common.build_optimizers(params, config, total_steps)


def build_step(config: Config, student: XVLMForCaptioning, teacher: XVLMForCaptioning,
               l0: L0Module, optimizers, *, teacher_params, frozen_zs: Optional[dict] = None,
               dtype=None, impl: str = "fused"):
    """The step (a TaskTrainStep, in DevicePreprocess when
    config["device_preprocess"] is set): the student in train mode with its
    KD taps, the teacher in eval mode with its maps, its taps cut to the
    student's depths right after its forward; frozen_zs is stop_prune."""
    tcfg = student.text_cfg
    fusion, depth = tcfg["fusion_layer"], tcfg["num_hidden_layers"]
    taps = dict(pad_token_id=config.get("pad_token_id", 0),
                prompt_length=config.get("prompt_length", student.prompt_length),
                output_attentions=True, output_hidden_states=True, dtype=dtype, impl=impl)

    def student_forward(params, zs, batch, generator):
        return student.forward(params, batch["image"], batch["caption_ids"],
                               batch["caption_atts"], zs=zs, generator=generator, train=True,
                               **taps)

    def teacher_forward(params, batch):
        out = teacher.forward(params, batch["image"], batch["caption_ids"],
                              batch["caption_atts"], train=False, **taps)
        return subset_teacher_taps(
            out, vision_layers=student.vision_cfg["num_hidden_layers"], text_fusion=fusion,
            cross_layers=depth - fusion,
            by_key={"decoder_hidden_states": depth, "decoder_attentions": depth})

    step: TaskTrainStep = make_task_train_step(
        student_forward, teacher_forward, captioning_kd_losses, l0, optimizers,
        teacher_params=teacher_params, task_weight=TASK_WEIGHT, kd_weight=KD_WEIGHT,
        frozen_zs=frozen_zs)
    if config.get("device_preprocess"):
        return DevicePreprocess(step, int(config.get("image_res", 384)))
    return step
