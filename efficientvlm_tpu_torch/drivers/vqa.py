"""The VQA pruning fine-tune (stage 2): the models, the gates and the step
of efficientvlm_tpu/drivers/vqa.py. The 12L/12L teacher with a 6-layer
answer decoder distils into the 6L/6L student with num_dec_layers (3);
loss = 0.6 x the weighted answer loss + 0.4 x vqa_kd_losses + the
Lagrangian. With `device_preprocess` the host ships uint8 images and the
step crops, augments and normalises them on the device first, without the
flip (the reference's VQA transform has none).

Batches: {"image", "q_ids", "q_atts", "a_ids", "a_atts", "weights",
"k_index"}, the answers flattened by data/collate.vqa_collate. The
training loop, the answer-list evaluation and checkpoint import come with
the tokenizer, the data streams and the checkpoint slice.
"""

from __future__ import annotations

from typing import Optional

from ..config import Config
from ..models.model_generation import XVLMForVQA
from ..pruning.l0_module import L0Module, VQAL0Module
from ..train.steps import TaskTrainStep, make_task_train_step, subset_teacher_taps, vqa_kd_losses
from . import common
from .common import DevicePreprocess

TASK_WEIGHT, KD_WEIGHT = 0.6, 0.4


def build_models(config: Config):
    """(student, teacher) XVLMForVQA: the student's answer decoder has
    config["num_dec_layers"] layers (default: its cross depth), the
    teacher's config["teacher_num_dec_layers"] (default: its cross depth,
    12 - 6)."""
    vcfg, tcfg = common.model_configs(config)
    tv, tt = common.teacher_configs(config)
    student_cfg = Config(config, num_dec_layers=config.get(
        "num_dec_layers", tcfg["num_hidden_layers"] - tcfg["fusion_layer"]))
    teacher_cfg = Config(config, num_dec_layers=config.get(
        "teacher_num_dec_layers", tt["num_hidden_layers"] - tt["fusion_layer"]))
    return XVLMForVQA(vcfg, tcfg, student_cfg), XVLMForVQA(tv, tt, teacher_cfg)


def build_l0(config: Config) -> L0Module:
    """The student's gate layout: VQAL0Module over its towers and its
    answer decoder, head gates per head_gate_group heads, the sparsity
    target."""
    vcfg, tcfg = common.model_configs(config)
    cross = tcfg["num_hidden_layers"] - tcfg["fusion_layer"]
    return VQAL0Module(
        vision_layers=vcfg["num_hidden_layers"], text_layers=tcfg["fusion_layer"],
        cross_layers=cross, decoder_layers=config.get("num_dec_layers", cross),
        hidden_size=tcfg["hidden_size"], intermediate_size=tcfg["intermediate_size"],
        num_heads=tcfg["num_attention_heads"], vision_hidden_size=vcfg["vision_width"],
        vision_intermediate_size=vcfg["intermediate_size"],
        vision_num_heads=vcfg["num_attention_heads"],
        target_sparsity=float(config.get("sparsity", 0.0)),
        head_group=int(config.get("head_gate_group", 1)))


def build_optimizers(params, config: Config, total_steps: int):
    """common.build_optimizers."""
    return common.build_optimizers(params, config, total_steps)


def _forward_args(batch: dict) -> tuple:
    return tuple(batch[k] for k in ("image", "q_ids", "q_atts", "a_ids", "a_atts", "weights",
                                    "k_index"))


def build_step(config: Config, student: XVLMForVQA, teacher: XVLMForVQA, l0: L0Module,
               optimizers, *, teacher_params, frozen_zs: Optional[dict] = None, dtype=None,
               impl: str = "fused"):
    """The step (a TaskTrainStep, in DevicePreprocess without the flip when
    config["device_preprocess"] is set): the student in train mode with its
    KD taps, the teacher in eval mode with its maps (the kernels' probs
    forms), its taps cut to the student's depths right after its forward.
    frozen_zs (l0.forward_deterministic at the stop epoch) is stop_prune."""
    tcfg = student.text_cfg
    fusion, depth = tcfg["fusion_layer"], tcfg["num_hidden_layers"]
    dec = student.decoder_cfg["num_hidden_layers"]
    taps = dict(output_attentions=True, output_hidden_states=True, dtype=dtype, impl=impl)

    def student_forward(params, zs, batch, generator):
        return student.forward_train(params, *_forward_args(batch), zs=zs, generator=generator,
                                     train=True, **taps)

    def teacher_forward(params, batch):
        out = teacher.forward_train(params, *_forward_args(batch), train=False, **taps)
        # the question stack's taps map over its whole depth before the KD
        # splits them at the student's fusion layer
        return subset_teacher_taps(
            out, vision_layers=student.vision_cfg["num_hidden_layers"], text_fusion=fusion,
            cross_layers=depth - fusion,
            by_key={"text_hidden_states": depth, "text_attentions": depth,
                    "decoder_hidden_states": dec, "decoder_attentions": dec,
                    "decoder_cross_attentions": dec})

    step: TaskTrainStep = make_task_train_step(
        student_forward, teacher_forward,
        lambda s, t: vqa_kd_losses(s, t, fusion_layer_s=fusion),
        l0, optimizers, teacher_params=teacher_params, task_weight=TASK_WEIGHT,
        kd_weight=KD_WEIGHT, frozen_zs=frozen_zs)
    if config.get("device_preprocess"):
        return DevicePreprocess(step, int(config.get("image_res", 480)), hflip=False)
    return step
