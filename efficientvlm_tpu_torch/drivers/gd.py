"""General distillation (stage 1) and plain pretraining: the models and the
steps of efficientvlm_tpu/drivers/gd.py. The teacher (12L/12L) distils
into the student (6L/6L); a task whose name starts with "pretrain" runs the
same steps without a teacher. With `device_preprocess` the host ships uint8
images and the general step crops (an area fraction in (0.2, 1.0), as the
reference's pretraining transform; JAX's GD step keeps the fine-tunes'
(0.5, 1.0)), flips, augments and normalises them on the device first
(data/device_pipeline.preprocess_train).

The training loop (efficientvlm_tpu/drivers/gd.py main: the general and
region streams interleaved, resume with the streams' cursors, preemption
and periodic checkpoints) is the next loop to port (ROADMAP A3). Its parts
are here already: the streams and their cursors (data/datasets,
data/jsonl), the full-state saves, preemption and the profiler
(drivers/common.py, where the fine-tunes' shared epoch loop lives).
"""

from __future__ import annotations

from ..config import Config
from ..data.device_pipeline import PRETRAIN_CROP_SCALE
from ..models.model_pretrain import XVLMForPretrain
from ..train.steps import make_gd_train_step, make_pretrain_train_step
from . import common
from .common import DevicePreprocess


def build_models(config: Config):
    """(student, teacher) XVLMForPretrain; both are initialised with the
    bbox head (`init(seed, with_bbox_head=True)`)."""
    vcfg, tcfg = common.model_configs(config)
    tv, tt = common.teacher_configs(config)
    return XVLMForPretrain(vcfg, tcfg, config), XVLMForPretrain(tv, tt, config)


def total_steps(config: Config) -> int:
    """The schedule's length on one device: epochs x train_dataset_size //
    batch."""
    batch = config.get("images", {}).get("batch_size", 128)
    epochs = int(config.get("schedular", {}).get("epochs", 41))
    return epochs * (config.get("train_dataset_size", 10000) // max(batch, 1))


def build_step(config: Config, student, optimizer, *, teacher=None, teacher_params=None,
               with_bbox: bool = False, dtype=None, impl: str = "fused"):
    """The general (with_bbox False) or region step: GD with a teacher, the
    plain pretrain step without one. The general step takes uint8 images
    when config["device_preprocess"] is set, and crops them at pretraining's
    scale."""
    if teacher is not None:
        step = make_gd_train_step(student, teacher, optimizer, teacher_params=teacher_params,
                                  with_bbox=with_bbox, dtype=dtype, impl=impl)
    else:
        step = make_pretrain_train_step(student, optimizer, with_bbox=with_bbox, dtype=dtype,
                                        impl=impl)
    if config.get("device_preprocess") and not with_bbox:
        return DevicePreprocess(step, int(config.get("image_res", 224)),
                                scale=PRETRAIN_CROP_SCALE)
    return step
