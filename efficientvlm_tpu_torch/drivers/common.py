"""Model configs, the optimizer trio of a fine-tune and on-device image
preprocessing around a step (port of the model, optimizer and
preprocessing parts of efficientvlm_tpu/drivers/common.py)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import Config, TextConfig, VisionConfig
from ..data.device_pipeline import CROP_SCALE, preprocess_train
from ..train.optim import create_l0_optimizer, create_lagrangian_optimizer, create_optimizer
from ..train.scheduler import create_scheduler


def model_configs(config: Config) -> Tuple[VisionConfig, TextConfig]:
    """The student's towers: config["vision"] (the vision config file's
    keys) or a default ViT at image_res, and config["text"] or BERT-base
    with text_num_hidden_layers layers over the vision width."""
    vision = config.get("vision") or VisionConfig.create(image_res=config.get("image_res", 224))
    text = config.get("text") or TextConfig.create(
        num_hidden_layers=config.get("text_num_hidden_layers", 12),
        encoder_width=vision["vision_width"])
    return VisionConfig(vision), TextConfig(text)


def teacher_configs(config: Config) -> Tuple[VisionConfig, TextConfig]:
    """The teacher: 12L ViT + 12L BERT unless the config carries
    teacher_vision / teacher_text."""
    tv = config.get("teacher_vision") or VisionConfig.create(
        image_res=config.get("image_res", 224), num_hidden_layers=12, local_attn_depth=4)
    tt = config.get("teacher_text") or TextConfig.create(num_hidden_layers=12,
                                                         encoder_width=tv["vision_width"])
    return VisionConfig(tv), TextConfig(tt)


def build_optimizers(params, config: Config, total_steps: int, *, init_param_paths=()):
    """(main, L0, Lagrangian) AdamWs from the config's optimizer, schedular
    and accelerator sections. Gradient accumulation
    (accelerator.GRAD_ACCUMULATE_STEPS > 1) and skip_nonfinite_updates are
    not ported yet: either raises a ValueError that names it."""
    accum = int(config.get("accelerator", {}).get("GRAD_ACCUMULATE_STEPS", 1) or 1)
    if accum > 1:
        raise ValueError(f"accelerator.GRAD_ACCUMULATE_STEPS = {accum}: gradient accumulation "
                         "is not supported by the port yet")
    if int(config.get("skip_nonfinite_updates", 0) or 0):
        raise ValueError("skip_nonfinite_updates is not supported by the port yet")
    opt_cfg = config.get("optimizer", Config())
    sched_cfg = config.get("schedular", Config())
    sched = create_scheduler(lr=float(opt_cfg.get("lr", 1e-4)),
                             num_training_steps=max(total_steps, 1),
                             num_warmup_steps=sched_cfg.get("num_warmup_steps", 0))
    clip = float(config.get("accelerator", {}).get("CLIP_GRAD_NORM", 1.0) or 0) or None
    main = create_optimizer(params, lr=sched,
                            weight_decay=float(opt_cfg.get("weight_decay", 0.01)),
                            lr_mult=float(opt_cfg.get("lr_mult", 1.0)),
                            init_param_paths=init_param_paths, grad_clip=clip)
    reg_lr = float(opt_cfg.get("reg_learning_rate", 0.01))
    return main, create_l0_optimizer(reg_lr=reg_lr), create_lagrangian_optimizer(reg_lr=reg_lr)


class DevicePreprocess:
    """A step whose batch images (the image_keys entries, default "image")
    come as uint8 [B,H,W,3]: the generator draws the crop, flip and
    RandAugment of preprocess_train for each key in turn first (the crop's
    area fraction in `scale`; flip and RandAugment applied as hflip /
    randaug say), then the step runs on the normalised f32 images; keyword
    arguments go through to the step."""

    def __init__(self, step, image_res: int, *, hflip: bool = True, randaug: bool = True,
                 image_keys: Tuple[str, ...] = ("image",), scale=CROP_SCALE):
        self.step, self.image_res, self.scale = step, image_res, tuple(scale)
        self.hflip, self.randaug, self.image_keys = hflip, randaug, tuple(image_keys)

    def preprocess(self, batch: dict, generator: Optional[torch.Generator] = None) -> dict:
        return dict(batch, **{k: preprocess_train(batch[k], self.image_res, generator=generator,
                                                  hflip=self.hflip, randaug=self.randaug,
                                                  scale=self.scale)
                              for k in self.image_keys})

    def __call__(self, state, batch: dict, generator: Optional[torch.Generator] = None, **kw):
        return self.step(state, self.preprocess(batch, generator), generator, **kw)

