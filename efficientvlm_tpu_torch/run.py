"""The port's command line, with the task names and flags of the repo's
run.py (the reference's run.py):

    python -m efficientvlm_tpu_torch.run --task itr_coco \\
        --checkpoint x-vlm.th --teacher_chkpt teacher.th --output_dir out/itr

runs on the card unless --device says otherwise (--device cpu runs the
plain versions on the CPU). The config is the task's YAML under configs/
(or --config), with the CLI's overrides merged as the reference's mains
merge them. Each task runs its driver's main, as run.py routes it:
gd_4m_small and pretrain_4m_* drivers/gd.main (pretrain_* without a
teacher), itr_coco drivers/retrieval.main, vqa_480 drivers/vqa.main, nlvr
and nlvr_domain drivers/nlvr.main, coco_captioning and coco_capt_domain
drivers/captioning.main, grounding drivers/grounding.main;
coco_captioning with --scst runs captioning's self-critical sequence
training (drivers/captioning.scst_train). Under torchrun (one process a
GPU; gloo with --device cpu) every task trains data parallel:

    torchrun --nproc_per_node 8 -m efficientvlm_tpu_torch.run --task itr_coco ...
"""

from __future__ import annotations

import argparse
import os

from .config import Config, load_task_config
from .drivers.common import install_preemption_handler

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TASK_CONFIGS = {
    "gd_4m_small": "configs/Pretrain_XVLM_small_4m.yaml",
    "pretrain_4m_base": "configs/Pretrain_XVLM_base_clipvit_4m.yaml",
    "pretrain_4m_small": "configs/Pretrain_XVLM_small_4m.yaml",
    "itr_coco": "configs/x-vlm-small-ft/Retrieval_coco.yaml",
    "vqa_480": "configs/x-vlm-small-ft/VQA_480.yaml",
    "nlvr": "configs/x-vlm-small-ft/NLVR.yaml",
    "nlvr_domain": "configs/x-vlm-small-ft/NLVR_pretrain_O1.yaml",
    "coco_captioning": "configs/x-vlm-small-ft/Captioning.yaml",
    "coco_capt_domain": "configs/x-vlm-small-ft/Captioning_pretrain_O1.yaml",
    "grounding": "configs/x-vlm-small-ft/Grounding.yaml",
}

# the driver module of each task (run.py:39-64)
TASK_DRIVERS = {
    "gd_4m_small": "gd", "pretrain_4m_base": "gd", "pretrain_4m_small": "gd",
    "itr_coco": "retrieval", "vqa_480": "vqa", "nlvr": "nlvr", "nlvr_domain": "nlvr",
    "coco_captioning": "captioning", "coco_capt_domain": "captioning", "grounding": "grounding",
}


def run(args: Config, config: Config):
    """The task's driver main (imported here: a task loads only its own)."""
    task = args["task"]
    if task not in TASK_DRIVERS:
        raise ValueError(f"unknown task: {task}")
    import importlib

    return importlib.import_module(f".drivers.{TASK_DRIVERS[task]}", __package__).main(args, config)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m efficientvlm_tpu_torch.run")
    parser.add_argument("--task", required=True, choices=sorted(TASK_CONFIGS))
    parser.add_argument("--config", default="", type=str)
    parser.add_argument("--model", default="x-vlm-small-ft", type=str,
                        help="fine-tune config set under configs/")
    parser.add_argument("--dist", default="", type=str,
                        help="accepted for the reference's scripts and ignored: the "
                             "processes come from torchrun's variables")
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (default) or cpu (the plain versions)")
    parser.add_argument("--output_dir", default="output", type=str)
    parser.add_argument("--checkpoint", default="", type=str)
    parser.add_argument("--teacher_chkpt", default="", type=str)
    parser.add_argument("--student_chkpt", default="", type=str,
                        help="general-distillation student init")
    parser.add_argument("--load_ckpt_from", default="", type=str,
                        help="domain pre-trained params for the nlvr / captioning fine-tunes "
                             "(implies the matching --load_*_pretrain)")
    parser.add_argument("--output_hdfs", default="", type=str,
                        help="hdfs:// directory for merging evaluation results")
    parser.add_argument("--bs", default=-1, type=int, help="batch size")
    parser.add_argument("--epoch", default=-1, type=int)
    parser.add_argument("--seed", default=42, type=int)
    parser.add_argument("--sparsity", default=None, type=float)
    parser.add_argument("--lr", default=None, type=float, help="override optimizer.lr")
    parser.add_argument("--reg_lr", default=None, type=float,
                        help="override optimizer.reg_learning_rate (the L0 / λ lr)")
    parser.add_argument("--load_vqa_pretrain", action="store_true")
    parser.add_argument("--temperature", default=1.0, type=float)
    parser.add_argument("--stop_prune_epoch", default=None, type=int)
    parser.add_argument("--scst", action="store_true",
                        help="self-critical sequence training (captioning)")
    parser.add_argument("--evaluate", action="store_true")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--load_nlvr_pretrain", action="store_true")
    parser.add_argument("--load_capt_pretrain", action="store_true")
    parser.add_argument("--max_steps", default=None, type=int)
    return parser.parse_args(argv)


def main(argv=None):
    """Parse argv, load and override the config, install the preemption
    handler and run the task."""
    install_preemption_handler()
    parsed = parse_args(argv)
    cfg_path = parsed.config or TASK_CONFIGS[parsed.task].replace("x-vlm-small-ft", parsed.model)
    if not os.path.isabs(cfg_path):
        cfg_path = os.path.join(REPO_ROOT, cfg_path)
    config = load_task_config(cfg_path, repo_root=REPO_ROOT)
    if parsed.bs > 0:
        config["batch_size_train"] = parsed.bs
    if parsed.epoch > 0:
        config.setdefault("schedular", Config())["epochs"] = parsed.epoch
    if parsed.sparsity is not None:
        config["sparsity"] = parsed.sparsity
    if parsed.lr is not None:
        config.setdefault("optimizer", Config())["lr"] = parsed.lr
    if parsed.reg_lr is not None:
        config.setdefault("optimizer", Config())["reg_learning_rate"] = parsed.reg_lr
    # the flags given (a value test by identity: run.py's `v not in ("", -1,
    # None, False)` also drops --seed 0, since 0 == False)
    args = Config({k: v for k, v in vars(parsed).items()
                   if not (v is None or v is False or (isinstance(v, str) and v == "")
                           or (k in ("bs", "epoch") and v == -1))})
    if args.get("load_ckpt_from"):
        args["checkpoint"] = args["load_ckpt_from"]
        if parsed.task == "nlvr":
            args["load_nlvr_pretrain"] = True
        elif parsed.task == "coco_captioning":
            args["load_capt_pretrain"] = True
    return run(args, config)


if __name__ == "__main__":
    main()
