"""Offline batch inference from a checkpoint (port of scripts/infer.py).

It loads a reference-keyed torch `.th` or a native `.ckpt` (a dense or gated
snapshot, a physically pruned or int8 export: the shapes the service reads,
drivers/common.load_eval_params) and runs the task's
inference unit on the card (--device cpu for the plain versions):

  caption: captions for a folder (or a comma list) of images
    python -m efficientvlm_tpu_torch.scripts.infer --task caption \\
        --checkpoint pruned.ckpt --config configs/tests/Captioning_synth.yaml \\
        --images /path/to/imgs --out captions.json

  vqa: answers for (image, question) pairs, a JSON list or JSONL of
    {"image": ..., "question": ...}, ranked over --answer_list
    python -m efficientvlm_tpu_torch.scripts.infer --task vqa \\
        --checkpoint pruned.ckpt --config configs/tests/VQA_synth.yaml \\
        --requests q.json --answer_list answers.json --image_root imgs/ \\
        --out answers.json

The compute is the drivers' evaluation unit (beam search from the prompt,
the k-way answer ranking) in the config's compute_dtype (bf16 by default)
and attn_impl, on batches of --batch_size: ImageTransform.test's images
(PIL bicubic to image_res, normalised on the host), as the drivers'
evaluation reads them.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..config import load_task_config
from ..data.datasets import load_transformed
from ..data.tokenizer import build_tokenizer
from ..data.transforms import ImageTransform
from ..device import resolve_device
from ..drivers.common import compute_dtype, load_eval_params
from ..run import REPO_ROOT

_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".gif", ".webp")


def _load_images(paths, transform, image_root, device) -> torch.Tensor:
    return torch.from_numpy(np.stack([
        np.asarray(load_transformed(transform, p, is_path=True, image_root=image_root))
        for p in paths])).to(device)


def _batches(seq, n):
    for i in range(0, len(seq), n):
        yield seq[i:i + n]


@torch.inference_mode()
def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", required=True, choices=["caption", "vqa"])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--config", required=True, help="task YAML (model geometry)")
    ap.add_argument("--images", default="", help="caption: a folder or a comma list of images")
    ap.add_argument("--requests", default="", help="vqa: JSON / JSONL of {image, question}")
    ap.add_argument("--answer_list", default="", help="vqa: JSON list of answers")
    ap.add_argument("--image_root", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    config = load_task_config(args.config if os.path.isabs(args.config)
                              else os.path.join(REPO_ROOT, args.config), repo_root=REPO_ROOT)
    tokenizer = build_tokenizer(config.get("text_encoder", ""))
    transform = ImageTransform.test(int(config.get("image_res", 384)))
    impl, dtype = config.get("attn_impl", "fused"), compute_dtype(config)

    results = []
    if args.task == "caption":
        from ..drivers.captioning import build_l0, build_models, load_torch_params, strip_prompt

        model, _ = build_models(config)
        params, zs = load_eval_params(model, build_l0(config), args.checkpoint,
                                      load_torch_params, device)
        prompt = config.get("prompt", "a picture of ")
        prompt_ids = np.asarray(tokenizer([prompt])["input_ids"], np.int64)[:, :-1]
        model.prompt_length = prompt_ids.shape[1]
        if os.path.isdir(args.images):
            paths = sorted(p for p in os.listdir(args.images)
                           if p.lower().endswith(_IMAGE_EXTS)
                           and os.path.isfile(os.path.join(args.images, p)))
            root = args.images
        else:
            paths, root = [p for p in args.images.split(",") if p], args.image_root
        for chunk in _batches(paths, args.batch_size):
            toks = model.generate(
                params, _load_images(chunk, transform, root, device),
                torch.as_tensor(np.repeat(prompt_ids, len(chunk), axis=0), device=device),
                max_length=int(config.get("max_length", 20)),
                min_length=int(config.get("min_length", 5)),
                num_beams=int(config.get("num_beams", 3)), eos_id=tokenizer.sep_token_id,
                pad_id=tokenizer.pad_token_id, zs=zs, dtype=dtype, impl=impl)
            for p, t in zip(chunk, toks.cpu().numpy()):
                results.append({"image": p, "caption": strip_prompt(
                    tokenizer.decode(t, skip_special_tokens=True), prompt)})
    else:
        from ..drivers.vqa import build_l0, build_models, load_torch_params

        model, _ = build_models(config)
        params, zs = load_eval_params(model, build_l0(config), args.checkpoint,
                                      load_torch_params, device)
        with open(args.answer_list or config["answer_list"]) as f:
            answers = json.load(f)
        ans = tokenizer([a + "[SEP]" for a in answers], padding="longest", truncation=True,
                        max_length=20)
        a_ids = torch.as_tensor(np.asarray(ans["input_ids"], np.int64), device=device)
        a_atts = torch.as_tensor(np.asarray(ans["attention_mask"]), device=device)
        k = min(int(config.get("k_test", 128)), len(answers))
        with open(args.requests) as f:
            text = f.read().strip()
        reqs = json.loads(text) if text.startswith("[") else [
            json.loads(line) for line in text.splitlines() if line.strip()]
        for chunk in _batches(reqs, args.batch_size):
            q = tokenizer([r["question"] for r in chunk], padding="max_length",
                          truncation=True, max_length=int(config.get("max_tokens", 40)))
            topk_ids, _ = model.forward_eval(
                params, _load_images([r["image"] for r in chunk], transform, args.image_root,
                                     device),
                torch.as_tensor(np.asarray(q["input_ids"], np.int64), device=device),
                torch.as_tensor(np.asarray(q["attention_mask"]), device=device), a_ids, a_atts,
                k=k, zs=zs, dtype=dtype, impl=impl)
            for r, aid in zip(chunk, topk_ids[:, 0].tolist()):
                results.append({**r, "answer": answers[int(aid)]})

    out = json.dumps(results, ensure_ascii=False, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out)
        print(f"wrote {len(results)} results to {args.out}")
    else:
        print(out)
    return results


if __name__ == "__main__":
    main()
