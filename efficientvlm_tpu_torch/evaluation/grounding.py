"""NLVR2 accuracy and box-grounding accuracy (the port's copy of
nlvr_accuracy, compute_iou_xywh and grounding_eval_bbox of
efficientvlm_tpu/evaluation/grounding.py). Host-side numpy over the
models' outputs.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

SPLITS = ("val", "testA", "testB")


def compute_iou_xywh(box1, box2) -> float:
    """IoU of two [x, y, w, h] boxes; 0 when the union is empty."""
    x0, y0 = max(box1[0], box2[0]), max(box1[1], box2[1])
    x1 = min(box1[0] + box1[2], box2[0] + box2[2])
    y1 = min(box1[1] + box1[3], box2[1] + box2[3])
    inter = max(x1 - x0, 0) * max(y1 - y0, 0)
    union = box1[2] * box1[3] + box2[2] * box2[3] - inter
    return inter / union if union > 0 else 0.0


def grounding_eval_bbox(results: List[dict], ref_boxes: Dict[int, list],
                        ref_splits: Dict[int, str], *, iou_thresh: float = 0.5) -> dict:
    """results: [{"ref_id", "pred": [cx, cy, w, h] in [0, 1], "width",
    "height"}]; a prediction is right at IoU >= iou_thresh with the
    referred [x, y, w, h] pixel box. Returns the percentage right per split
    (val / testA / testB; 0 for a split with no results); results of other
    splits are skipped."""
    correct = dict.fromkeys(SPLITS, 0)
    total = dict.fromkeys(SPLITS, 0)
    for r in results:
        split = ref_splits.get(r["ref_id"])
        if split not in total:
            continue
        cx, cy, w, h = r["pred"]
        width, height = r["width"], r["height"]
        pred = [(cx - w / 2) * width, (cy - h / 2) * height, w * width, h * height]
        total[split] += 1
        correct[split] += int(compute_iou_xywh(pred, ref_boxes[r["ref_id"]]) >= iou_thresh)
    return {k: 100.0 * correct[k] / total[k] if total[k] else 0.0 for k in SPLITS}


def nlvr_accuracy(predictions, targets) -> float:
    """Percentage of logit rows [N, 2] whose argmax is the target [N]."""
    return 100.0 * float((np.asarray(predictions).argmax(-1) == np.asarray(targets)).mean())
