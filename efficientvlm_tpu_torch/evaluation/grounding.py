"""NLVR2 accuracy and grounding accuracy (the port's copy of
efficientvlm_tpu/evaluation/grounding.py, after the reference's
dataset/utils.py:165-335, with plain dicts in place of the REFER api).
Host-side numpy over the models' outputs.

- grounding_eval_bbox and its VLUE variant: IoU >= 0.5 of the regressed
  box with the referred one;
- grounding_eval_mask and its VLUE variant (weakly supervised): the
  mask_size x mask_size attention map is upsampled bicubically to the
  image, the detection proposals ranked by the map's mass inside them over
  area ** alpha, and the top one scored by IoU >= 0.5.

resize_bicubic is F.interpolate(mode="bicubic", align_corners=False) in
numpy f64: Keys a = -0.75, half-pixel centres, replicated borders.
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


def load_refer_maps(refs_file: str, instances_file: str) -> dict:
    """The maps the evaluations take, from RefCOCO(+/g)'s refs(<split_by>).p
    (a pickle of refs with ref_id, ann_id, image_id, split) and the COCO
    instances.json (images: id, height, width; annotations: id, bbox):
    ref_boxes, ref_splits, ref_images and image_sizes ((height, width)).
    The pickle is read as it is: pass only files of a trusted source."""
    import json
    import pickle

    with open(refs_file, "rb") as f:
        refs = pickle.load(f)
    with open(instances_file) as f:
        instances = json.load(f)
    anns = {a["id"]: a for a in instances["annotations"]}
    return {"ref_boxes": {r["ref_id"]: anns[r["ann_id"]]["bbox"] for r in refs},
            "ref_splits": {r["ref_id"]: r["split"] for r in refs},
            "ref_images": {r["ref_id"]: r["image_id"] for r in refs},
            "image_sizes": {i["id"]: (i["height"], i["width"]) for i in instances["images"]}}


def _cubic_weights(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    ax = np.abs(x)
    near = ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0
    far = a * (((ax - 5.0) * ax + 8.0) * ax - 4.0)
    return np.where(ax <= 1.0, near, np.where(ax < 2.0, far, 0.0))


def _resize_axis_bicubic(arr: np.ndarray, out_len: int, axis: int) -> np.ndarray:
    in_len = arr.shape[axis]
    if in_len == out_len:
        return arr
    coord = (np.arange(out_len) + 0.5) * (in_len / out_len) - 0.5  # half-pixel centres
    idx = np.floor(coord).astype(np.int64)[:, None] + np.arange(-1, 3)[None, :]  # 4 taps
    w = _cubic_weights(coord[:, None] - idx)
    idx = np.clip(idx, 0, in_len - 1)  # replicated borders, weights not renormalised
    gathered = np.moveaxis(arr, axis, 0)[idx]  # (out, 4, ...)
    w = w.reshape(w.shape + (1,) * (gathered.ndim - 2))
    return np.moveaxis((gathered * w).sum(axis=1), 0, axis)


def resize_bicubic(mask: np.ndarray, height: int, width: int) -> np.ndarray:
    """A 2-d map resized to height x width, f64."""
    mask = np.asarray(mask, np.float64)
    return _resize_axis_bicubic(_resize_axis_bicubic(mask, height, 0), width, 1)


def rank_detections(mask_up: np.ndarray, dets, alpha: float):
    """The proposal [x, y, w, h] (floats) of the largest sum(map inside) /
    (w * h) ** alpha, its bounds truncated as the reference's int() slices
    are (coordinates below 0 clamp to 0); None when no score is above 0."""
    H, W = mask_up.shape
    ii = np.zeros((H + 1, W + 1))
    ii[1:, 1:] = mask_up.cumsum(0).cumsum(1)  # summed-area table
    best_score, best_box = 0.0, None
    for det in dets:
        x, y, w, h = (float(v) for v in det[:4])
        x0, y0 = min(max(int(x), 0), W), min(max(int(y), 0), H)
        x1, y1 = min(max(int(x + w), x0), W), min(max(int(y + h), y0), H)
        score = (ii[y1, x1] - ii[y0, x1] - ii[y1, x0] + ii[y0, x0]) / (w * h) ** alpha
        if score > best_score:
            best_score, best_box = score, [x, y, w, h]
    return best_box


def _mask_pred(r: dict, height: int, width: int, dets, alpha: float, mask_size: int):
    mask = np.asarray(r["pred"], np.float64).reshape(mask_size, mask_size)
    return rank_detections(resize_bicubic(mask, height, width), dets, alpha)


def grounding_eval_mask(results: List[dict], dets: Dict, ref_boxes: Dict[int, list],
                        ref_splits: Dict[int, str], ref_images: Dict[int, int],
                        image_sizes: Dict[int, tuple], *, alpha: float = 0.5,
                        mask_size: int = 24, iou_thresh: float = 0.5) -> dict:
    """results: [{"ref_id", "pred": a mask_size^2 map}]; dets by image id
    (int or str keys); image_sizes {image_id: (height, width)}. Returns the
    fraction right per split, {"val_d", "testA_d", "testB_d"}."""
    correct = dict.fromkeys(SPLITS, 0)
    total = dict.fromkeys(SPLITS, 0)
    for r in results:
        split = ref_splits.get(r["ref_id"])
        if split not in total:
            continue
        image_id = ref_images[r["ref_id"]]
        height, width = image_sizes[image_id]
        image_dets = dets[image_id] if image_id in dets else dets[str(image_id)]
        pred = _mask_pred(r, height, width, image_dets, alpha, mask_size)
        total[split] += 1
        if pred is not None:
            correct[split] += int(compute_iou_xywh(pred, ref_boxes[r["ref_id"]]) >= iou_thresh)
    return {f"{k}_d": correct[k] / total[k] if total[k] else 0.0 for k in SPLITS}


def grounding_eval_mask_vlue(results: List[dict], test_records: List[dict], *,
                             alpha: float = 0.5, mask_size: int = 24,
                             iou_thresh: float = 0.5) -> dict:
    """VLUE's single split: each record carries its own bbox, height, width
    and dets. Returns {"score": fraction right}."""
    ref_map = {rec["ref_id"]: rec for rec in test_records}
    correct = 0
    for r in results:
        rec = ref_map[r["ref_id"]]
        pred = _mask_pred(r, rec["height"], rec["width"], rec["dets"], alpha, mask_size)
        if pred is not None:
            correct += int(compute_iou_xywh(pred, rec["bbox"]) >= iou_thresh)
    return {"score": correct / len(results) if results else 0.0}


def _box_from_pred(pred, width, height) -> list:
    """Normalised [cx, cy, w, h] -> [x, y, w, h] in pixels."""
    cx, cy, w, h = pred
    return [(cx - w / 2) * width, (cy - h / 2) * height, w * width, h * height]


def grounding_eval_bbox_vlue(results: List[dict], test_records: List[dict], *,
                             iou_thresh: float = 0.5) -> dict:
    """VLUE's single split for regressed boxes (normalised cxcywh); the
    records carry their own bbox, height and width. Returns {"score"}."""
    ref_map = {rec["ref_id"]: rec for rec in test_records}
    correct = 0
    for r in results:
        rec = ref_map[r["ref_id"]]
        pred = _box_from_pred(r["pred"], rec["width"], rec["height"])
        correct += int(compute_iou_xywh(pred, rec["bbox"]) >= iou_thresh)
    return {"score": correct / len(results) if results else 0.0}


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
        pred = _box_from_pred(r["pred"], r["width"], r["height"])
        total[split] += 1
        correct[split] += int(compute_iou_xywh(pred, ref_boxes[r["ref_id"]]) >= iou_thresh)
    return {k: 100.0 * correct[k] / total[k] if total[k] else 0.0 for k in SPLITS}


def nlvr_accuracy(predictions, targets) -> float:
    """Percentage of logit rows [N, 2] whose argmax is the target [N]."""
    return 100.0 * float((np.asarray(predictions).argmax(-1) == np.asarray(targets)).mean())
