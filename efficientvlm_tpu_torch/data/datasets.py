"""Task datasets and a batched loader on the host (the port's copy of
efficientvlm_tpu/data/datasets.py, after the reference's dataset/*.py):
numpy out, images HWC (NHWC once stacked). The fine-tune datasets return
raw strings, which the drivers tokenize; the pretraining streams tokenize
and mask inline. The VQA batch collation is data/collate.vqa_collate.

PIL is imported where an image is opened. A JPEG whose transform starts
with a plain square resize (the "test" transform with native_decode, or
"uint8") is decoded at that size by data/fastjpeg.py.
"""

from __future__ import annotations

import base64
import io
import json
import math
import os
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from .jsonl import ShardedJsonlDataset
from .masking import TextMaskingGenerator
from .transforms import ImageTransform
from .utils import pre_caption, pre_question


def _pil_image():
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    Image.MAX_IMAGE_PIXELS = None
    return Image


def open_image(ann_value: str, *, is_path: bool, image_root: str = ""):
    """An RGB PIL image from a path under image_root or base64 bytes."""
    Image = _pil_image()
    if is_path:
        return Image.open(os.path.join(image_root, ann_value)).convert("RGB")
    return Image.open(io.BytesIO(base64.b64decode(ann_value))).convert("RGB")


def load_transformed(transform, ann_value: str, *, is_path: bool, image_root: str = ""):
    """Decode and transform. Where the transform has a native_decode_size,
    a JPEG goes through fastjpeg.decode_resize and from_decoded; any other
    file, or a JPEG that fails there, through PIL (which raises the real
    error of a corrupt file)."""
    size = getattr(transform, "native_decode_size", None)
    if size:
        try:
            if is_path:
                with open(os.path.join(image_root, ann_value), "rb") as f:
                    data = f.read()
            else:
                data = base64.b64decode(ann_value)
            if data[:2] == b"\xff\xd8":  # JPEG magic
                from .fastjpeg import decode_resize

                return transform.from_decoded(decode_resize(data, size, size))
        except (OSError, ValueError):
            pass
    return transform(open_image(ann_value, is_path=is_path, image_root=image_root))


def load_ann(ann_file) -> List[dict]:
    """The concatenated JSON lists of one annotation file or several."""
    files = ann_file if isinstance(ann_file, (list, tuple)) else [ann_file]
    ann: List[dict] = []
    for path in files:
        with open(path) as f:
            ann += json.load(f)
    return ann


def default_collate(samples: Sequence):
    """Tuples column by column: arrays stacked, ints int64, floats f32,
    anything else a list."""
    first = samples[0]
    if isinstance(first, tuple):
        return tuple(default_collate([s[i] for s in samples]) for i in range(len(first)))
    if isinstance(first, np.ndarray):
        return np.stack(samples)
    if isinstance(first, (int, np.integer)):
        return np.asarray(samples, np.int64)
    if isinstance(first, (float, np.floating)):
        return np.asarray(samples, np.float32)
    return list(samples)


class SimpleLoader:
    """Batches of a map-style dataset: a shuffle per epoch from seed +
    epoch, rank sharding as DistributedSampler does (padded to a multiple
    of world_size, every world_size-th index), collate_fn over each batch."""

    def __init__(self, dataset, *, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, rank: int = 0, world_size: int = 1, seed: int = 42,
                 collate_fn: Optional[Callable] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rank, self.world_size = rank, world_size
        self.seed = seed
        self.epoch = 0
        self.collate_fn = collate_fn or default_collate

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        if self.world_size > 1:
            total = int(math.ceil(n / self.world_size)) * self.world_size
            idx = np.concatenate([idx, idx[: total - n]])[self.rank::self.world_size]
        return idx

    def batch_starts(self, idx: np.ndarray) -> range:
        """The first position in idx of every batch (drop_last drops the
        short one)."""
        end = len(idx) - len(idx) % self.batch_size if self.drop_last else len(idx)
        return range(0, end, self.batch_size)

    def __len__(self) -> int:
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else int(math.ceil(n / self.batch_size))

    def __iter__(self) -> Iterator:
        idx = self._indices()
        for i in self.batch_starts(idx):
            yield self.collate_fn([self.dataset[int(j)] for j in idx[i:i + self.batch_size]])


# ---------------------------------------------------------------------------
# retrieval (dataset/retrieval_dataset.py)
# ---------------------------------------------------------------------------


def _dense_ids(keys) -> Dict:
    """Each distinct key -> its rank of first appearance."""
    ids: Dict = {}
    for k in keys:
        ids.setdefault(k, len(ids))
    return ids


class RetrievalTrainDataset:
    """(image, caption, dense image index) per annotation."""

    def __init__(self, ann_file, transform: ImageTransform, image_root: str,
                 max_words: int = 30):
        self.ann = load_ann(ann_file)
        self.transform = transform
        self.image_root = image_root
        self.max_words = max_words
        self.img_ids = _dense_ids(a["image_id"] for a in self.ann)

    def __len__(self):
        return len(self.ann)

    def __getitem__(self, index):
        ann = self.ann[index]
        return (load_transformed(self.transform, ann["image"], is_path=True,
                                 image_root=self.image_root),
                pre_caption(ann["caption"], self.max_words), self.img_ids[ann["image_id"]])


class RetrievalEvalDataset:
    """(image, index) per image; text, txt2img and img2txt list the
    captions."""

    def __init__(self, ann_file, transform: ImageTransform, image_root: str,
                 max_words: int = 30):
        with open(ann_file) as f:
            self.ann = json.load(f)
        self.transform = transform
        self.image_root = image_root
        self.text: List[str] = []
        self.image: List[str] = []
        self.txt2img: Dict[int, int] = {}
        self.img2txt: Dict[int, List[int]] = {}
        for img_id, ann in enumerate(self.ann):
            self.image.append(ann["image"])
            self.img2txt[img_id] = []
            for caption in ann["caption"]:
                self.img2txt[img_id].append(len(self.text))
                self.txt2img[len(self.text)] = img_id
                self.text.append(pre_caption(caption, max_words))

    def __len__(self):
        return len(self.image)

    def __getitem__(self, index):
        return load_transformed(self.transform, self.ann[index]["image"], is_path=True,
                                image_root=self.image_root), index


# ---------------------------------------------------------------------------
# VQA (dataset/vqa_dataset.py)
# ---------------------------------------------------------------------------


def _mentions_left_or_right(*texts) -> bool:
    return any("left" in t or "right" in t for t in texts)


class VQADataset:
    """Train: (image, question, answers + eos, weights), the image mirrored
    with probability 1/2 unless the question or an answer says left or
    right; test: (image, question, question_id)."""

    def __init__(self, ann_file, transform: ImageTransform, vqa_root: str, vg_root: str = "",
                 split: str = "train", max_ques_words: int = 30, answer_list: str = "",
                 eos_token: str = "[SEP]", seed: Optional[int] = None):
        self.split = split
        self.ann = load_ann(ann_file)
        self.transform = transform
        self.vqa_root, self.vg_root = vqa_root, vg_root
        self.max_ques_words = 50 if split == "test" else max_ques_words
        self.eos_token = eos_token
        self.careful_hflip = True
        self.rng = np.random.default_rng(seed)
        if split == "test" and answer_list:
            with open(answer_list) as f:
                self.answer_list = json.load(f)

    def __len__(self):
        return len(self.ann)

    def _image_path(self, ann):
        root = {"vqa": self.vqa_root, "vg": self.vg_root, "gqa": ""}[ann.get("dataset", "vqa")]
        return os.path.join(root, ann["image"]) if root else ann["image"]

    def __getitem__(self, index):
        ann = self.ann[index]
        Image = _pil_image()
        image = Image.open(self._image_path(ann)).convert("RGB")
        if self.split != "test" and self.rng.random() < 0.5:
            answer = ann.get("answer", "")
            answers = answer if isinstance(answer, list) else [answer]
            if not (self.careful_hflip and _mentions_left_or_right(ann["question"], *answers)):
                image = image.transpose(Image.FLIP_LEFT_RIGHT)
        pixels = self.transform(image)
        question = pre_question(ann["question"], self.max_ques_words)
        if self.split == "test":
            return pixels, question, ann["question_id"]
        if ann.get("dataset") == "vg":
            answers, weights = [ann["answer"]], [0.5]
        else:
            answer_weight: Dict[str, float] = {}
            for a in ann["answer"]:
                answer_weight[a] = answer_weight.get(a, 0) + 1 / len(ann["answer"])
            answers, weights = list(answer_weight), list(answer_weight.values())
        return pixels, question, [a + self.eos_token for a in answers], weights


# ---------------------------------------------------------------------------
# NLVR2 (dataset/nlvr_dataset.py)
# ---------------------------------------------------------------------------


class NLVRDataset:
    """(image0, image1, sentence, label 0 / 1)."""

    def __init__(self, ann_file, transform: ImageTransform, image_root: str,
                 max_words: int = 30):
        self.ann = load_ann(ann_file)
        self.transform = transform
        self.image_root = image_root
        self.max_words = max_words

    def __len__(self):
        return len(self.ann)

    def __getitem__(self, index):
        ann = self.ann[index]
        image0, image1 = (load_transformed(self.transform, p, is_path=True,
                                           image_root=self.image_root)
                          for p in ann["images"][:2])
        label = 1 if ann["label"] == "True" or ann["label"] is True else 0
        return image0, image1, pre_caption(ann["sentence"], self.max_words), label


# ---------------------------------------------------------------------------
# captioning (dataset/captioning_dataset.py)
# ---------------------------------------------------------------------------


class CaptioningTrainDataset:
    """(image, prompt + caption, dense image index)."""

    def __init__(self, ann_file, transform: ImageTransform, image_root: str,
                 prompt: str = "a picture of ", max_words: int = 30):
        self.ann = load_ann(ann_file)
        self.transform = transform
        self.image_root = image_root
        self.prompt = prompt
        self.max_words = max_words
        self.img_ids = _dense_ids(a["image_id"] for a in self.ann)

    def __len__(self):
        return len(self.ann)

    def __getitem__(self, index):
        ann = self.ann[index]
        pixels = load_transformed(self.transform, ann["image"], is_path=True,
                                  image_root=self.image_root)
        return (pixels, self.prompt + pre_caption(ann["caption"], self.max_words),
                self.img_ids[ann["image_id"]])


class CaptioningSCSTDataset:
    """SCST's train set (the reference's coco_karpathy_train_scst,
    dataset/captioning_dataset.py:63-110): one row an annotation, its
    target n_gts of the image's captions drawn without replacement (with,
    where it has fewer), no prompt."""

    def __init__(self, ann_file, transform: ImageTransform, image_root: str,
                 max_words: int = 30, n_gts: int = 5, seed: int = 42):
        self.ann = load_ann(ann_file)
        self.transform = transform
        self.image_root = image_root
        self.max_words = max_words
        self.n_gts = n_gts
        self.rng = np.random.default_rng(seed)
        self.captions_by_image: Dict = {}
        for ann in self.ann:
            self.captions_by_image.setdefault(ann["image"], []).append(
                pre_caption(ann["caption"], max_words))

    def __len__(self):
        return len(self.ann)

    def __getitem__(self, index):
        ann = self.ann[index]
        pixels = load_transformed(self.transform, ann["image"], is_path=True,
                                  image_root=self.image_root)
        gts = self.captions_by_image[ann["image"]]
        pick = self.rng.choice(len(gts), self.n_gts, replace=len(gts) < self.n_gts)
        return pixels, [gts[i] for i in pick]


def scst_collate(samples):
    images, gt_lists = zip(*samples)
    return np.stack(images), list(gt_lists)


class CaptioningEvalDataset:
    """(image, COCO image id read off the file name)."""

    def __init__(self, ann_file, transform: ImageTransform, image_root: str):
        self.ann = load_ann(ann_file)
        self.transform = transform
        self.image_root = image_root

    def __len__(self):
        return len(self.ann)

    def __getitem__(self, index):
        ann = self.ann[index]
        img_id = ann["image"].split("/")[-1].strip(".jpg").split("_")[-1]
        return load_transformed(self.transform, ann["image"], is_path=True,
                                image_root=self.image_root), int(img_id)


# ---------------------------------------------------------------------------
# grounding (dataset/grounding_dataset.py)
# ---------------------------------------------------------------------------


class GroundingDataset:
    """Weakly supervised pairs (dataset/grounding_dataset.py:17-54): train
    yields a dense per-image index (the ITC key), evaluation the ref_id."""

    def __init__(self, ann_file, transform: ImageTransform, image_root: str,
                 max_words: int = 30, mode: str = "train"):
        self.ann = load_ann(ann_file)
        self.transform = transform
        self.image_root = image_root
        self.max_words = max_words
        self.mode = mode
        if mode == "train":
            self.img_ids = _dense_ids(a["image"].split("/")[-1] for a in self.ann)

    def __len__(self):
        return len(self.ann)

    def __getitem__(self, index):
        ann = self.ann[index]
        image = open_image(ann["image"], is_path=True, image_root=self.image_root)
        caption = pre_caption(ann["text"], self.max_words)
        key = (self.img_ids[ann["image"].split("/")[-1]] if self.mode == "train"
               else ann["ref_id"])
        return self.transform(image), caption, key


def _crop_around(rng: np.random.Generator, x, y, w, h, W, H):
    """A random crop (x0, y0, x1, y1) that holds the box (x, y, w, h) of a
    W x H image."""
    x0 = int(rng.integers(0, max(1, math.floor(x) + 1)))
    y0 = int(rng.integers(0, max(1, math.floor(y) + 1)))
    x1 = int(rng.integers(min(math.ceil(x + w), W), W + 1))
    y1 = int(rng.integers(min(math.ceil(y + h), H), H + 1))
    return x0, y0, x1, y1


class GroundingBboxDataset:
    """Box-supervised grounding (dataset/grounding_dataset.py:56-147) with
    the boxes given in the annotations ({"image", "text", "bbox": [x, y, w,
    h] pixels, "ref_id"}). Train: a random crop that holds the box, a
    mirror with probability 1/2 unless careful_hflip and the caption says
    left or right, a resize to image_res, and the cxcywh target over
    image_res; evaluation: (image, caption, ref_id, width, height)."""

    def __init__(self, ann_file, transform: ImageTransform, image_root: str,
                 image_res: int = 384, max_words: int = 30, mode: str = "train",
                 careful_hflip: bool = True, seed: int = 42):
        self.ann = load_ann(ann_file)
        self.transform = transform
        self.image_root = image_root
        self.image_res = image_res
        self.max_words = max_words
        self.mode = mode
        self.careful_hflip = careful_hflip
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.ann)

    def __getitem__(self, index):
        Image = _pil_image()
        ann = self.ann[index]
        image = open_image(ann["image"], is_path=True, image_root=self.image_root)
        caption = pre_caption(ann["text"], self.max_words)
        W, H = image.size
        if self.mode != "train":
            return self.transform(image), caption, ann["ref_id"], W, H
        x, y, w, h = (float(v) for v in ann["bbox"])
        x0, y0, x1, y1 = _crop_around(self.rng, x, y, w, h, W, H)
        image = image.crop((x0, y0, x1, y1))
        W, H = image.size
        do_hflip = False
        if self.rng.random() < 0.5 and not (self.careful_hflip
                                            and _mentions_left_or_right(caption)):
            image = image.transpose(Image.FLIP_LEFT_RIGHT)
            do_hflip = True
        image = image.resize((self.image_res, self.image_res), Image.BICUBIC)
        pixels = self.transform(image)
        x, y = x - x0, y - y0
        if do_hflip:
            x = (W - x) - w
        sx, sy = self.image_res / W, self.image_res / H
        x, w, y, h = x * sx, w * sx, y * sy, h * sy
        res = self.image_res
        target = np.asarray([(x + w / 2) / res, (y + h / 2) / res, w / res, h / res],
                            np.float32)
        return pixels, caption, target


# ---------------------------------------------------------------------------
# pretraining streams (dataset/pretrain_dataset.py)
# ---------------------------------------------------------------------------


class PretrainImageTextDataset:
    """An image-text JSONL stream (ImageTextJsonDataset,
    pretrain_dataset.py:140-281), tokenized and masked inline into
    fixed-length samples. A record that fails is printed and skipped, and
    the stream repeats: a stream whose every record fails never yields."""

    def __init__(self, config, data_path, tokenizer, *, rank: int = 0, world_size: int = 1,
                 shuffle: bool = True, repeat: bool = True,
                 transform: Optional[ImageTransform] = None, seed: int = 42):
        images_cfg = config["images"]
        self.image_key = images_cfg.get("image_key", "binary")
        self.is_image_rpath = images_cfg.get("is_image_rpath", False)
        self.caption_key = images_cfg.get("caption_key", "caption")
        self.batch_size = images_cfg.get("batch_size", 128)
        self.tokenizer = tokenizer
        self.max_tokens = config.get("max_tokens", 40)
        self.max_words = config.get("max_words", 40)
        self.max_masks = config.get("max_masks", 8)
        self.transform = transform or ImageTransform.pretrain(config.get("image_res", 224),
                                                              seed=seed)
        self.stream = ShardedJsonlDataset(data_path, rank=rank, world_size=world_size,
                                          shuffle=shuffle, repeat=repeat, seed=seed)
        self.mask_generator = TextMaskingGenerator(
            tokenizer, config.get("mask_prob", 0.25), self.max_masks,
            config.get("skipgram_prb", 0.2), config.get("skipgram_size", 3),
            config.get("mask_whole_word", True), seed=seed)
        self.cls_token = tokenizer.cls_token
        self.rng = np.random.default_rng(seed)

    def preprocess_text(self, text: str):
        """(text_ids, text_atts, text_ids_masked) int32 [max_tokens] and
        (masked_pos, masked_ids) int32 [max_masks] (pos 0 and id -100 past
        the masks)."""
        tok = self.tokenizer
        tokens = [self.cls_token] + tok.tokenize(pre_caption(text, self.max_words))
        tokens = tokens[: self.max_tokens]
        tokens_masked, masked_pos = self.mask_generator(list(tokens))
        text_ids = tok.convert_tokens_to_ids(tokens)
        text_ids_masked = tok.convert_tokens_to_ids(tokens_masked)
        masked_ids = [text_ids[p] for p in masked_pos]
        pad, n = tok.pad_token_id, len(text_ids)
        fill = self.max_tokens - n
        mp = list(masked_pos)[: self.max_masks]
        mi = list(masked_ids)[: self.max_masks]
        unused = self.max_masks - len(mp)
        return (np.asarray(text_ids + [pad] * fill, np.int32),
                np.asarray([1] * n + [0] * fill, np.int32),
                np.asarray(text_ids_masked + [pad] * fill, np.int32),
                np.asarray(mp + [0] * unused, np.int32),
                np.asarray(mi + [-100] * unused, np.int32))

    def sample(self, ann: dict) -> tuple:
        """One record -> (pixels, *preprocess_text of its caption, one drawn
        where it has a list)."""
        pixels = load_transformed(self.transform, ann[self.image_key],
                                  is_path=self.is_image_rpath)
        caption = ann[self.caption_key]
        if isinstance(caption, list):
            caption = caption[int(self.rng.integers(0, len(caption)))]
        return (pixels,) + self.preprocess_text(caption)

    def __iter__(self):
        for ann in self.stream:
            try:
                sample = self.sample(ann)
            except Exception as e:  # noqa: BLE001 -- a dirty stream: report and go on
                print(f"### encounter broken data: {e}")
                continue
            yield sample

    def batches(self):
        """Dicts of batch_size stacked samples: image, text_ids, text_atts,
        text_ids_masked, masked_pos, masked_ids."""
        buf: List = []
        for sample in self:
            buf.append(sample)
            if len(buf) == self.batch_size:
                cols = list(zip(*buf))
                yield {"image": np.stack(cols[0]), "text_ids": np.stack(cols[1]),
                       "text_atts": np.stack(cols[2]), "text_ids_masked": np.stack(cols[3]),
                       "masked_pos": np.stack(cols[4]), "masked_ids": np.stack(cols[5])}
                buf = []


class RegionTextDataset(PretrainImageTextDataset):
    """The region stream (RegionTextJsonDataset, pretrain_dataset.py:284-526):
    a random crop holding one drawn element, the whole-image caption first,
    then up to max_regions elements mostly inside the crop, each with its
    patch-level image_atts ([CLS] always on) and cxcywh target."""

    def __init__(self, config, data_path, tokenizer, **kw):
        super().__init__(config, data_path, tokenizer, **kw)
        regions_cfg = config["regions"]
        self.image_key = regions_cfg.get("image_key", "binary")
        self.is_image_rpath = regions_cfg.get("is_image_rpath", False)
        self.batch_size = regions_cfg.get("batch_size", 128)
        self.max_regions = regions_cfg.get("max_regions", 5)
        self.min_perc_in_image = regions_cfg.get("min_perc_in_image", 0.5)
        self.careful_hflip = regions_cfg.get("careful_hflip", False)
        self.image_res = config.get("image_res", 224)
        self.patch_size = config.get("patch_size", 16)
        self.num_patch = self.image_res // self.patch_size
        self.transform = ImageTransform.box(self.image_res, seed=kw.get("seed", 42))

    def get_image_attns(self, x, y, w, h) -> np.ndarray:
        """int32 [1 + num_patch^2]: [CLS] and the patches the box touches."""
        ps, npch = self.patch_size, self.num_patch
        x_min = min(math.floor(x / ps), npch - 1)
        x_max = max(x_min + 1, min(math.ceil((x + w) / ps), npch))
        y_min = min(math.floor(y / ps), npch - 1)
        y_max = max(y_min + 1, min(math.ceil((y + h) / ps), npch))
        atts = np.zeros(1 + npch * npch, np.int32)
        atts[0] = 1
        for j in range(x_min, x_max):
            for i in range(y_min, y_max):
                atts[npch * i + j + 1] = 1
        return atts

    def _draw_caption(self, cap):
        return cap[int(self.rng.integers(0, len(cap)))] if isinstance(cap, list) else cap

    def sample(self, ann: dict) -> tuple:
        """One record -> (pixels, [text sample + (image_atts, bbox,
        is_image)]), the list empty where no element stays in the crop."""
        Image = _pil_image()
        rng = self.rng
        image = open_image(ann[self.image_key], is_path=self.is_image_rpath)
        W, H = image.size
        elem = ann["elems"][int(rng.integers(0, len(ann["elems"])))]
        x, y, w, h = (int(v) for v in elem["bb"])
        if not (x >= 0 and y >= 0 and x + w <= W and y + h <= H and w > 0 and h > 0):
            raise ValueError(f"box {elem['bb']} outside the {W} x {H} image")
        x0, y0, x1, y1 = _crop_around(rng, x, y, w, h, W, H)
        image = image.crop((x0, y0, x1, y1))
        W, H = image.size
        image = image.resize((self.image_res, self.image_res), Image.BICUBIC)
        pixels = self.transform(image)
        sx, sy = self.image_res / W, self.image_res / H
        samples = []
        if "caption" in ann:  # the whole-image caption first
            t = self.preprocess_text(self._draw_caption(ann["caption"]))
            samples.append(t + (np.ones(1 + self.num_patch ** 2, np.int32),
                                np.asarray([0.5, 0.5, 1.0, 1.0], np.float32), 1))
        for elem in ann["elems"][:self.max_regions - len(samples)]:
            ex, ey, ew, eh = (float(v) for v in elem["bb"])
            ix0, iy0 = max(ex, x0), max(ey, y0)  # the part inside the crop
            ix1, iy1 = min(ex + ew, x1), min(ey + eh, y1)
            if ix1 <= ix0 or iy1 <= iy0:
                continue
            if (ix1 - ix0) * (iy1 - iy0) / (ew * eh) < self.min_perc_in_image:
                continue
            rx, ry = (ix0 - x0) * sx, (iy0 - y0) * sy
            rw, rh = (ix1 - ix0) * sx, (iy1 - iy0) * sy
            cap = self._draw_caption(elem["caption"])
            if "attributes" in elem:
                cap = elem["attributes"] + " " + cap
            res = self.image_res
            bbox = np.asarray([(rx + rw / 2) / res, (ry + rh / 2) / res, rw / res, rh / res],
                              np.float32)
            samples.append(self.preprocess_text(cap)
                           + (self.get_image_attns(rx, ry, rw, rh), bbox, 0))
        return pixels, samples

    def __iter__(self):
        for ann in self.stream:
            try:
                pixels, samples = self.sample(ann)
            except Exception as e:  # noqa: BLE001 -- a dirty stream: report and go on
                print(f"### encounter broken data: {e}")
                continue
            if samples:
                yield pixels, samples

    def batches(self, max_images: int = 48, n_shards: int = 1):
        """Grouped batches of max_images images and batch_size texts (drawn
        without replacement, or all and the rest with replacement) with
        idx_to_group_img (pretrain_dataset.py:478-526). With n_shards > 1
        the batch is n_shards such blocks concatenated on axis 0, each
        block's idx_to_group_img over its own images."""
        if max_images % n_shards or self.batch_size % n_shards:
            raise ValueError(f"{max_images} images / {self.batch_size} texts do not split "
                             f"into {n_shards} shards")
        imgs_per_shard = max_images // n_shards
        texts_per_shard = self.batch_size // n_shards
        rng = self.rng
        blocks: List[dict] = []
        images: List = []
        flat: List = []
        group: List[int] = []
        for pixels, samples in self:
            images.append(pixels)
            flat += samples
            group += [len(images) - 1] * len(samples)
            if len(images) < imgs_per_shard:
                continue
            n = len(flat)
            if n >= texts_per_shard:
                keep = rng.choice(n, texts_per_shard, replace=False)
            else:
                keep = np.concatenate([np.arange(n),
                                       rng.choice(n, texts_per_shard - n, replace=True)])
            cols = list(zip(*[flat[i] for i in keep]))
            blocks.append({
                "image": np.stack(images),
                "idx_to_group_img": np.asarray([group[i] for i in keep], np.int32),
                "text_ids": np.stack(cols[0]), "text_atts": np.stack(cols[1]),
                "text_ids_masked": np.stack(cols[2]), "masked_pos": np.stack(cols[3]),
                "masked_ids": np.stack(cols[4]), "image_atts": np.stack(cols[5]),
                "target_bbox": np.stack(cols[6]), "is_image": np.asarray(cols[7], np.int32),
            })
            images, flat, group = [], [], []
            if len(blocks) == n_shards:
                yield {k: np.concatenate([b[k] for b in blocks], axis=0) for k in blocks[0]}
                blocks = []
