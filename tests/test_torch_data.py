"""Port parity of the host data layer against the JAX package, on the CPU:
text normalisation and JSONL files, the WordPiece tokenizer, the sharded
JSONL stream with its cursor, MLM masking, host RandAugment, the image
transforms, the native JPEG decoder, every task dataset, the pretraining
streams and the three loaders; then the two repairs of the port's
training set-up: the on-card RandAugment's op set and GD's crop scale, and
build_optimizers' refusal of the keys it does not port yet.

The data is synthesized in tmp_path (a vocab file, JSON / JSONL
annotations, textured JPEGs written with PIL) and read by both packages
from the same files with the same seeds. Both run the same numpy and PIL
calls, so every comparison is exact: ids, masks, cursors, sample order,
pixel arrays, targets and batches.
"""

import base64
import io
import itertools
import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from efficientvlm_tpu.data import datasets as JD
from efficientvlm_tpu.data import device_pipeline as JP
from efficientvlm_tpu.data import fastjpeg as JF
from efficientvlm_tpu.data import jsonl as JJ
from efficientvlm_tpu.data import masking as JM
from efficientvlm_tpu.data import prefetch as JPF
from efficientvlm_tpu.data import randaugment as JR
from efficientvlm_tpu.data import tokenizer as JT
from efficientvlm_tpu.data import transforms as JX
from efficientvlm_tpu.data import utils as JU
from efficientvlm_tpu_torch import config as tcfg
from efficientvlm_tpu_torch.data import collate as TCol
from efficientvlm_tpu_torch.data import datasets as TD
from efficientvlm_tpu_torch.data import device_pipeline as TP
from efficientvlm_tpu_torch.data import fastjpeg as TF
from efficientvlm_tpu_torch.data import jsonl as TJ
from efficientvlm_tpu_torch.data import masking as TM
from efficientvlm_tpu_torch.data import prefetch as TPF
from efficientvlm_tpu_torch.data import randaugment as TR
from efficientvlm_tpu_torch.data import tokenizer as TT
from efficientvlm_tpu_torch.data import transforms as TX
from efficientvlm_tpu_torch.data import utils as TU
from efficientvlm_tpu_torch.drivers import captioning as TDcap
from efficientvlm_tpu_torch.drivers import common as TC
from efficientvlm_tpu_torch.drivers import gd as TG
from efficientvlm_tpu_torch.drivers import grounding as TDgr
from efficientvlm_tpu_torch.drivers import nlvr as TDnlvr
from efficientvlm_tpu_torch.drivers import vqa as TDvqa

torch.set_num_threads(1)

WORDS = ("dog cat man woman sitting standing picture red blue left right bench "
         "playing grass table two of a on the running frisbee").split()
CAPTIONS = ["A dog sitting on the grass.", "Two men playing frisbee!",
            "a woman, standing left of a red bench", "The cat's picture (blue)",
            "a man running right-to-left on grass", "dogs and cats; playing",
            "unknownword xyzzy picture", "a-b/c d  e   f"]


def _same(a, b, what=""):
    """Exact equality of nested samples: arrays by value and dtype."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype,
                                                           a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (what, list(a), list(b))
        for k in a:
            _same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (what, type(a), type(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (what, a, b)


def _textured(rng, w, h):
    """A uint8 RGB image with gradients, stripes and noise (not flat)."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 / w, y * 255 / h, ((x // 7 + y // 5) % 2) * 200], -1)
    return np.clip(base + rng.integers(-30, 31, (h, w, 3)), 0, 255).astype(np.uint8)


def _jpeg(arr, quality=90) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Images (JPEG, one PNG), a vocab file, and the annotation files of
    every task, under one directory."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    sizes = [(64, 48), (48, 64), (80, 40), (56, 56), (40, 72), (60, 50)]
    names = []
    for i, (w, h) in enumerate(sizes):
        name = f"COCO_val2014_{i + 1:012d}.jpg"
        (root / name).write_bytes(_jpeg(_textured(rng, w, h)))
        names.append(name)
    Image.fromarray(_textured(rng, 50, 40)).save(root / "COCO_val2014_000000000007.png")
    names.append("COCO_val2014_000000000007.png")
    vocab = TT.make_test_vocab(WORDS + ["##ting", "##ning", "fr", "##is", "##bee"])
    with open(root / "vocab.txt", "w") as f:
        f.write("\n".join(vocab) + "\n")

    def dump(name, obj):
        with open(root / name, "w") as f:
            json.dump(obj, f)
        return str(root / name)

    caps = CAPTIONS
    files = {"names": names, "root": str(root), "vocab": str(root / "vocab.txt")}
    files["retrieval_train"] = dump("ret_train.json", [
        {"image": names[i % 7], "caption": caps[i % 8], "image_id": f"img{i % 7}"}
        for i in range(12)])
    files["retrieval_eval"] = dump("ret_eval.json", [
        {"image": names[i], "caption": [caps[i], caps[(i + 3) % 8]]} for i in range(5)])
    vqa = [{"image": names[i % 7], "question": q, "question_id": 100 + i,
            "answer": a, "dataset": "vqa"}
           for i, (q, a) in enumerate([
               ("What is on the left?", ["dog", "dog", "cat"]),
               ("What color is the bench?", ["red", "red", "blue", "red"]),
               ("Who is sitting?", ["man"]),
               ("How many dogs?", ["two", "2", "two"]),
               ("Is it right?", ["yes", "no"]),
               ("What animal?", ["cat", "cat"])])]
    vqa.append({"image": names[2], "question": "where is the dog", "question_id": 200,
                "answer": "grass", "dataset": "vg"})
    files["vqa"] = dump("vqa.json", vqa)
    files["nlvr"] = dump("nlvr.json", [
        {"images": [names[i], names[(i + 2) % 7]], "sentence": caps[i],
         "label": ["True", False, True, "False"][i % 4]} for i in range(6)])
    files["caption"] = dump("caption.json", [
        {"image": names[i % 6], "caption": caps[i % 8], "image_id": i % 6}
        for i in range(10)])
    files["grounding"] = dump("grounding.json", [
        {"image": names[i % 7], "text": caps[i % 8], "ref_id": 50 + i,
         "bbox": [3 + i, 2 + i, 20, 15]} for i in range(8)])
    return files


# ---------------------------------------------------------------------------
# text normalisation, JSONL files, the tokenizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("text", CAPTIONS + ["  trailing spaces   ", "<person> waves\n",
                                             "Q: is this a dog?!"])
def test_text_normalisation_matches_jax(text):
    for n in (3, 30):
        assert TU.pre_question(text, n) == JU.pre_question(text, n)
        assert TU.pre_caption(text, n) == JU.pre_caption(text, n)
    for bad in ("?!.", "   "):
        with pytest.raises(ValueError):
            JU.pre_caption(bad, 5)
        with pytest.raises(ValueError):
            TU.pre_caption(bad, 5)


def test_jsonl_files_match_jax(tmp_path):
    rows = [{"a": 1, "b": [1, 2]}, {"c": "x"}, {}]
    TU.write_jsonl(rows, str(tmp_path / "t" / "port.jsonl"))
    JU.write_jsonl(rows, str(tmp_path / "j" / "jax.jsonl"))
    assert (tmp_path / "t" / "port.jsonl").read_bytes() == \
        (tmp_path / "j" / "jax.jsonl").read_bytes()
    with open(tmp_path / "t" / "port.jsonl", "a") as f:
        f.write("\n   \n")
    assert TU.read_jsonl(str(tmp_path / "t" / "port.jsonl")) == \
        JU.read_jsonl(str(tmp_path / "t" / "port.jsonl")) == rows


@pytest.mark.parametrize("padding,max_length", [("longest", 40), ("longest", 5),
                                                ("max_length", 12)])
def test_tokenizer_matches_jax(corpus, padding, max_length):
    """Ids and masks (int32), pieces, ids back to text, the special ids and
    build_tokenizer from a vocab file, a directory and nothing."""
    j = JT.WordPieceTokenizer(JT.load_vocab(corpus["vocab"]))
    t = TT.build_tokenizer(corpus["vocab"])
    assert t.vocab == j.vocab == TT.load_vocab(corpus["vocab"])
    texts = CAPTIONS + ["x" * 120, "", "Ünïcode naïve café"]
    got = t(texts, padding=padding, max_length=max_length)
    ref = j(texts, padding=padding, max_length=max_length)
    _same(dict(got), dict(ref))
    assert got.input_ids.dtype == np.int32 and got.attention_mask is got["attention_mask"]
    _same(dict(t("a dog", max_length=max_length)), dict(j("a dog", max_length=max_length)))
    for text in texts:
        assert t.tokenize(text) == j.tokenize(text)
        ids = t.convert_tokens_to_ids(t.tokenize(text))
        assert t.decode(ids) == j.decode(ids)
        assert t.decode(ids + [0, 2, 3], skip_special_tokens=False) == \
            j.decode(ids + [0, 2, 3], skip_special_tokens=False)
    assert t.convert_ids_to_tokens([0, 10 ** 6]) == j.convert_ids_to_tokens([0, 10 ** 6])
    assert t.convert_tokens_to_ids("nope") == j.convert_tokens_to_ids("nope")
    assert [t.pad_token_id, t.cls_token_id, t.sep_token_id, t.mask_token_id,
            t.bos_token_id, t.eos_token_id, t.vocab_size] == \
        [j.pad_token_id, j.cls_token_id, j.sep_token_id, j.mask_token_id,
         j.bos_token_id, j.eos_token_id, j.vocab_size]
    directory = os.path.dirname(corpus["vocab"])
    assert TT.build_tokenizer(directory).vocab == j.vocab
    assert TT.build_tokenizer("/nonexistent").vocab == JT.make_test_vocab() == \
        TT.make_test_vocab()
    assert TT.make_test_vocab(["dog", "zebra"]) == JT.make_test_vocab(["dog", "zebra"])


# ---------------------------------------------------------------------------
# the sharded JSONL stream
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    for f in range(4):
        lines = [json.dumps({"f": f, "i": i}) for i in range(3 + f)]
        if f == 1:
            lines.insert(2, "{broken json")
        (d / f"part-{f:02d}.jsonl").write_text("\n".join(lines) + "\n")
    (d / "notes.txt").write_text(json.dumps({"f": "txt", "i": 0}) + "\n")
    return d


@pytest.mark.parametrize("kw", [dict(), dict(shuffle=False), dict(rank=1, world_size=2),
                                dict(num_workers=2, worker_idx=1, repeat=True),
                                dict(rank=0, world_size=2, seed=7, repeat=True)],
                         ids=["default", "in-order", "rank1of2", "worker1of2", "repeat"])
def test_sharded_jsonl_matches_jax(shards, kw, capsys):
    """Records, the cursor after every record, and a resume from a cursor
    taken halfway."""
    paths = [str(shards), str(shards / "part-0*.jsonl")]
    assert TJ.list_data_files(paths) == JJ.list_data_files(paths)
    assert TJ.list_data_files(str(shards / "part-00.jsonl")) == \
        JJ.list_data_files(str(shards / "part-00.jsonl"))
    t, j = TJ.ShardedJsonlDataset(str(shards), **kw), JJ.ShardedJsonlDataset(str(shards), **kw)
    assert t.shard_files(3) == j.shard_files(3)
    n = 30 if kw.get("repeat") else 100
    got, ref = [], []
    for (a, b) in itertools.islice(zip(t, j), n):
        got.append((a, t.state_dict()))
        ref.append((b, j.state_dict()))
    assert got == ref and got
    half = ref[len(ref) // 2][1]
    t2, j2 = TJ.ShardedJsonlDataset(str(shards), **kw), JJ.ShardedJsonlDataset(str(shards), **kw)
    t2.load_state_dict(half)
    j2.load_state_dict(half)
    assert list(itertools.islice(t2, 12)) == list(itertools.islice(j2, 12))
    out = capsys.readouterr().out
    assert kw.get("rank") == 1 or "skipping broken line" in out


def test_split_shard_matches_jax():
    data = list("abcdefg")
    for size in (1, 2, 3, 7):
        assert [TJ.split_shard(data, i, size) for i in range(size)] == \
            [JJ.split_shard(data, i, size) for i in range(size)]
    with pytest.raises(RuntimeError):
        TJ.split_shard(data, 0, 8)
    with pytest.raises(FileNotFoundError):
        TJ.ShardedJsonlDataset("/nonexistent/*.jsonl")


# ---------------------------------------------------------------------------
# MLM masking
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(mask_prob=0.25, mask_max=8),
                                dict(mask_prob=0.5, mask_max=3, skipgram_prb=0.6),
                                dict(mask_prob=0.3, mask_max=10, mask_whole_word=False),
                                dict(mask_prob=0.15, mask_max=8, skipgram_prb=0.0)])
def test_text_masking_matches_jax(corpus, kw):
    tok = TT.build_tokenizer(corpus["vocab"])
    t, j = TM.TextMaskingGenerator(tok, seed=3, **kw), JM.TextMaskingGenerator(tok, seed=3, **kw)
    for text in CAPTIONS * 3 + ["sitting running frisbee " * 6, "dog"]:
        tokens = ["[CLS]"] + tok.tokenize(text)
        assert t(tokens) == j(tokens)
    with pytest.raises(ValueError):
        t(["dog", "cat"])


# ---------------------------------------------------------------------------
# host RandAugment and the transforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", sorted(k for k in JR.OPS if k != "Cutout"))
def test_host_randaugment_op_matches_jax(op):
    """Each PIL op at magnitudes 0 and 7 of 10, both signs; Cutout (drawn
    from an unseeded generator in both) only at size 0."""
    img = Image.fromarray(_textured(np.random.default_rng(1), 37, 29))
    fn_t, lo, hi, signed = TR.OPS[op]
    assert JR.OPS[op][1:] == (lo, hi, signed)
    for m in (0, 7):
        v = lo + (hi - lo) * m / TR.MAX_LEVEL
        for sign in ((1, -1) if signed else (1,)):
            _same(np.asarray(fn_t(img, sign * v)), np.asarray(JR.OPS[op][0](img, sign * v)), op)
    assert TR.OPS["Cutout"][0](img, 0) is img


def test_host_random_augment_matches_jax():
    img = Image.fromarray(_textured(np.random.default_rng(2), 40, 32))
    assert TR.DEFAULT_AUGS == JR.DEFAULT_AUGS
    for augs in (None, ["Solarize", "Posterize", "Contrast", "Color"]):
        t = TR.RandomAugment(2, 7, augs=augs, rng=np.random.default_rng(5))
        j = JR.RandomAugment(2, 7, augs=augs, rng=np.random.default_rng(5))
        for _ in range(12):
            _same(np.asarray(t(img)), np.asarray(j(img)))


PRESETS = {"pretrain": lambda m: m.ImageTransform.pretrain(24, seed=4),
           "train": lambda m: m.ImageTransform.train(24, seed=4),
           "train_wohflip": lambda m: m.ImageTransform.train_wohflip(24, seed=4),
           "box": lambda m: m.ImageTransform.box(24, seed=4),
           "test": lambda m: m.ImageTransform.test(24),
           "test_native": lambda m: m.ImageTransform.test(24, native_decode=True),
           "uint8": lambda m: m.ImageTransform.uint8(24)}


@pytest.mark.parametrize("preset", list(PRESETS))
def test_image_transform_presets_match_jax(preset):
    """Every preset, seed for seed, on images wider, taller and of extreme
    aspect (random_resized_crop's fallback crop), grey and RGBA."""
    t, j = PRESETS[preset](TX), PRESETS[preset](JX)
    assert (t.mode, t.scale, t.hflip, t.image_res, t.native_decode_size) == \
        (j.mode, j.scale, j.hflip, j.image_res, j.native_decode_size)
    rng = np.random.default_rng(3)
    imgs = [Image.fromarray(_textured(rng, w, h)) for w, h in ((64, 48), (30, 70), (200, 9))]
    imgs += [imgs[0].convert("L"), imgs[1].convert("RGBA")]
    for _ in range(3):
        for img in imgs:
            _same(t(img), j(img), preset)
    arr = _textured(rng, 24, 24)
    _same(t.from_decoded(arr), j.from_decoded(arr))


def test_normalize_and_crop_match_jax():
    arr = _textured(np.random.default_rng(4), 33, 21)
    _same(TX.normalize(arr), JX.normalize(arr))
    _same(TX.CLIP_MEAN, JX.CLIP_MEAN)
    _same(TX.CLIP_STD, JX.CLIP_STD)
    img = Image.fromarray(arr)
    for scale in ((0.2, 1.0), (0.5, 1.0), (0.99, 1.0)):
        a = TX.random_resized_crop(np.random.default_rng(9), img, 16, scale=scale)
        b = JX.random_resized_crop(np.random.default_rng(9), img, 16, scale=scale)
        _same(np.asarray(a), np.asarray(b), str(scale))


# ---------------------------------------------------------------------------
# the native JPEG decoder
# ---------------------------------------------------------------------------


def _have_native_toolchain():
    return shutil.which("g++") is not None and any(
        os.path.exists(os.path.join(d, "jpeglib.h"))
        for d in ("/usr/include", "/usr/local/include", "/usr/include/x86_64-linux-gnu"))


def test_fastjpeg_matches_jax(tmp_path, monkeypatch):
    """The port's own csrc/fastjpeg.cpp, built into the repository's build/
    directory, decodes as the JAX package's build does; the PIL fallback
    decodes as JAX's fallback; garbage raises ValueError."""
    if not _have_native_toolchain():
        pytest.skip("g++ or libjpeg's jpeglib.h is missing: the native decoder cannot build")
    assert TF.available() and JF.available()
    assert TF.decoder().startswith("fastjpeg")
    assert os.path.commonpath([TF.SOURCE, TF.PKG_DIR]) == TF.PKG_DIR
    built = [os.path.join(r, f) for r, _, fs in os.walk(TF.BUILD_ROOT) for f in fs]
    assert any(f.endswith("_fastjpeg.so") for f in built)
    rng = np.random.default_rng(5)
    for w, h, out in ((640, 480, 442), (100, 300, 64), (48, 48, 48)):
        data = _jpeg(_textured(rng, w, h))
        _same(TF.decode_resize(data, out, out), JF.decode_resize(data, out, out))
        (tmp_path / "x.jpg").write_bytes(data)
        _same(TF.decode_resize_file(str(tmp_path / "x.jpg"), out, out // 2),
              JF.decode_resize_file(str(tmp_path / "x.jpg"), out, out // 2))
    with pytest.raises(ValueError):
        TF.decode_resize(b"\xff\xd8 not a jpeg", 16, 16)
    data = _jpeg(_textured(rng, 120, 90))
    monkeypatch.setitem(TF._state, "mod", None)
    monkeypatch.setitem(TF._state, "why", "test")
    monkeypatch.setattr(JF, "_mod", None)
    monkeypatch.setattr(JF, "_tried", True)
    assert not TF.available() and TF.decoder().startswith("PIL")
    _same(TF.decode_resize(data, 40, 50), JF.decode_resize(data, 40, 50))


# ---------------------------------------------------------------------------
# the task datasets and the loader
# ---------------------------------------------------------------------------


def _datasets(m, corpus):
    """name -> the dataset of package m (TD or JD)."""
    root = corpus["root"]
    transforms = TX.ImageTransform if m is TD else JX.ImageTransform
    train = lambda: transforms.train(24, seed=1)  # noqa: E731
    return {
        "retrieval_train": m.RetrievalTrainDataset(corpus["retrieval_train"], train(), root),
        "retrieval_eval": m.RetrievalEvalDataset(corpus["retrieval_eval"],
                                                 transforms.test(24), root, max_words=4),
        "retrieval_eval_native": m.RetrievalEvalDataset(
            corpus["retrieval_eval"], transforms.test(24, native_decode=True), root),
        "vqa_train": m.VQADataset(corpus["vqa"], train(), root, vg_root=root, seed=2),
        "vqa_test": m.VQADataset(corpus["vqa"], transforms.test(24), root, vg_root=root,
                                 split="test"),
        "nlvr": m.NLVRDataset(corpus["nlvr"], transforms.train_wohflip(24, seed=3), root),
        "caption_train": m.CaptioningTrainDataset(corpus["caption"], train(), root),
        "caption_scst": m.CaptioningSCSTDataset(corpus["caption"], transforms.uint8(20), root,
                                                n_gts=3, seed=4),
        "caption_eval": m.CaptioningEvalDataset(corpus["caption"], transforms.test(24), root),
        "grounding_train": m.GroundingDataset(corpus["grounding"], train(), root),
        "grounding_eval": m.GroundingDataset(corpus["grounding"], transforms.test(24), root,
                                             mode="eval"),
        "grounding_bbox_train": m.GroundingBboxDataset(
            corpus["grounding"], transforms.box(24, seed=5), root, image_res=24, seed=6),
        "grounding_bbox_eval": m.GroundingBboxDataset(
            corpus["grounding"], transforms.test(24), root, image_res=24, mode="eval"),
    }


DATASETS = [
    "retrieval_train", "retrieval_eval", "retrieval_eval_native", "vqa_train", "vqa_test",
    "nlvr", "caption_train", "caption_scst", "caption_eval", "grounding_train",
    "grounding_eval", "grounding_bbox_train", "grounding_bbox_eval"]


@pytest.mark.parametrize("name", DATASETS)
def test_dataset_matches_jax(corpus, name):
    """Every item, twice over (the random draws go on), and the dataset's
    own tables."""
    t, j = _datasets(TD, corpus)[name], _datasets(JD, corpus)[name]
    assert len(t) == len(j) > 0
    for k in ("img_ids", "text", "image", "txt2img", "img2txt", "captions_by_image"):
        assert getattr(t, k, None) == getattr(j, k, None), k
    for _ in range(2):
        for i in range(len(t)):
            _same(t[i], j[i], f"{name}[{i}]")


def test_loader_and_collation_match_jax(corpus):
    """SimpleLoader's batches (shuffled per epoch, rank-sharded, the short
    batch dropped or kept) with default_collate, vqa_collate and
    scst_collate."""
    t_ds, j_ds = _datasets(TD, corpus), _datasets(JD, corpus)
    cases = [("retrieval_train", dict(batch_size=5, shuffle=True), None),
             ("retrieval_train", dict(batch_size=4, shuffle=True, rank=1, world_size=2,
                                      drop_last=True), None),
             ("grounding_bbox_train", dict(batch_size=3), None),
             ("nlvr", dict(batch_size=4, drop_last=True), None),
             ("vqa_train", dict(batch_size=3), (TCol.vqa_collate, JD.vqa_collate)),
             ("caption_scst", dict(batch_size=4), (TD.scst_collate, JD.scst_collate))]
    for name, kw, collate in cases:
        t = TD.SimpleLoader(t_ds[name], collate_fn=collate and collate[0], **kw)
        j = JD.SimpleLoader(j_ds[name], collate_fn=collate and collate[1], **kw)
        for epoch in (0, 1):
            t.set_epoch(epoch)
            j.set_epoch(epoch)
            assert len(t) == len(j)
            got, ref = list(t), list(j)
            assert len(got) == len(ref) == len(t)
            _same(got, ref, f"{name} {kw} epoch {epoch}")
    samples = [(np.int64(1), 2.5, "a"), (np.int64(2), 3.5, "b")]
    _same(TD.default_collate(samples), JD.default_collate(samples))
    _same(TD.load_ann([corpus["vqa"], corpus["nlvr"]]), JD.load_ann([corpus["vqa"],
                                                                      corpus["nlvr"]]))


# ---------------------------------------------------------------------------
# the pretraining streams
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pretrain_shards(tmp_path_factory):
    """Two JSONL shards of base64 JPEGs (with a broken record and a broken
    line), captions as strings or lists, and region elements."""
    d = tmp_path_factory.mktemp("pretrain")
    rng = np.random.default_rng(6)
    for s in range(2):
        lines = []
        for i in range(6):
            w, h = (48 + 8 * i, 40 + 4 * s)
            rec = {"binary": base64.b64encode(_jpeg(_textured(rng, w, h))).decode(),
                   "caption": CAPTIONS[(i + s) % 8] if i % 2 else CAPTIONS[:3]}
            rec["elems"] = [{"bb": [2 + e, 3, 10 + 3 * e, 12], "caption": CAPTIONS[e + i % 3],
                             **({"attributes": "red"} if e == 1 else {})}
                            for e in range(3)]
            if i == 3:
                rec["binary"] = "bm90IGFuIGltYWdl"  # base64, not an image
            if i == 4:
                rec["elems"][0]["bb"] = [w, 0, 5, 5]  # outside: a region record that fails
            lines.append(json.dumps(rec))
        lines.insert(2, "{not json")
        (d / f"shard-{s}.jsonl").write_text("\n".join(lines) + "\n")
    return d


PRETRAIN_CONFIG = {"images": {"batch_size": 4, "image_key": "binary"},
                   "regions": {"batch_size": 6, "image_key": "binary", "max_regions": 3},
                   "max_tokens": 12, "max_words": 10, "max_masks": 4, "image_res": 32,
                   "patch_size": 8}


@pytest.mark.parametrize("transform", ["pretrain", "uint8"])
def test_pretrain_stream_matches_jax(corpus, pretrain_shards, transform, capsys):
    """batches() of the image-text stream (tokenize, mask, pad inline),
    broken records skipped in both, across the repeat."""
    tok_t, tok_j = TT.build_tokenizer(corpus["vocab"]), JT.build_tokenizer(corpus["vocab"])
    kw_t = kw_j = {}
    if transform == "uint8":
        kw_t, kw_j = dict(transform=TX.ImageTransform.uint8(28)), \
            dict(transform=JX.ImageTransform.uint8(28))
    t = TD.PretrainImageTextDataset(PRETRAIN_CONFIG, str(pretrain_shards), tok_t, seed=3, **kw_t)
    j = JD.PretrainImageTextDataset(PRETRAIN_CONFIG, str(pretrain_shards), tok_j, seed=3, **kw_j)
    _same(t.preprocess_text(CAPTIONS[0]), j.preprocess_text(CAPTIONS[0]))
    got = list(itertools.islice(t.batches(), 5))
    ref = list(itertools.islice(j.batches(), 5))
    _same(got, ref)
    assert got[0]["image"].shape[1:] == (32, 32, 3)  # res 32, or uint8(28): 28 x 1.15
    assert got[0]["image"].dtype == (np.float32 if transform == "pretrain" else np.uint8)
    assert t.stream.state_dict() == j.stream.state_dict()
    assert "encounter broken data" in capsys.readouterr().out


@pytest.mark.parametrize("n_shards", [1, 2])
def test_region_stream_matches_jax(corpus, pretrain_shards, n_shards):
    """batches(max_images=) of the region stream: crops around a drawn
    element, the image_atts and cxcywh targets, the grouped text draw."""
    tok = TT.build_tokenizer(corpus["vocab"])
    t = TD.RegionTextDataset(PRETRAIN_CONFIG, str(pretrain_shards), tok, seed=4)
    j = JD.RegionTextDataset(PRETRAIN_CONFIG, str(pretrain_shards), tok, seed=4)
    for box in ((0, 0, 8, 8), (3.5, 9.2, 20.1, 4.0), (30, 30, 10, 10), (0, 0, 32, 32)):
        _same(t.get_image_attns(*box), j.get_image_attns(*box))
    got = list(itertools.islice(t.batches(max_images=4, n_shards=n_shards), 3))
    ref = list(itertools.islice(j.batches(max_images=4, n_shards=n_shards), 3))
    _same(got, ref)
    assert got[0]["image_atts"].shape == (6, 17) and got[0]["idx_to_group_img"].max() < 4
    with pytest.raises(ValueError):
        next(t.batches(max_images=5, n_shards=2))


# ---------------------------------------------------------------------------
# the loaders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,workers", [("thread", 1), ("thread", 2), ("process", 1),
                                          ("process", 2)])
def test_loaders_match_jax(corpus, kind, workers):
    """ParallelMapLoader over the deterministic eval transform, and
    ProcessMapLoader over the train transform (reseeded per batch from
    (seed, epoch, start), so the batches are the JAX package's at any
    worker count); the thread loader against the plain SimpleLoader too;
    a loop left after its first batch."""
    root = corpus["root"]
    if kind == "thread":
        mk = lambda m, X: m.RetrievalEvalDataset(corpus["retrieval_eval"],  # noqa: E731
                                                 X.ImageTransform.test(24), root)
        t = TPF.ParallelMapLoader(TD.SimpleLoader(mk(TD, TX), batch_size=2), workers)
        j = JPF.ParallelMapLoader(JD.SimpleLoader(mk(JD, JX), batch_size=2), workers)
        _same(list(t), list(TD.SimpleLoader(mk(TD, TX), batch_size=2)))
    else:
        mk = lambda m, X: m.RetrievalTrainDataset(corpus["retrieval_train"],  # noqa: E731
                                                  X.ImageTransform.train(24, seed=1), root)
        t = TPF.ProcessMapLoader(TD.SimpleLoader(mk(TD, TX), batch_size=5, shuffle=True),
                                 workers, seed=8, batch_timeout=120)
        j = JPF.ProcessMapLoader(JD.SimpleLoader(mk(JD, JX), batch_size=5, shuffle=True),
                                 workers, seed=8)
        t.set_epoch(1)
        j.set_epoch(1)
    assert len(t) == len(j)
    _same(list(t), list(j), f"{kind} x{workers}")
    it = iter(t)  # leaving after one batch, with more in flight, shuts down cleanly
    _same(next(it), next(iter(j)))
    it.close()


def test_prefetcher_matches_jax():
    assert list(TPF.Prefetcher(range(7), depth=2)) == list(JPF.Prefetcher(range(7), depth=2))

    def broken():
        yield 1
        raise KeyError("stream")

    with pytest.raises(KeyError):
        list(TPF.Prefetcher(broken()))


# ---------------------------------------------------------------------------
# repairs: the on-card RandAugment's ops and GD's crop scale; the optimizer keys
# ---------------------------------------------------------------------------


def _area_fractions(params, h, w):
    _, _, cw, ch = params["box"]
    return (cw.double() * ch.double()) / (h * w)


def test_default_randaug_draws_only_the_reference_ops():
    """10,000 draws of the default subset hold exactly the host's
    DEFAULT_AUGS (each drawn), stored as indices of the 14-op table."""
    assert list(TP.DEFAULT_AUGS) == JR.DEFAULT_AUGS and TP.N_OPS == 14
    params = TP.sample_train_params(torch.Generator().manual_seed(0), 5000, 64, 64)
    drawn = set(params["ops"].reshape(-1).tolist())
    assert params["ops"].numel() == 10000
    assert drawn == {TP.OP_NAMES.index(a) for a in JR.DEFAULT_AUGS}
    assert {TP.OP_NAMES[k] for k in drawn}.isdisjoint({"Color", "Contrast", "Solarize",
                                                       "Posterize"})
    few = TP.sample_train_params(torch.Generator().manual_seed(0), 500, 64, 64,
                                 augs=("Solarize", "Posterize"))
    assert set(few["ops"].reshape(-1).tolist()) == {4, 13}


def test_preprocess_train_at_pretrain_scale_matches_jax_composition():
    """The crop at scale (0.2, 1.0): JAX's random_resized_crop(scale=) from
    a key against the port's crop of the box that key draws, then
    preprocess_train on drawn (0.2, 1.0) params against JAX's per-sample
    composition (crop, flip, the two ops, normalise) on the same draws,
    the ops pinned to ones that threshold nothing after a geometric op."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(10)
    h, w, out = 37, 41, 16
    img = rng.integers(0, 256, (h, w, 3)).astype(np.float32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        ref = JP.random_resized_crop(key, jnp.asarray(img), out, scale=(0.2, 1.0))
        k1, k2, k3, k4 = jax.random.split(key, 4)
        area = h * w * jax.random.uniform(k1, minval=0.2, maxval=1.0)
        aspect = jnp.exp(jax.random.uniform(k2, minval=jnp.log(0.75), maxval=jnp.log(4 / 3)))
        cw = jnp.clip(jnp.sqrt(area * aspect), 8, w).astype(jnp.int32)
        ch = jnp.clip(jnp.sqrt(area / aspect), 8, h).astype(jnp.int32)
        x0 = jax.random.randint(k3, (), 0, jnp.maximum(w - cw, 1))
        y0 = jax.random.randint(k4, (), 0, jnp.maximum(h - ch, 1))
        box = tuple(torch.tensor([int(v)]) for v in (x0, y0, cw, ch))
        got = TP.crop_resize(torch.from_numpy(img)[None], box, out)[0]
        np.testing.assert_allclose(got.numpy() / 255.0, np.asarray(ref) / 255.0, atol=2e-5,
                                   rtol=0, err_msg=f"seed {seed}")
    n, h, w = 6, 40, 36
    pixels = rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8)
    params = TP.sample_train_params(torch.Generator().manual_seed(0), n, h, w,
                                    scale=TP.PRETRAIN_CROP_SCALE)
    params["ops"] = torch.tensor([[3, 9, 1, 11, 0, 12], [8, 10, 7, 2, 1, 0]])
    got = TP.preprocess_train(torch.from_numpy(pixels), out, params=params)
    jops = JP.make_randaug_ops(0.7)
    mean, std = jnp.asarray(JP.CLIP_MEAN), jnp.asarray(JP.CLIP_STD)
    for i in range(n):
        x0, y0, cw, ch = (int(t[i]) for t in params["box"])
        im = jnp.asarray(pixels[i], jnp.float32)
        ys = y0 + (jnp.arange(out) * ch) // out
        xs = x0 + (jnp.arange(out) * cw) // out
        im = JP._resize(im[ys][:, xs], (out, out))
        if bool(params["flip"][i]):
            im = im[:, ::-1]
        for r in range(2):
            im = jops[int(params["ops"][r, i])](im, jnp.float32(float(params["signs"][r, i])))
        ref = (im / 255.0 - mean) / std
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref),
                                   atol=2e-5 / min(TP.CLIP_STD), rtol=0, err_msg=f"sample {i}")


def test_gd_device_preprocess_crops_at_pretrain_scale():
    """GD's DevicePreprocess draws its crop area in (0.2, 1.0) (the drawn
    boxes reach below half the image); the fine-tunes' default stays (0.5,
    1.0); the wrapped step sees exactly preprocess_train of those draws."""
    conf = tcfg.Config({"device_preprocess": True, "image_res": 16})
    step = TG.build_step(conf, None, None, teacher=None)
    assert isinstance(step, TC.DevicePreprocess) and step.scale == (0.2, 1.0)
    assert TC.DevicePreprocess(None, 16).scale == TP.CROP_SCALE == (0.5, 1.0)
    n, side = 2000, 257
    gd = _area_fractions(TP.sample_train_params(torch.Generator().manual_seed(1), n, side,
                                                side, scale=step.scale), side, side)
    ft = _area_fractions(TP.sample_train_params(torch.Generator().manual_seed(1), n, side,
                                                side), side, side)
    assert gd.min() >= 0.19 and gd.min() < 0.22 and (gd < 0.5).float().mean() > 0.25
    assert ft.min() >= 0.49 and gd.max() <= 1.0 and ft.max() <= 1.0
    seen = {}
    step.step = lambda state, batch, generator: seen.update(batch)
    pixels = torch.randint(0, 256, (3, 19, 19, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(2))
    step(None, {"image": pixels}, torch.Generator().manual_seed(3))
    drawn = TP.sample_train_params(torch.Generator().manual_seed(3), 3, 19, 19,
                                   scale=(0.2, 1.0))
    assert torch.equal(seen["image"], TP.preprocess_train(pixels, 16, params=drawn))


OPTIMIZER_BUILDERS = {"common": TC.build_optimizers, "vqa": TDvqa.build_optimizers,
                      "captioning": TDcap.build_optimizers, "nlvr": TDnlvr.build_optimizers,
                      "grounding": TDgr.build_optimizers}


@pytest.mark.parametrize("key", ["GRAD_ACCUMULATE_STEPS", "skip_nonfinite_updates"])
@pytest.mark.parametrize("task", list(OPTIMIZER_BUILDERS))
def test_build_optimizers_refuses_keys_not_ported(task, key):
    """Gradient accumulation and the skip of non-finite updates are not
    ported yet: every task's build_optimizers raises and names the key
    rather than train without it; accumulation 1 and skip 0 build."""
    params = {"w": torch.zeros(3, requires_grad=True)}
    conf = {"optimizer": {"lr": 1e-4}, "accelerator": {"GRAD_ACCUMULATE_STEPS": 1},
            "skip_nonfinite_updates": 0}
    assert len(OPTIMIZER_BUILDERS[task](params, tcfg.Config(conf), 10)) == 3
    if key == "GRAD_ACCUMULATE_STEPS":
        conf["accelerator"] = {"GRAD_ACCUMULATE_STEPS": 4}
    else:
        conf[key] = 3
    with pytest.raises(ValueError, match=key):
        OPTIMIZER_BUILDERS[task](params, tcfg.Config(conf), 10)
