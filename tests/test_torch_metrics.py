"""Port parity of the evaluation metrics against the JAX package, on the
CPU: VQA accuracy (the official leave-one-out protocol and its breakdown),
the caption metrics (PTB tokenization, BLEU-1..4, CIDEr-D, ROUGE-L, the
Porter stemmer, METEOR, coco_caption_eval) over synthesized captions and
tests/fixtures_caption_golden.json, and the grounding evaluation (the
RefCOCO maps read from files, the bicubic upsampling, the proposal
ranking, the mask and box scores and their VLUE variants). Scores agree
within 1e-12; strings, ranks and boxes exactly.
"""

import json
import os
import pickle

import numpy as np
import pytest

from efficientvlm_tpu.evaluation import caption_metrics as JCM
from efficientvlm_tpu.evaluation import grounding as JG
from efficientvlm_tpu.evaluation import vqa as JV
from efficientvlm_tpu_torch.evaluation import caption_metrics as TCM
from efficientvlm_tpu_torch.evaluation import grounding as TG
from efficientvlm_tpu_torch.evaluation import vqa as TV

TOL = 1e-12
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures_caption_golden.json")


def _close(a, b, what=""):
    """Nested scores within TOL; other leaves equal."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (what, set(a) ^ set(b))
        for k in a:
            _close(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{what}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= TOL, (what, a, b)
    else:
        assert a == b, (what, a, b)


# ---------------------------------------------------------------------------
# VQA
# ---------------------------------------------------------------------------

ANSWERS = ["A Dog!", "two", "isnt", "the cat's toy", "3,000", "yes.", "it's 5 o'clock",
           "left/right", "  Red  ", "an apple; a pear", "none", "ten dollars", "1.5",
           "well-known", "x=y", "dont know"]


@pytest.mark.parametrize("ans", ANSWERS)
def test_normalize_answer_matches_jax(ans):
    assert TV.normalize_answer(ans) == JV.normalize_answer(ans)
    assert TV.process_punctuation(ans) == JV.process_punctuation(ans)
    assert TV.process_digit_article(ans) == JV.process_digit_article(ans)


def test_vqa_accuracy_and_breakdown_match_jax():
    """Unanimous and split annotators, digits against words, punctuation,
    results for unknown questions; the breakdown by question and answer
    type at 2 and 4 decimals."""
    rng = np.random.default_rng(0)
    pool = ["dog", "2", "two", "cat", "yes", "no", "red", "isn't", "1.5", "a dog"]
    annotations = {q: [pool[k] for k in rng.integers(0, len(pool), 10)] for q in range(40)}
    annotations[40] = ["dog"] * 10
    annotations[41] = ["dog"] * 8 + ["cat"] * 2
    results = [{"question_id": q, "answer": ANSWERS[q % len(ANSWERS)] if q % 3 else
                annotations[q][0]} for q in range(42)] + [{"question_id": 99, "answer": "x"}]
    _close(TV.vqa_accuracy(results, annotations), JV.vqa_accuracy(results, annotations))
    qtypes = {q: ["what", "how many", "is the"][q % 3] for q in range(42)}
    atypes = {q: ["other", "number", "yes/no"][q % 3] for q in range(0, 42, 2)}
    for n in (2, 4):
        _close(TV.vqa_accuracy_breakdown(results, annotations, qtypes, atypes, n=n),
               JV.vqa_accuracy_breakdown(results, annotations, qtypes, atypes, n=n))
    _close(TV.vqa_accuracy_breakdown(results, annotations),
           JV.vqa_accuracy_breakdown(results, annotations))
    assert TV.vqa_accuracy([], annotations) == JV.vqa_accuracy([], annotations) == 0.0


# ---------------------------------------------------------------------------
# captions
# ---------------------------------------------------------------------------


def _caption_sets():
    """(name, gts, res): the golden fixture's 20 pairs, and synthesized
    ones with synonyms, paraphrases, stems, repeats and an empty hyp."""
    with open(FIXTURE) as f:
        fix = json.load(f)
    gts = {c["id"]: c["refs"] for c in fix["captions"]}
    res = {c["id"]: [c["hyp"]] for c in fix["captions"]}
    rng = np.random.default_rng(1)
    words = ("a the man woman dog dogs cat kitten riding rides ride horse pony beach sea "
             "ocean next to beside sitting seated on top of above big large picture photo "
             "running runs red ball group of people crowd").split()
    syn_gts, syn_res = {}, {}
    for i in range(24):
        syn_gts[i] = [" ".join(rng.choice(words, rng.integers(3, 11))) for _ in range(
            rng.integers(1, 6))]
        syn_res[i] = [" ".join(rng.choice(words, rng.integers(0 if i == 5 else 1, 12)))]
    syn_res[3] = ["A dog, running -- on the beach!!"]
    syn_gts[3] = ["a dog runs on the beach", "dogs running next to the sea"]
    return [("golden", gts, res), ("synthesized", syn_gts, syn_res)]


@pytest.mark.parametrize("case", [0, 1], ids=["golden", "synthesized"])
def test_caption_metrics_match_jax(case):
    """BLEU-1..4, CIDEr-D (mean and per caption), ROUGE-L and METEOR (the
    table, and the WordNet refusal where nltk's corpus is missing)."""
    _, gts, res = _caption_sets()[case]
    for key in res:
        assert TCM.ptb_tokenize(res[key][0]) == JCM.ptb_tokenize(res[key][0])
    _close(TCM.bleu(gts, res), JCM.bleu(gts, res))
    _close(TCM.bleu(gts, res, max_n=2), JCM.bleu(gts, res, max_n=2))
    _close(TCM.CiderD().compute_score(gts, res), JCM.CiderD().compute_score(gts, res))
    _close(TCM.CiderD(n=2, sigma=3.0).compute_score(gts, res),
           JCM.CiderD(n=2, sigma=3.0).compute_score(gts, res))
    _close(TCM.rouge_l(gts, res), JCM.rouge_l(gts, res))
    _close(TCM.meteor(gts, res), JCM.meteor(gts, res))
    _close(TCM.meteor(gts, res, alpha=0.85, beta=0.2, gamma=0.6),
           JCM.meteor(gts, res, alpha=0.85, beta=0.2, gamma=0.6))
    with pytest.raises(ValueError):
        TCM.meteor(gts, res, synonym_source="auto")
    if TCM._wordnet_or_none() is None:
        with pytest.raises(RuntimeError):
            TCM.meteor(gts, res, synonym_source="wordnet")


def test_coco_caption_eval_matches_jax():
    """The COCO interface over the golden captions with one result missing
    and one for an unknown image, against the fixture's pinned values."""
    _, gts, res = _caption_sets()[0]
    annotations = [{"image_id": k, "caption": c} for k, refs in gts.items() for c in refs]
    results = [{"image_id": k, "caption": v[0]} for k, v in res.items()]
    got = TCM.coco_caption_eval(annotations, results[1:] + [{"image_id": "x",
                                                              "caption": "a dog"}])
    _close(got, JCM.coco_caption_eval(annotations, results[1:] + [{"image_id": "x",
                                                                   "caption": "a dog"}]))
    full = TCM.coco_caption_eval(annotations, results)
    with open(FIXTURE) as f:
        golden = json.load(f)["golden"]
    for k in ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L", "CIDEr"):
        assert abs(full[k] - golden[k]) < 1e-6, (k, full[k], golden[k])
    assert full["SPICE"] is None and full["METEOR_matcher"] == "table"


def test_porter_stem_and_meteor_alignment_match_jax():
    words = ("caresses ponies ties caress cats feed agreed plastered bled motoring sing "
             "conflated troubled sized hopping tanned falling hissing fizzed failing filing "
             "happy sky relational conditional rational valenci digitizer operator "
             "feudalism decisiveness hopefulness callousness formaliti sensitiviti "
             "sensibiliti triplicate formative formalize electriciti electrical hopeful "
             "goodness revival allowance inference airliner gyroscopic adjustable "
             "defensible irritant replacement adjustment dependent adoption homologou "
             "communism activate angulariti homologous effective bowdlerize a is").split()
    assert [TCM._porter_stem(w) for w in words] == [JCM._porter_stem(w) for w in words]
    pairs = [("a man riding a horse next to the sea", "a guy rides a pony beside the ocean"),
             ("the big dog is running", "a large canine runs"),
             ("in front of a building", "before the edifice"), ("", "a dog"),
             ("a a a", "a")]
    for c, r in pairs:
        ct, rt = TCM.ptb_tokenize(c), TCM.ptb_tokenize(r)
        assert TCM._meteor_match(ct, rt) == JCM._meteor_match(ct, rt)


# ---------------------------------------------------------------------------
# grounding
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def refer(tmp_path_factory):
    """A refs(unc).p pickle and an instances.json of 5 images, 12 refs
    over the three splits (one ref of another split)."""
    d = tmp_path_factory.mktemp("refer")
    rng = np.random.default_rng(2)
    images = [{"id": 10 + i, "height": int(h), "width": int(w)}
              for i, (h, w) in enumerate(rng.integers(40, 90, (5, 2)))]
    anns, refs = [], []
    for r in range(12):
        img = images[r % 5]
        x, y = rng.uniform(0, img["width"] / 2), rng.uniform(0, img["height"] / 2)
        anns.append({"id": 500 + r, "image_id": img["id"],
                     "bbox": [float(x), float(y), float(rng.uniform(5, img["width"] / 2)),
                              float(rng.uniform(5, img["height"] / 2))]})
        refs.append({"ref_id": r, "ann_id": 500 + r, "image_id": img["id"],
                     "split": ["val", "testA", "testB", "train"][r % 4]})
    with open(d / "refs(unc).p", "wb") as f:
        pickle.dump(refs, f)
    with open(d / "instances.json", "w") as f:
        json.dump({"images": images, "annotations": anns}, f)
    return str(d / "refs(unc).p"), str(d / "instances.json")


def _dets(rng, width, height, n=6):
    out = [[float(rng.uniform(-3, width * 0.7)), float(rng.uniform(-3, height * 0.7)),
            float(rng.uniform(2, width * 0.6)), float(rng.uniform(2, height * 0.6))]
           for _ in range(n)]
    return out + [[-2.5, -1.0, 4.0, 3.0]]


def test_grounding_eval_matches_jax(refer):
    """load_refer_maps, then the mask evaluation (int and str image keys,
    a map with no positive mass) and the box evaluation, and their VLUE
    variants."""
    maps_t, maps_j = TG.load_refer_maps(*refer), JG.load_refer_maps(*refer)
    _close(maps_t, maps_j)
    rng = np.random.default_rng(3)
    dets = {}
    for k, (img, (h, w)) in enumerate(maps_t["image_sizes"].items()):
        dets[img if k % 2 else str(img)] = _dets(rng, w, h)
    results = [{"ref_id": r, "pred": rng.random(24 * 24).tolist()} for r in range(12)]
    results[4]["pred"] = (-rng.random(24 * 24)).tolist()
    kw = {k: maps_t[k] for k in ("ref_boxes", "ref_splits", "ref_images", "image_sizes")}
    for alpha in (0.5, 0.25):
        _close(TG.grounding_eval_mask(results, dets, **kw, alpha=alpha),
               JG.grounding_eval_mask(results, dets, **kw, alpha=alpha))
    boxes = [{"ref_id": r, "pred": rng.uniform(0.05, 0.9, 4).tolist(),
              "width": maps_t["image_sizes"][maps_t["ref_images"][r]][1],
              "height": maps_t["image_sizes"][maps_t["ref_images"][r]][0]} for r in range(12)]
    boxes.append({**boxes[0], "pred": [0.3, 0.3, 0.0, 0.0]})
    for thresh in (0.5, 0.1):
        _close(TG.grounding_eval_bbox(boxes, maps_t["ref_boxes"], maps_t["ref_splits"],
                                      iou_thresh=thresh),
               JG.grounding_eval_bbox(boxes, maps_t["ref_boxes"], maps_t["ref_splits"],
                                      iou_thresh=thresh))
    records = [{"ref_id": r, "bbox": maps_t["ref_boxes"][r],
                "height": maps_t["image_sizes"][maps_t["ref_images"][r]][0],
                "width": maps_t["image_sizes"][maps_t["ref_images"][r]][1],
                "dets": _dets(rng, 60, 60)} for r in range(12)]
    _close(TG.grounding_eval_mask_vlue(results, records),
           JG.grounding_eval_mask_vlue(results, records))
    _close(TG.grounding_eval_mask_vlue(results, records, alpha=1.0, mask_size=24),
           JG.grounding_eval_mask_vlue(results, records, alpha=1.0, mask_size=24))
    _close(TG.grounding_eval_bbox_vlue(boxes[:12], records),
           JG.grounding_eval_bbox_vlue(boxes[:12], records))
    assert TG.grounding_eval_mask_vlue([], records) == JG.grounding_eval_mask_vlue([], records)
    assert TG.grounding_eval_bbox_vlue([], records) == {"score": 0.0}


@pytest.mark.parametrize("shape", [(24, 24, 50, 70), (24, 24, 24, 24), (7, 5, 9, 11),
                                   (16, 16, 300, 12)])
def test_resize_bicubic_and_ranking_match_jax(shape):
    """The upsampled map (grown, kept, shrunk, mixed) and the proposal each
    picks, with coordinates off the image on either side."""
    h, w, oh, ow = shape
    rng = np.random.default_rng(4)
    mask = rng.standard_normal((h, w))
    up_t, up_j = TG.resize_bicubic(mask, oh, ow), JG.resize_bicubic(mask, oh, ow)
    assert up_t.dtype == up_j.dtype == np.float64
    np.testing.assert_allclose(up_t, up_j, atol=TOL, rtol=0)
    dets = _dets(rng, ow, oh, 10) + [[ow - 1, oh - 1, 5.0, 5.0]]
    for alpha in (0.0, 0.5, 1.0):
        assert TG.rank_detections(up_t, dets, alpha) == JG.rank_detections(up_j, dets, alpha)
    assert TG.rank_detections(-np.abs(up_t), dets, 0.5) is None


def test_box_iou_and_nlvr_accuracy_match_jax():
    rng = np.random.default_rng(5)
    for _ in range(50):
        a, b = rng.uniform(-5, 50, 4).tolist(), rng.uniform(-5, 50, 4).tolist()
        _close(TG.compute_iou_xywh(a, b), JG.compute_iou_xywh(a, b))
    _close(TG.compute_iou_xywh([0, 0, 0, 0], [1, 1, 0, 0]),
           JG.compute_iou_xywh([0, 0, 0, 0], [1, 1, 0, 0]))
    logits, labels = rng.standard_normal((33, 2)), rng.integers(0, 2, 33)
    _close(TG.nlvr_accuracy(logits, labels), JG.nlvr_accuracy(logits, labels))
