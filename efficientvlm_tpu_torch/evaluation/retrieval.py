"""Two-stage retrieval evaluation: ITC shortlist -> ITM k_test rerank
(port of efficientvlm_tpu/evaluation/retrieval.py).

- features are extracted in fixed-size batches;
- the rerank keeps the feature banks on the device (uploaded once, cast to
  the compute dtype) and scores `rows_per_call` query rows per call, moving
  only indices from the host;
- i2t chunks keep the image rows unexpanded: each image's cross K/V is
  shared by its k candidate texts (grouped K/V); t2i chunks expand the
  candidate images;
- rank sharding: each rank scores a contiguous row range, -100 elsewhere;
  the caller sums the matrices across ranks.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..models.xvlm import XVLM, mlp_head_apply


def _device(params) -> torch.device:
    return params["itm_head"]["fc1"]["kernel"].device


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


def retrieval_forward(model: XVLM, params, image, text_ids, text_atts, *, zs=None, dtype=None,
                      impl: str = "fused"):
    """The eval unit of work: image encode + text encode + ITC features +
    fusion encode + ITM head. Returns (image_feat, text_feat, itm_logits)."""
    image_embeds, image_atts, _ = model.get_vision_embeds(params, image, zs=zs, dtype=dtype,
                                                          impl=impl)
    text_embeds = model.get_text_embeds(params, text_ids, text_atts, zs=zs, dtype=dtype,
                                        impl=impl)["last_hidden"]
    image_feat, text_feat = model.get_features(params, image_embeds, text_embeds, dtype=dtype)
    cross = model.get_cross_embeds(params, image_embeds, image_atts, text_embeds=text_embeds,
                                   text_atts=text_atts, zs=zs, dtype=dtype, impl=impl)
    itm = mlp_head_apply(params["itm_head"], cross["last_hidden"][:, 0], dtype=dtype)
    return image_feat, text_feat, itm


def encode_texts(model: XVLM, params, text_ids: np.ndarray, text_atts: np.ndarray, *,
                 zs=None, batch_size: int = 256, dtype=None, impl: str = "fused"):
    """Returns (text_feats [N,T,D] last hidden, text_embeds [N,E]) as numpy."""
    dev = _device(params)
    feats, embeds = [], []
    with torch.inference_mode():
        for i in range(0, text_ids.shape[0], batch_size):
            ids = torch.as_tensor(text_ids[i:i + batch_size], device=dev)
            atts = torch.as_tensor(text_atts[i:i + batch_size], device=dev)
            h = model.get_text_embeds(params, ids, atts, zs=zs, dtype=dtype,
                                      impl=impl)["last_hidden"]
            feats.append(_numpy(h))
            embeds.append(_numpy(model.get_features(params, text_embeds=h, dtype=dtype)))
    return np.concatenate(feats), np.concatenate(embeds)


def encode_images(model: XVLM, params, image_batches, *, zs=None, dtype=None,
                  impl: str = "fused"):
    """image_batches: iterable of [B,H,W,3] arrays. Returns (image_feats
    [N,S,D], image_embeds [N,E]) as numpy."""
    dev = _device(params)
    feats, embeds = [], []
    with torch.inference_mode():
        for img in image_batches:
            h, _, _ = model.get_vision_embeds(params, torch.as_tensor(img, device=dev),
                                              zs=zs, dtype=dtype, impl=impl)
            feats.append(_numpy(h))
            embeds.append(_numpy(model.get_features(params, image_embeds=h, dtype=dtype)))
    return np.concatenate(feats), np.concatenate(embeds)


def itm_rerank_scores(model: XVLM, params, img_rows, txt_rows, txt_atts, rows: int, k: int,
                      *, zs=None, dtype=None, impl: str = "fused") -> torch.Tensor:
    """The rerank chunk: ITM logits [rows, k] over candidate pairs.
    txt_rows/txt_atts are [rows*k], k candidates per row, contiguous by
    row. img_rows may be unexpanded [rows] (grouped K/V: each image's cross
    K/V serves its k texts) or expanded [rows*k]."""
    groups = txt_rows.shape[0] // img_rows.shape[0]
    img_atts = torch.ones(img_rows.shape[:2], dtype=torch.int32, device=img_rows.device)
    out = model.get_cross_embeds(params, img_rows, img_atts, text_embeds=txt_rows,
                                 text_atts=txt_atts, zs=zs, encoder_groups=groups,
                                 dtype=dtype, impl=impl)
    logits = mlp_head_apply(params["itm_head"], out["last_hidden"][:, 0], dtype=dtype)
    return logits[:, 1].reshape(rows, k)


def i2t_chunk(model, params, img_bank, txt_bank, att_bank, row_idx, cand_idx, **kw):
    """Image rows stay unexpanded [R]; candidate texts [R*k]."""
    r, k = cand_idx.shape
    flat = cand_idx.reshape(-1)
    return itm_rerank_scores(model, params, img_bank[row_idx], txt_bank[flat],
                             att_bank[flat], r, k, **kw)


def t2i_chunk(model, params, img_bank, txt_bank, att_bank, row_idx, cand_idx, **kw):
    """Candidate images expanded [R*k]; each text repeated k times."""
    r, k = cand_idx.shape
    return itm_rerank_scores(model, params, img_bank[cand_idx.reshape(-1)],
                             txt_bank[row_idx].repeat_interleave(k, 0),
                             att_bank[row_idx].repeat_interleave(k, 0), r, k, **kw)


def retrieval_scores(model: XVLM, params, image_feats: np.ndarray, image_embeds: np.ndarray,
                     text_feats: np.ndarray, text_atts: np.ndarray, text_embeds: np.ndarray,
                     *, zs=None, k_test: int = 256, rank: int = 0, world_size: int = 1,
                     dtype=None, impl: str = "fused",
                     rows_per_call: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (score_matrix_i2t [Ni,Nt], score_matrix_t2i [Nt,Ni]) with this
    rank's rows filled and -100 elsewhere."""
    n_img, n_txt = image_embeds.shape[0], text_embeds.shape[0]
    sims = image_embeds @ text_embeds.T  # [Ni, Nt]
    dev = _device(params)
    feat_dt = dtype or torch.float32
    img_bank = torch.as_tensor(image_feats, device=dev).to(feat_dt)
    txt_bank = torch.as_tensor(text_feats, device=dev).to(feat_dt)
    att_bank = torch.as_tensor(text_atts, device=dev).to(torch.int32)

    def shard_range(n):
        step = n // world_size + 1
        start = rank * step
        return start, min(n, start + step)

    def run(chunk_fn, sims_dir, n_rows, k):
        score = np.full((n_rows, sims_dir.shape[1]), -100.0, np.float32)
        s, e = shard_range(n_rows)
        rows = np.arange(s, e)
        for c0 in range(0, len(rows), rows_per_call):
            chunk = rows[c0:c0 + rows_per_call]
            if len(chunk) < rows_per_call:  # pad to the fixed chunk shape
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], rows_per_call - len(chunk))])
            cand = np.argsort(-sims_dir[chunk], axis=1)[:, :k]
            out = _numpy(chunk_fn(model, params, img_bank, txt_bank, att_bank,
                                  torch.as_tensor(chunk, device=dev),
                                  torch.as_tensor(cand, device=dev),
                                  zs=zs, dtype=dtype, impl=impl))
            for j, i in enumerate(rows[c0:c0 + rows_per_call]):
                score[i, cand[j]] = out[j]
        return score

    with torch.inference_mode():
        score_i2t = run(i2t_chunk, sims, n_img, min(k_test, n_txt))
        score_t2i = run(t2i_chunk, sims.T, n_txt, min(k_test, n_img))
    return score_i2t, score_t2i


def itm_eval(scores_i2t: np.ndarray, scores_t2i: np.ndarray, txt2img, img2txt) -> dict:
    """R@1/5/10 both directions."""
    ranks = np.zeros(scores_i2t.shape[0])
    for index, score in enumerate(scores_i2t):
        inds = np.argsort(score)[::-1]
        rank = 1e20
        for i in img2txt[index]:
            rank = min(rank, np.where(inds == i)[0][0])
        ranks[index] = rank
    tr1, tr5, tr10 = [100.0 * (ranks < k).mean() for k in (1, 5, 10)]

    ranks = np.zeros(scores_t2i.shape[0])
    for index, score in enumerate(scores_t2i):
        inds = np.argsort(score)[::-1]
        ranks[index] = np.where(inds == txt2img[index])[0][0]
    ir1, ir5, ir10 = [100.0 * (ranks < k).mean() for k in (1, 5, 10)]

    tr_mean = (tr1 + tr5 + tr10) / 3
    ir_mean = (ir1 + ir5 + ir10) / 3
    return {
        "txt_r1": tr1, "txt_r5": tr5, "txt_r10": tr10, "txt_r_mean": tr_mean,
        "img_r1": ir1, "img_r5": ir5, "img_r10": ir10, "img_r_mean": ir_mean,
        "r_mean": (tr_mean + ir_mean) / 2,
    }
