"""Two-stage retrieval evaluation: ITC shortlist -> ITM k_test rerank
(port of efficientvlm_tpu/evaluation/retrieval.py).

- features are extracted in fixed-size batches;
- the rerank keeps the feature banks on the device (uploaded once, cast to
  the compute dtype) and scores `rows_per_call` query rows per call, moving
  only indices from the host;
- i2t chunks keep the image rows unexpanded: each image's cross K/V is
  shared by its k candidate texts (grouped K/V);
- t2i chunks read a cross-K/V bank: each image's cross K/V of every cross
  layer, projected once a pass before the t2i chunks (cross_kv_bank), read
  by candidate index inside the fused cross kernel,
  so no image row is copied and no pair projects K/V. Where the bank does
  not fit (kv_bank_fits: half the device memory free) or the fused
  sublayers do not run, the chunks expand the candidate images and project
  each pair's K/V in the call, as t2i_chunk does without a bank;
- rank sharding: each rank scores a contiguous row range, -100 elsewhere;
  the caller sums the matrices across ranks. Each rank builds the whole
  bank: its rows may pick any image.

Spans (train/profiler.span): evlm.eval.encode_texts and .encode_images,
each with evlm.encode.upload and .fetch inside; evlm.eval.rerank (the
whole of retrieval_scores) with evlm.rerank.bank (the banks' uploads and
casts), .kv_bank (the cross-K/V bank's projections), .shortlist (the ITC
similarities, a chunk's argsort and its index uploads), .chunk (the
chunk's launches), .fetch (its scores to the host, the chunk's sync) and
.scatter (the writes into the score matrices); evlm.eval.recall
(itm_eval). `copied_bytes` counts the bytes of every upload ("h2d") and
fetch ("d2h") above, always, and `t2i_chunks` the t2i chunks that read a
bank ("bank") or projected their pairs' K/V ("projected"); read both as
differences.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..models import bert as B
from ..models.xvlm import XVLM, mlp_head_apply
from ..train.profiler import span

copied_bytes = {"h2d": 0, "d2h": 0}
t2i_chunks = {"bank": 0, "projected": 0}


def _device(params) -> torch.device:
    return params["itm_head"]["fc1"]["bias"].device


def _upload(x: np.ndarray, dev) -> torch.Tensor:
    copied_bytes["h2d"] += x.nbytes
    return torch.as_tensor(x, device=dev)


def _numpy(t: torch.Tensor) -> np.ndarray:
    out = t.float().cpu().numpy()
    copied_bytes["d2h"] += out.nbytes
    return out


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
    with span("evlm.eval.encode_texts"), torch.inference_mode():
        for i in range(0, text_ids.shape[0], batch_size):
            with span("evlm.encode.upload"):
                ids = _upload(text_ids[i:i + batch_size], dev)
                atts = _upload(text_atts[i:i + batch_size], dev)
            h = model.get_text_embeds(params, ids, atts, zs=zs, dtype=dtype,
                                      impl=impl)["last_hidden"]
            with span("evlm.encode.fetch"):
                feats.append(_numpy(h))
            e = model.get_features(params, text_embeds=h, dtype=dtype)
            with span("evlm.encode.fetch"):
                embeds.append(_numpy(e))
        return np.concatenate(feats), np.concatenate(embeds)


def encode_images(model: XVLM, params, image_batches, *, zs=None, dtype=None,
                  impl: str = "fused"):
    """image_batches: iterable of [B,H,W,3] arrays. Returns (image_feats
    [N,S,D], image_embeds [N,E]) as numpy."""
    dev = _device(params)
    feats, embeds = [], []
    with span("evlm.eval.encode_images"), torch.inference_mode():
        for img in image_batches:
            with span("evlm.encode.upload"):
                x = _upload(img, dev)
            h, _, _ = model.get_vision_embeds(params, x, zs=zs, dtype=dtype, impl=impl)
            with span("evlm.encode.fetch"):
                feats.append(_numpy(h))
            e = model.get_features(params, image_embeds=h, dtype=dtype)
            with span("evlm.encode.fetch"):
                embeds.append(_numpy(e))
        return np.concatenate(feats), np.concatenate(embeds)


def itm_rerank_scores(model: XVLM, params, img_rows, txt_rows, txt_atts, rows: int, k: int,
                      *, kv_bank: Optional[list] = None, kv_rows: Optional[torch.Tensor] = None,
                      zs=None, dtype=None, impl: str = "fused") -> torch.Tensor:
    """The rerank chunk: ITM logits [rows, k] over candidate pairs.
    txt_rows/txt_atts are [rows*k], k candidates per row, contiguous by
    row. img_rows may be unexpanded [rows] (grouped K/V: each image's cross
    K/V serves its k texts) or expanded [rows*k]; or the bank's images
    [N, S, D] with kv_bank (their cross K/V, cross_kv_bank) and kv_rows
    (int32 [rows*k]): pair j reads image kv_rows[j]'s K/V from the bank,
    and of img_rows only S is read."""
    if kv_bank is None:
        groups, enc, n = txt_rows.shape[0] // img_rows.shape[0], img_rows, img_rows.shape[0]
    else:
        groups, enc, n = 1, None, txt_rows.shape[0]
    img_atts = torch.ones((n, img_rows.shape[1]), dtype=torch.int32, device=img_rows.device)
    out = model.get_cross_embeds(params, enc, img_atts, text_embeds=txt_rows,
                                 text_atts=txt_atts, zs=zs, encoder_groups=groups,
                                 cross_kv=kv_bank, kv_rows=kv_rows, dtype=dtype, impl=impl)
    logits = mlp_head_apply(params["itm_head"], out["last_hidden"][:, 0], dtype=dtype)
    return logits[:, 1].reshape(rows, k)


def i2t_chunk(model, params, img_bank, txt_bank, att_bank, row_idx, cand_idx, **kw):
    """Image rows stay unexpanded [R]; candidate texts [R*k]."""
    r, k = cand_idx.shape
    flat = cand_idx.reshape(-1)
    return itm_rerank_scores(model, params, img_bank[row_idx], txt_bank[flat],
                             att_bank[flat], r, k, **kw)


def t2i_chunk(model, params, img_bank, txt_bank, att_bank, row_idx, cand_idx, *,
              kv_bank: Optional[list] = None, **kw):
    """Each text repeated k times; its candidate images read from kv_bank
    (cross_kv_bank of img_bank) by index, or without a bank expanded [R*k]
    and their K/V projected in the call."""
    r, k = cand_idx.shape
    txt = txt_bank[row_idx].repeat_interleave(k, 0)
    atts = att_bank[row_idx].repeat_interleave(k, 0)
    if kv_bank is None:
        t2i_chunks["projected"] += 1
        return itm_rerank_scores(model, params, img_bank[cand_idx.reshape(-1)], txt, atts, r, k,
                                 **kw)
    t2i_chunks["bank"] += 1
    return itm_rerank_scores(model, params, img_bank, txt, atts, r, k, kv_bank=kv_bank,
                             kv_rows=cand_idx.reshape(-1).to(torch.int32), **kw)


def kv_bank_fits(bank_bytes: int, free_bytes: int) -> bool:
    """The cross-K/V bank is built when it takes at most half the memory
    free on its device; otherwise each t2i chunk projects its pairs' K/V."""
    return 2 * bank_bytes <= free_bytes


def _free_bytes(dev: torch.device) -> int:
    """The device's free memory as CUDA reports it, or the host's
    available memory for a CPU bank."""
    if dev.type == "cuda":
        return torch.cuda.mem_get_info(dev)[0]
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def cross_kv_bank(model: XVLM, params, img_bank: torch.Tensor, *,
                  impl: str = "fused") -> Optional[list]:
    """The t2i rerank's cross-K/V bank: every image's K/V of every cross
    layer, projected once (bert.precompute_cross_kv(rows=True)) over
    img_bank [N, S, D] in its dtype. None where the chunks cannot read one
    (bert.cross_kv_bank_width) or where it does not fit (kv_bank_fits; its
    bytes from the shapes)."""
    width = B.cross_kv_bank_width(params["text"], model.text_cfg, impl)
    if width is None:
        return None
    n, s = img_bank.shape[:2]
    if not kv_bank_fits(2 * n * s * width * img_bank.element_size(),
                        _free_bytes(img_bank.device)):
        return None
    with span("evlm.rerank.kv_bank"):
        return B.precompute_cross_kv(params["text"], model.text_cfg, img_bank, rows=True)


def retrieval_scores(model: XVLM, params, image_feats: np.ndarray, image_embeds: np.ndarray,
                     text_feats: np.ndarray, text_atts: np.ndarray, text_embeds: np.ndarray,
                     *, zs=None, k_test: int = 256, rank: int = 0, world_size: int = 1,
                     dtype=None, impl: str = "fused",
                     rows_per_call: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (score_matrix_i2t [Ni,Nt], score_matrix_t2i [Nt,Ni]) with this
    rank's rows filled and -100 elsewhere."""
    with span("evlm.eval.rerank"):
        n_img, n_txt = image_embeds.shape[0], text_embeds.shape[0]
        # every candidate index is a column of the similarities, so a row of
        # the banks: the chunks read them on the device unchecked
        if image_feats.shape[0] != n_img or text_feats.shape[0] != n_txt:
            raise ValueError(f"retrieval_scores: {image_feats.shape[0]} image and "
                             f"{text_feats.shape[0]} text rows for {n_img} and {n_txt} embeddings")
        with span("evlm.rerank.shortlist"):
            sims = image_embeds @ text_embeds.T  # [Ni, Nt]
        dev = _device(params)
        feat_dt = dtype or torch.float32
        with span("evlm.rerank.bank"):
            img_bank = _upload(image_feats, dev).to(feat_dt)
            txt_bank = _upload(text_feats, dev).to(feat_dt)
            att_bank = _upload(text_atts, dev).to(torch.int32)

        def shard_range(n):
            step = n // world_size + 1
            start = rank * step
            return start, min(n, start + step)

        def run(chunk_fn, sims_dir, n_rows, k, kv_bank=None):
            score = np.full((n_rows, sims_dir.shape[1]), -100.0, np.float32)
            s, e = shard_range(n_rows)
            rows = np.arange(s, e)
            for c0 in range(0, len(rows), rows_per_call):
                chunk = rows[c0:c0 + rows_per_call]
                if len(chunk) < rows_per_call:  # pad to the fixed chunk shape
                    chunk = np.concatenate([chunk,
                                            np.repeat(chunk[-1:], rows_per_call - len(chunk))])
                with span("evlm.rerank.shortlist"):
                    cand = np.argsort(-sims_dir[chunk], axis=1)[:, :k]
                    row_idx = _upload(chunk, dev)
                    # the bank form reads its rows as int32
                    cand_idx = _upload(cand if kv_bank is None else cand.astype(np.int32), dev)
                with span("evlm.rerank.chunk"):
                    scores = chunk_fn(model, params, img_bank, txt_bank, att_bank, row_idx,
                                      cand_idx, zs=zs, dtype=dtype, impl=impl, kv_bank=kv_bank)
                with span("evlm.rerank.fetch"):
                    out = _numpy(scores)
                with span("evlm.rerank.scatter"):
                    for j, i in enumerate(rows[c0:c0 + rows_per_call]):
                        score[i, cand[j]] = out[j]
            return score

        with torch.inference_mode():
            score_i2t = run(i2t_chunk, sims, n_img, min(k_test, n_txt))
            kv_bank = cross_kv_bank(model, params, img_bank, impl=impl)
            score_t2i = run(t2i_chunk, sims.T, n_txt, min(k_test, n_img), kv_bank=kv_bank)
        return score_i2t, score_t2i


def itm_eval(scores_i2t: np.ndarray, scores_t2i: np.ndarray, txt2img, img2txt) -> dict:
    """R@1/5/10 both directions."""
    with span("evlm.eval.recall"):
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
