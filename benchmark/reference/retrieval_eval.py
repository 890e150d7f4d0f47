"""The comparison that decides `correct` for a retrieval evaluation cell,
and the control that stands in the program's place to show that the
comparison fails a lower precision.

What the timed path produced, per pass: the image and text ITC features
and the two score matrices of the ITM rerank (each row's k candidates
filled, -100 elsewhere). Compared with the reference (reference/xvlm.py,
f32):

- itc_gap: the largest gap between the pass's ITC similarities (its image
  features times its text features) and the reference's, over every pair
  and pass;
- shortlist_gap: on the sampled rows, how far below the reference's k-th
  best similarity the worst candidate that the pass kept lies (0 when the
  pass kept the reference's k best);
- itm_gap: on the sampled rows, the largest gap between the pass's ITM
  score of a candidate and the reference's score of the same pair;
- malformed_rows: rows of any pass without exactly k finite scores; an
  exact count, limit 0.

The sampled rows are drawn from the run's seed over every pass of the
window, in both directions.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

FILL = -100.0  # the rerank's value outside each row's candidates


def sample_rows(seed: int, passes: int, n_img: int, n_txt: int, i2t: int,
                t2i: int) -> List[Tuple[int, str, int]]:
    """(pass, direction, row) to check: i2t image rows and t2i text rows,
    each direction's draws spread over the passes, no row twice in a pass."""
    rng = np.random.default_rng(seed)
    out = []
    for direction, n, count in (("i2t", n_img, i2t), ("t2i", n_txt, t2i)):
        cells = rng.choice(passes * n, size=min(count, passes * n), replace=False)
        out += [(int(c // n), direction, int(c % n)) for c in sorted(cells)]
    return out


def malformed_rows(matrix: np.ndarray, k: int) -> int:
    filled = matrix != FILL
    bad = (filled.sum(1) != k) | ~np.isfinite(matrix).all(1)
    return int(bad.sum())


def compare(ev, passes: list, rows, k: Tuple[int, int], *, structure: bool = True) -> dict:
    """The numbers of the comparison. passes: per pass (image_feat [Ni, E],
    text_feat [Nt, E], score_i2t [Ni, Nt], score_t2i [Nt, Ni]) as numpy;
    ev: the reference's Evaluation of the same bank; k: (i2t, t2i) candidate
    counts. structure=False leaves malformed_rows out (a control that
    scores the sampled rows only)."""
    sims = ev.sims()
    itc = max(float(np.abs(img @ txt.T - sims).max()) for img, txt, _, _ in passes)
    pairs_img, pairs_txt, got, shortlist = [], [], [], 0.0
    for p, direction, r in rows:
        _, _, s_i2t, s_t2i = passes[p]
        row = s_i2t[r] if direction == "i2t" else s_t2i[r]
        ref_row = sims[r] if direction == "i2t" else sims[:, r]
        kk = k[0] if direction == "i2t" else k[1]
        cand = np.nonzero(row != FILL)[0]
        if cand.size == 0:
            return {"itc_gap": itc, "shortlist_gap": float("inf"), "itm_gap": float("inf"),
                    **({"malformed_rows": float("inf")} if structure else {})}
        kth = np.sort(ref_row)[::-1][min(kk, ref_row.size) - 1]
        shortlist = max(shortlist, float(kth - ref_row[cand].min()))
        if direction == "i2t":
            pairs_img.append(np.full(cand.size, r))
            pairs_txt.append(cand)
        else:
            pairs_img.append(cand)
            pairs_txt.append(np.full(cand.size, r))
        got.append(row[cand])
    ref_scores = ev.scores(np.concatenate(pairs_img), np.concatenate(pairs_txt))
    out = {"itc_gap": itc, "shortlist_gap": max(shortlist, 0.0),
           "itm_gap": float(np.abs(np.concatenate(got) - ref_scores).max())}
    if structure:
        out["malformed_rows"] = float(sum(malformed_rows(s_i2t, k[0]) + malformed_rows(s_t2i, k[1])
                                          for _, _, s_i2t, s_t2i in passes))
    return out


def control_passes(ev, rows, k: Tuple[int, int], n_passes: int) -> list:
    """The control's outputs in the program's form: a Evaluation's features,
    and for the sampled rows its own shortlist (top k of its similarities)
    scored by its own ITM; the other rows hold FILL only."""
    img, txt = ev.image_feat.cpu().numpy(), ev.text_feat.cpu().numpy()
    sims = img @ txt.T
    s_i2t = [np.full(sims.shape, FILL, np.float32) for _ in range(n_passes)]
    s_t2i = [np.full(sims.T.shape, FILL, np.float32) for _ in range(n_passes)]
    for p, direction, r in rows:
        if direction == "i2t":
            cand = np.argsort(-sims[r])[:k[0]]
            s_i2t[p][r, cand] = ev.scores(np.full(cand.size, r), cand)
        else:
            cand = np.argsort(-sims[:, r])[:k[1]]
            s_t2i[p][r, cand] = ev.scores(cand, np.full(cand.size, r))
    return [(img, txt, s_i2t[p], s_t2i[p]) for p in range(n_passes)]
