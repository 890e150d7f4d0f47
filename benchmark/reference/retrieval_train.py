"""The comparison that decides `correct` for a retrieval pruning fine-tune
cell: the program's checked steps against the reference's (reference/
xvlm_train.py) from the same inputs and generator streams. The numbers
compared (limits in benchmark/limits/<cell>.json):

- first_update_flips: the share of the elements of the model's, the gate
  log-alphas' and the multipliers' first gradient (the program's worked out
  from its first moments after one step, mu / (1 - b1)) whose sign is not
  the reference's: the elements that AdamW's first update, lr times that
  sign, moves the other way;
- first_loss_gap: the first step's loss, relative to the reference's;
- change_gap_worst, gate_change_gap_worst: each leaf's change over the
  checked steps, by the worst leaf: the gap between the two norms of a
  leaf, relative to the larger of the reference's norm of that leaf and of
  the median leaf (the model's leaves; the log-alphas with the
  multipliers);
- negatives_positive: hard negatives the program drew that share their
  anchor's image id, or rows without one (the sampling stage that the
  reference takes from the program, checked by itself); an exact count.

For the record, not compared: every step's loss gap, and the first
gradient's norms by the worst and the median leaf. Over 20 seeds these swing by 10-40x from seed
to seed: the ITC and ITM softmaxes (temperature 0.07 and a near-chance
head) turn bf16's rounding of the features into gradients a few percent
apart on some seeds, and Adam's first, sign-like update carries that into
the later steps; the fp8 control then reads no higher than the program's
worst seeds on them (PERF.md).

Leaves whose reference gradient is under a thousandth of the median leaf's
(the MLM head, which the fine-tune's losses never read, moves by weight
decay alone) count for none of the leaf numbers.
"""

from __future__ import annotations

import torch

B1 = 0.9  # AdamW's first-moment decay: after one step mu = (1 - B1) * g


def trainer_side(trainer, losses: list) -> dict:
    """A reference Trainer's checked steps in the program side's form."""
    firsts = {k: o.first_grads for k, o in zip(("params", "loga", "lam"), trainer.opts)}
    return {"losses": losses, "first_grads": firsts, "before": trainer.before,
            "after": {"params": [x.detach() for x in trainer.p_leaves],
                      "loga": [x.detach() for x in trainer.l_leaves],
                      "lam": [x.detach() for x in trainer.lam_leaves]}}


def _norms(xs) -> torch.Tensor:
    return torch.stack([x.detach().float().norm() for x in xs])


def leaf_gaps(got: list, want: list, keep: torch.Tensor) -> torch.Tensor:
    """Per kept leaf | |got| - |want| | / max(|want|, median |want|)."""
    a, b = _norms(got), _norms(want)
    return ((a - b).abs() / torch.maximum(b, b[keep].median()))[keep]


def sign_flips(got: list, want: list, keep: torch.Tensor) -> float:
    """The share of the kept leaves' elements whose first gradient has
    another sign than the reference's: the elements that AdamW's first
    update (lr times the sign, its moments being that one gradient) moves
    the other way."""
    flips = total = 0
    for g, w, k in zip(got, want, keep.tolist()):
        if k:
            flips += int((torch.sign(g.float()) != torch.sign(w.float())).sum())
            total += w.numel()
    return flips / max(total, 1)


def compare(prog: dict, ref: dict, negatives: dict, pool: list) -> dict:
    """prog: {"losses", "first_mu" or "first_grads", "before", "after"};
    ref: trainer_side's. Returns the numbers: the compared ones, and for the
    record the forms that the look set aside (the worst leaf's gradient,
    every step's loss)."""
    gap = lambda p, r: abs(p - r) / abs(r)  # noqa: E731
    out = {"first_loss_gap": gap(prog["losses"][0], ref["losses"][0]),
           "loss_gap_all_steps": max(gap(p, r) for p, r in zip(prog["losses"], ref["losses"]))}
    grads = prog.get("first_grads") or {k: [m / (1 - B1) for m in v]
                                        for k, v in prog["first_mu"].items()}
    rg = ref["first_grads"]
    keep_p = _norms(rg["params"]) >= 1e-3 * _norms(rg["params"]).median()
    gate_ref = rg["loga"] + rg["lam"]
    keep_g = _norms(gate_ref) >= 1e-3 * _norms(gate_ref).median()
    change = lambda side, k: [a - b for a, b in zip(side["after"][k], side["before"][k])]  # noqa
    for name, g in (
            ("grad_gap", leaf_gaps(grads["params"], rg["params"], keep_p)),
            ("gate_grad_gap", leaf_gaps(grads["loga"] + grads["lam"], gate_ref, keep_g)),
            ("change_gap", leaf_gaps(change(prog, "params"), change(ref, "params"), keep_p)),
            ("gate_change_gap", leaf_gaps(change(prog, "loga") + change(prog, "lam"),
                                          change(ref, "loga") + change(ref, "lam"), keep_g))):
        out[name + "_median"], out[name + "_worst"] = float(g.median()), float(g.max())
    out["first_update_flips"] = sign_flips(grads["params"] + grads["loga"] + grads["lam"],
                                           rg["params"] + gate_ref,
                                           torch.cat([keep_p, keep_g]))
    bad = 0
    for who in ("teacher", "student"):
        for (neg_image, neg_text), batch in zip(negatives[who], pool):
            idx = batch["idx"]
            if neg_image.shape != idx.shape or neg_text.shape != idx.shape:
                bad += 2 * idx.shape[0]  # not one negative a row
                continue
            bad += int((idx[neg_image] == idx).sum()) + int((idx[neg_text] == idx).sum())
    out["negatives_positive"] = float(bad)
    return out


def worst_leaves(prog: dict, ref: dict, cfg: dict, top: int = 4) -> None:
    """Prints, on stderr, the leaves with the largest gaps of the first
    gradient and of the change, with their paths and norms (a look at what
    sets the worst leaf)."""
    import sys

    from benchmark import params as P

    paths = ["/".join(map(str, p)) for p, _ in P._leaves(P.xvlm_layout(cfg, mlm_head=True))]
    grads = prog.get("first_grads") or {k: [m / (1 - B1) for m in v]
                                        for k, v in prog["first_mu"].items()}
    for what, got, want in (
            ("grad", grads["params"], ref["first_grads"]["params"]),
            ("change", [a - b for a, b in zip(prog["after"]["params"], prog["before"]["params"])],
             [a - b for a, b in zip(ref["after"]["params"], ref["before"]["params"])])):
        a, b = _norms(got), _norms(want)
        rg = _norms(ref["first_grads"]["params"])
        keep = rg >= 1e-3 * rg.median()
        gap = ((a - b).abs() / torch.maximum(b, b[keep].median())) * keep
        for i in gap.argsort(descending=True)[:top].tolist():
            print(f"{what} gap {float(gap[i]):.4g} {paths[i]} numel {got[i].numel()} "
                  f"prog {float(a[i]):.4g} ref {float(b[i]):.4g} "
                  f"median {float(b[keep].median()):.4g}", file=sys.stderr, flush=True)
