"""The retrieval pruning fine-tune step (port of the retrieval half of
efficientvlm_tpu/train/steps.py): the frozen teacher's forward with its KD
taps, the student's forward with stochastic L0 gates, the KD, ITC, ITM and
Lagrangian losses, one backward, and the three AdamW updates with the
log-alpha clamp.

JAX traces all of it into one program whose dead-code elimination drops the
teacher taps no loss reads. Eager PyTorch keeps what it computes, so the
teacher runs under torch.no_grad and its taps are cut to the ones the
student is matched with (subset_teacher_taps) right after its forward, as
JAX's split step does. The step's parts are methods, so a caller can time
them: teacher_forward, loss_and_grads (student forward + backward), apply.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from ..pruning.hard_concrete import constrain_loga
from ..pruning.l0_module import L0Module
from . import distill as D
from .optim import tree_leaves


@dataclass
class TrainState:
    params: Any
    loga: dict
    lam: dict
    opt_state: dict
    l0_state: dict
    lam_state: dict
    step: int


def init_train_state(params, l0_params: dict, optimizers) -> TrainState:
    """The state over `params` (f32 masters, updated in place) and the gate
    params; every optimizer's moments start at zero."""
    opt, l0_opt, lam_opt = optimizers
    lam = {"lambda_1": l0_params["lambda_1"], "lambda_2": l0_params["lambda_2"]}
    return TrainState(params=params, loga=l0_params["loga"], lam=lam,
                      opt_state=opt.init(tree_leaves(params)),
                      l0_state=l0_opt.init(tree_leaves(l0_params["loga"])),
                      lam_state=lam_opt.init(tree_leaves(lam)), step=0)


def apply_updates_3way(state: TrainState, grads, optimizers) -> TrainState:
    """The main, L0 and Lagrangian updates in place, then the loga clamp
    (the reference's constrain_parameters); grads = (params, loga, λ) lists
    in tree order."""
    opt, l0_opt, lam_opt = optimizers
    gp, gl, glam = grads
    opt.step(tree_leaves(state.params), gp, state.opt_state)
    loga = tree_leaves(state.loga)
    l0_opt.step(loga, gl, state.l0_state)
    with torch.no_grad():
        for t in loga:
            t.copy_(constrain_loga(t))
    lam_opt.step(tree_leaves(state.lam), glam, state.lam_state)
    state.step += 1
    return state


def retrieval_kd_losses(student_outputs: dict, teacher_outputs: dict, *,
                        temperature: float = 1.0) -> dict:
    """The KD menu of the reference's retrieval fine-tune (weights 0.2 /
    0.5 / 0.33)."""
    sh, th = student_outputs["hidden_dict"], teacher_outputs["hidden_dict"]
    sa, ta = student_outputs["attention_dict"], teacher_outputs["attention_dict"]
    sc, tc = student_outputs["cross_attention_dict"], teacher_outputs["cross_attention_dict"]
    sl, tl = student_outputs["logits_dict"], teacher_outputs["logits_dict"]

    text_h = D.kd_list(sh["text_hidden_states"], th["text_hidden_states"])
    text_a = D.kd_list(sa["text_attentions"], ta["text_attentions"], is_attn=True)
    img_h = D.kd_list(sh["image_hidden_states"], th["image_hidden_states"], is_img=True)
    img_a = D.kd_list(sa["image_attentions"], ta["image_attentions"], is_attn=True)
    pos_h = D.kd_list(sh["itm_pos_hidden_states"], th["itm_pos_hidden_states"])
    neg_h = D.kd_list(sh["itm_neg_hidden_states"], th["itm_neg_hidden_states"])
    pos_a = D.kd_list(sa["itm_pos_attentions"], ta["itm_pos_attentions"], is_attn=True)
    neg_a = D.kd_list(sa["itm_neg_attentions"], ta["itm_neg_attentions"], is_attn=True)
    pos_x = D.kd_list(sc["itm_pos_cross_attentions"], tc["itm_pos_cross_attentions"],
                      is_attn=True)
    neg_x = D.kd_list(sc["itm_neg_cross_attentions"], tc["itm_neg_cross_attentions"],
                      is_attn=True)
    itm_logits = D.soft_cross_entropy(sl["itm_head_logits"] / temperature,
                                      tl["itm_head_logits"] / temperature)

    loss_text_kd = text_h + text_a
    loss_img_kd = 0.2 * img_h + img_a
    loss_cross_kd = (neg_h + pos_h + pos_a + pos_x + neg_a + neg_x) * 0.5
    loss_kd = itm_logits + (loss_text_kd + loss_img_kd + loss_cross_kd) * 0.33
    return {"loss_kd": loss_kd, "loss_text_kd": loss_text_kd, "loss_img_kd": loss_img_kd,
            "loss_cross_kd": loss_cross_kd, "loss_itm_logits_kd": itm_logits}


def subset_teacher_taps(out: dict, *, vision_layers: int, text_fusion: int,
                        cross_layers: int) -> dict:
    """The teacher's KD tree cut to the student-mapped tap layers
    (distill.subset_taps); the rest are dropped."""

    def n_for(key: str) -> int:
        if key.startswith("image"):
            return vision_layers
        if key.startswith("text"):
            return text_fusion
        return cross_layers  # itm_pos_* / itm_neg_*

    return {
        "hidden_dict": {k: D.subset_taps(v, n_for(k)) for k, v in out["hidden_dict"].items()},
        "attention_dict": {k: D.subset_taps(v, n_for(k), is_attn=True)
                           for k, v in out.get("attention_dict", {}).items()},
        "cross_attention_dict": {k: D.subset_taps(v, n_for(k), is_attn=True)
                                 for k, v in out.get("cross_attention_dict", {}).items()},
        "logits_dict": out["logits_dict"],
    }


class RetrievalTrainStep:
    """One pruning fine-tune step (Eff_Retrieval's train loop body):
    step(state, batch, generator, noise=None) -> metrics, updating `state`
    in place. batch: {"image" [B,H,W,3], "text_ids" [B,T], "text_atts"
    [B,T], "idx" [B] (optional)}. `generator` draws the concrete noise (or
    pass `noise`, {group: uniform draws}), the text tower's dropout and the
    hard negatives."""

    def __init__(self, student_model, teacher_model, l0_module: L0Module, optimizers, *,
                 teacher_params, temperature: float = 1.0, dtype=None, impl: str = "fused"):
        self.student, self.teacher, self.l0 = student_model, teacher_model, l0_module
        self.optimizers, self.teacher_params = optimizers, teacher_params
        self.temperature, self.dtype, self.impl = temperature, dtype, impl

    @torch.no_grad()
    def teacher_forward(self, batch: dict) -> dict:
        out = self.teacher.forward(
            self.teacher_params, batch["image"], batch["text_ids"], batch["text_atts"],
            idx=batch.get("idx"), zs=None, output_attentions=True, output_hidden_states=True,
            train=False, dtype=self.dtype, impl=self.impl)
        vcfg, tcfg = self.student.vision_cfg, self.student.text_cfg
        return subset_teacher_taps(
            out, vision_layers=vcfg["num_hidden_layers"], text_fusion=tcfg["fusion_layer"],
            cross_layers=tcfg["num_hidden_layers"] - tcfg["fusion_layer"])

    def loss_and_grads(self, state: TrainState, batch: dict, teacher_outputs: dict,
                       generator: Optional[torch.Generator] = None, *,
                       noise: Optional[dict] = None):
        """The student forward, every loss, and the gradients of the params,
        the log-alphas and the λs: (metrics, (params, loga, λ) grad lists)."""
        groups = [tree_leaves(state.params), tree_leaves(state.loga), tree_leaves(state.lam)]
        for leaf in (t for g in groups for t in g):
            leaf.requires_grad_(True)
        with torch.enable_grad():
            zs = self.l0.forward_train({"loga": state.loga}, generator, noise=noise)
            student_outputs = self.student.forward(
                state.params, batch["image"], batch["text_ids"], batch["text_atts"],
                idx=batch.get("idx"), zs=zs, generator=generator, output_attentions=True,
                output_hidden_states=True, train=True, dtype=self.dtype, impl=self.impl)
            kd = retrieval_kd_losses(student_outputs, teacher_outputs,
                                     temperature=self.temperature)
            loss_itc = student_outputs["loss"]["loss_itc"]
            loss_itm = student_outputs["loss"]["loss_itm"]
            lagrangian_loss, expected_sparsity, target_sparsity = (
                self.l0.lagrangian_regularization({"loga": state.loga, **state.lam},
                                                  state.step))
            loss = (kd["loss_kd"] + loss_itc + loss_itm) * 0.5 + lagrangian_loss
            flat = [t for g in groups for t in g]
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        del student_outputs
        sizes = [len(g) for g in groups]
        grads = (list(grads[:sizes[0]]), list(grads[sizes[0]:sizes[0] + sizes[1]]),
                 list(grads[sizes[0] + sizes[1]:]))
        metrics = {"loss": loss, "loss_itc": loss_itc, "loss_itm": loss_itm,
                   "lagrangian_loss": lagrangian_loss, "expected_sparsity": expected_sparsity,
                   "target_sparsity": torch.as_tensor(target_sparsity), **kd}
        return {k: v.detach() for k, v in metrics.items()}, grads

    def apply(self, state: TrainState, grads) -> TrainState:
        return apply_updates_3way(state, grads, self.optimizers)

    def __call__(self, state: TrainState, batch: dict,
                 generator: Optional[torch.Generator] = None, *,
                 noise: Optional[dict] = None) -> dict:
        teacher_outputs = self.teacher_forward(batch)
        metrics, grads = self.loss_and_grads(state, batch, teacher_outputs, generator,
                                             noise=noise)
        del teacher_outputs
        self.apply(state, grads)
        return metrics


def make_retrieval_train_step(student_model, teacher_model, l0_module: L0Module, optimizers, *,
                              teacher_params, temperature: float = 1.0, dtype=None,
                              impl: str = "fused") -> RetrievalTrainStep:
    """The step of the retrieval pruning fine-tune (see RetrievalTrainStep)."""
    return RetrievalTrainStep(student_model, teacher_model, l0_module, optimizers,
                              teacher_params=teacher_params, temperature=temperature,
                              dtype=dtype, impl=impl)

