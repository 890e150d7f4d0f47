"""The training steps (port of efficientvlm_tpu/train/steps.py):

- the retrieval pruning fine-tune: the frozen teacher's forward with its KD
  taps, the student's forward with stochastic L0 gates, the KD, ITC, ITM and
  Lagrangian losses, one backward, and the three AdamW updates with the
  log-alpha clamp;
- the generic stage-2 pruning fine-tune of the other tasks (TaskTrainStep;
  VQA, captioning, NLVR and grounding): task_weight x the task loss +
  kd_weight x a KD menu + the Lagrangian, the three AdamWs, and stop_prune
  (frozen gates, the main AdamW alone);
- general distillation (stage 1): the teacher's and the student's pretrain
  forwards (ITC, ITM, MLM, + bbox L1 / GIoU on region batches), 0.6 x task
  + 0.4 x KD, one AdamW and the temperature clamp; and the plain pretrain
  step, the same without a teacher.

JAX traces all of it into one program whose dead-code elimination drops the
teacher taps no loss reads. Eager PyTorch keeps what it computes, so the
teacher runs under torch.no_grad and its taps are cut to the ones the
student is matched with (subset_teacher_taps) right after its forward, as
JAX's split step does. The step's parts are methods, so a caller can time
them: teacher_forward, loss_and_grads (student forward + backward), apply.
A step marks them with spans (train/profiler.span): evlm.step.teacher,
evlm.step.student with evlm.step.gates (the L0 gates' draw and the
Lagrangian) and evlm.step.backward inside, evlm.step.sync (the ranks'
average) and evlm.step.apply (the optimizers).

Above one process each step carries a utils/dist.GradientSync as
`data_parallel` (drivers/common.build_train_step sets it): __call__ first
sets the state to rank 0's (once per state), and between loss_and_grads and
apply averages the metrics and every gradient group over the ranks in one
all-reduce, where JAX's steps pmean them over their axis; the retrieval and
pretrain students' ITC gathers the world batch over its group.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from ..models.model_pretrain import TEMP_CLAMP
from ..pruning.hard_concrete import constrain_loga
from ..pruning.l0_module import L0Module
from . import distill as D
from .optim import tree_leaves
from .profiler import span


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


def _grads_by_group(loss: torch.Tensor, groups: list) -> tuple:
    """loss's gradients over each list of leaves, one list per group (None
    where a leaf gets none)."""
    with span("evlm.step.backward"):
        grads = torch.autograd.grad(loss, [t for g in groups for t in g], allow_unused=True)
    out, at = [], 0
    for g in groups:
        out.append(list(grads[at:at + len(g)]))
        at += len(g)
    return tuple(out)


def _dp_group(step) -> Optional[Any]:
    """The ITC's process group of a data-parallel step, else None."""
    return None if step.data_parallel is None else step.data_parallel.group


def _dp_begin(step, state) -> None:
    if step.data_parallel is not None:
        step.data_parallel.begin(state)


def _dp_sync(step, metrics: dict, grads):
    """(metrics, grads) averaged over the ranks of a data-parallel step, else
    as they are."""
    if step.data_parallel is None:
        return metrics, grads
    with span("evlm.step.sync"):
        return step.data_parallel(metrics, grads)


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
                        cross_layers: int, text_layers: Optional[int] = None,
                        by_key: Optional[dict] = None) -> dict:
    """The teacher's KD tree cut to the student-mapped tap layers
    (distill.subset_taps); the rest are dropped. text_layers: the
    student's BERT depth, which the multi_modal (mlm_*) taps map to.
    by_key: the student's layer count for named taps, before the prefix
    rules (VQA's text_* taps cover the whole question stack; the decoder_*
    taps map to the student's decoder)."""
    by_key = by_key or {}

    def n_for(key: str) -> int:
        if key in by_key:
            return by_key[key]
        if key.startswith("image"):
            return vision_layers
        if key.startswith("text"):
            return text_fusion
        if key.startswith("mlm"):
            return text_layers
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
    [B,T], "idx" [B] (optional)}. `generator` draws the teacher's hard
    negatives first (JAX gives the teacher a key of its own), then the
    concrete noise (or pass `noise`, {group: uniform draws}), the text
    tower's dropout and the student's hard negatives."""

    data_parallel = None  # a utils/dist.GradientSync above one process

    def __init__(self, student_model, teacher_model, l0_module: L0Module, optimizers, *,
                 teacher_params, temperature: float = 1.0, dtype=None, impl: str = "fused"):
        self.student, self.teacher, self.l0 = student_model, teacher_model, l0_module
        self.optimizers, self.teacher_params = optimizers, teacher_params
        self.temperature, self.dtype, self.impl = temperature, dtype, impl

    @torch.no_grad()
    def teacher_forward(self, batch: dict, generator: Optional[torch.Generator] = None) -> dict:
        out = self.teacher.forward(
            self.teacher_params, batch["image"], batch["text_ids"], batch["text_atts"],
            idx=batch.get("idx"), zs=None, generator=generator, output_attentions=True,
            output_hidden_states=True, train=False, dtype=self.dtype, impl=self.impl)
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
            with span("evlm.step.gates"):
                zs = self.l0.forward_train({"loga": state.loga}, generator, noise=noise)
            student_outputs = self.student.forward(
                state.params, batch["image"], batch["text_ids"], batch["text_atts"],
                idx=batch.get("idx"), zs=zs, generator=generator, output_attentions=True,
                output_hidden_states=True, train=True, dtype=self.dtype, impl=self.impl,
                group=_dp_group(self))
            kd = retrieval_kd_losses(student_outputs, teacher_outputs,
                                     temperature=self.temperature)
            loss_itc = student_outputs["loss"]["loss_itc"]
            loss_itm = student_outputs["loss"]["loss_itm"]
            with span("evlm.step.gates"):
                lagrangian_loss, expected_sparsity, target_sparsity = (
                    self.l0.lagrangian_regularization({"loga": state.loga, **state.lam},
                                                      state.step))
            loss = (kd["loss_kd"] + loss_itc + loss_itm) * 0.5 + lagrangian_loss
            grads = _grads_by_group(loss, groups)
        del student_outputs
        metrics = {"loss": loss, "loss_itc": loss_itc, "loss_itm": loss_itm,
                   "lagrangian_loss": lagrangian_loss, "expected_sparsity": expected_sparsity,
                   "target_sparsity": torch.as_tensor(target_sparsity), **kd}
        return {k: v.detach() for k, v in metrics.items()}, grads

    def apply(self, state: TrainState, grads) -> TrainState:
        return apply_updates_3way(state, grads, self.optimizers)

    def __call__(self, state: TrainState, batch: dict,
                 generator: Optional[torch.Generator] = None, *,
                 noise: Optional[dict] = None) -> dict:
        _dp_begin(self, state)
        with span("evlm.step.teacher"):
            teacher_outputs = self.teacher_forward(batch, generator)
        with span("evlm.step.student"):
            metrics, grads = self.loss_and_grads(state, batch, teacher_outputs, generator,
                                                 noise=noise)
        metrics, grads = _dp_sync(self, metrics, grads)
        del teacher_outputs
        with span("evlm.step.apply"):
            self.apply(state, grads)
        return metrics


def make_retrieval_train_step(student_model, teacher_model, l0_module: L0Module, optimizers, *,
                              teacher_params, temperature: float = 1.0, dtype=None,
                              impl: str = "fused") -> RetrievalTrainStep:
    """The step of the retrieval pruning fine-tune (see RetrievalTrainStep)."""
    return RetrievalTrainStep(student_model, teacher_model, l0_module, optimizers,
                              teacher_params=teacher_params, temperature=temperature,
                              dtype=dtype, impl=impl)



# ---------------------------------------------------------------------------
# the stage-2 pruning fine-tune of VQA, captioning, NLVR and grounding
# ---------------------------------------------------------------------------


def _split_text_cross(hidden: list, attns: list, fusion_layer: int) -> tuple:
    """The multi_modal question stack's taps split at the fusion boundary:
    hidden [:fusion + 1] text, [fusion + 1:] cross outputs; maps [:fusion]
    text, [fusion:] the cross layers' self-attention."""
    return (hidden[:fusion_layer + 1], hidden[fusion_layer + 1:], attns[:fusion_layer],
            attns[fusion_layer:])


def vqa_kd_losses(student_outputs: dict, teacher_outputs: dict, *, fusion_layer_s: int,
                  temperature: float = 1.0) -> dict:
    """The VQA KD menu: the question stack's taps mapped over the whole
    stack and then split at the student's fusion layer (text hidden + maps,
    cross hidden + self maps + cross maps x 0.5), the image taps (hidden x
    0.2), the decoder's hidden, self and cross maps, and the soft
    cross-entropy of the answer logits."""
    sh, th = student_outputs["hidden_dict"], teacher_outputs["hidden_dict"]
    sa, ta = student_outputs["attention_dict"], teacher_outputs["attention_dict"]
    sc, tc = student_outputs["cross_attention_dict"], teacher_outputs["cross_attention_dict"]

    s_text_h, s_text_a = sh["text_hidden_states"], sa["text_attentions"]
    t_text_h = D.get_cor_teacher([x.detach() for x in th["text_hidden_states"]], s_text_h)
    t_text_a = D.get_cor_teacher([x.detach() for x in ta["text_attentions"]], s_text_a,
                                 is_attn=True)
    s_th, s_ch, s_ta, s_ca = _split_text_cross(s_text_h, s_text_a, fusion_layer_s)
    t_th, t_ch, t_ta, t_ca = _split_text_cross(t_text_h, t_text_a, fusion_layer_s)

    text_h, text_a = D.kd_loss(s_th, t_th), D.kd_loss(s_ta, t_ta, is_attn=True)
    cross_h, cross_sa = D.kd_loss(s_ch, t_ch), D.kd_loss(s_ca, t_ca, is_attn=True)
    cross_x = D.kd_list(sc["cross_attentions"], tc["cross_attentions"], is_attn=True)
    img_h = D.kd_list(sh["image_hidden_states"], th["image_hidden_states"], is_img=True)
    img_a = D.kd_list(sa["image_attentions"], ta["image_attentions"], is_attn=True)
    dec_h = D.kd_list(sh["decoder_hidden_states"], th["decoder_hidden_states"], is_img=True)
    dec_a = D.kd_list(sa["decoder_attentions"], ta["decoder_attentions"], is_attn=True)
    dec_x = D.kd_list(sc["decoder_cross_attentions"], tc["decoder_cross_attentions"],
                      is_attn=True)
    logits = D.soft_cross_entropy(student_outputs["logits_dict"]["logits"] / temperature,
                                  teacher_outputs["logits_dict"]["logits"] / temperature)
    loss_text_kd = text_a + text_h
    loss_img_kd = img_a + img_h * 0.2
    loss_cross_kd = (cross_h + cross_sa + cross_x) * 0.5
    loss_decoder_kd = dec_a + dec_h + dec_x
    loss_kd = logits + loss_text_kd + loss_img_kd + loss_cross_kd + loss_decoder_kd
    return {"loss_kd": loss_kd, "loss_text_kd": loss_text_kd, "loss_img_kd": loss_img_kd,
            "loss_cross_kd": loss_cross_kd, "loss_decoder_kd": loss_decoder_kd,
            "loss_logits_kd": logits}


def captioning_kd_losses(student_outputs: dict, teacher_outputs: dict, *,
                         temperature: float = 1.0) -> dict:
    """The captioning KD menu: the image taps (hidden x 0.1), the decoder's
    hidden, self and cross maps, and the soft cross-entropy of the logits."""
    sh, th = student_outputs["hidden_dict"], teacher_outputs["hidden_dict"]
    sa, ta = student_outputs["attention_dict"], teacher_outputs["attention_dict"]
    sc, tc = student_outputs["cross_attention_dict"], teacher_outputs["cross_attention_dict"]
    img_h = D.kd_list(sh["image_hidden_states"], th["image_hidden_states"], is_img=True)
    img_a = D.kd_list(sa["image_attentions"], ta["image_attentions"], is_attn=True)
    dec_h = D.kd_list(sh["decoder_hidden_states"], th["decoder_hidden_states"], is_img=True)
    dec_a = D.kd_list(sa["decoder_attentions"], ta["decoder_attentions"], is_attn=True)
    dec_x = D.kd_list(sc["decoder_cross_attentions"], tc["decoder_cross_attentions"],
                      is_attn=True)
    logits = D.soft_cross_entropy(student_outputs["logits_dict"]["logits"] / temperature,
                                  teacher_outputs["logits_dict"]["logits"] / temperature)
    loss_img_kd = img_a + img_h * 0.1
    loss_decoder_kd = dec_a + dec_h + dec_x
    return {"loss_kd": logits + loss_img_kd + loss_decoder_kd, "loss_img_kd": loss_img_kd,
            "loss_decoder_kd": loss_decoder_kd, "loss_logits_kd": logits}


def nlvr_kd_losses(student_outputs: dict, teacher_outputs: dict, *, fusion_layer_s: int,
                   temperature: float = 1.0) -> dict:
    """The NLVR KD menu: the replicated text stack's taps mapped over its
    whole depth (fusion + 2Lc layers) and split at the student's fusion
    layer (text hidden + maps, cross hidden + self maps + cross maps x 0.5),
    the image taps (hidden x 0.1), the soft cross-entropy of the cls_head
    logits; kd = logits + text + (image + cross) x 0.33. As in JAX, the
    mapping takes the teacher's block ends, so a student cross layer over
    image0 meets a teacher layer over image1."""
    sh, th = student_outputs["hidden_dict"], teacher_outputs["hidden_dict"]
    sa, ta = student_outputs["attention_dict"], teacher_outputs["attention_dict"]
    sc, tc = student_outputs["cross_attention_dict"], teacher_outputs["cross_attention_dict"]

    s_text_h, s_text_a = sh["text_hidden_states"], sa["text_attentions"]
    t_text_h = D.get_cor_teacher([x.detach() for x in th["text_hidden_states"]], s_text_h)
    t_text_a = D.get_cor_teacher([x.detach() for x in ta["text_attentions"]], s_text_a,
                                 is_attn=True)
    s_th, s_ch, s_ta, s_ca = _split_text_cross(s_text_h, s_text_a, fusion_layer_s)
    t_th, t_ch, t_ta, t_ca = _split_text_cross(t_text_h, t_text_a, fusion_layer_s)

    text_h, text_a = D.kd_loss(s_th, t_th), D.kd_loss(s_ta, t_ta, is_attn=True)
    cross_h, cross_sa = D.kd_loss(s_ch, t_ch), D.kd_loss(s_ca, t_ca, is_attn=True)
    cross_x = D.kd_list(sc["cross_attentions"], tc["cross_attentions"], is_attn=True)
    img_h = D.kd_list(sh["image_hidden_states"], th["image_hidden_states"], is_img=True)
    img_a = D.kd_list(sa["image_attentions"], ta["image_attentions"], is_attn=True)
    logits = D.soft_cross_entropy(
        student_outputs["logits_dict"]["cls_head_logits"] / temperature,
        teacher_outputs["logits_dict"]["cls_head_logits"] / temperature)
    loss_text_kd = text_a + text_h
    loss_img_kd = img_a + img_h * 0.1
    loss_cross_kd = (cross_h + cross_sa + cross_x) * 0.5
    loss_kd = logits + loss_text_kd + (loss_img_kd + loss_cross_kd) * 0.33
    return {"loss_kd": loss_kd, "loss_text_kd": loss_text_kd, "loss_img_kd": loss_img_kd,
            "loss_cross_kd": loss_cross_kd, "loss_logits_kd": logits}


class TaskTrainStep:
    """One stage-2 pruning fine-tune step of a task (Eff_VQA / Eff_NLVR /
    Eff_Captioning's train loop body): loss = task_weight x the student's
    task loss + kd_weight x kd_fn's loss_kd + the Lagrangian, one backward,
    the three AdamW updates with the loga clamp. step(state, batch,
    generator, noise=None) -> metrics, updating `state` in place.

    student_forward(params, zs, batch, generator) -> outputs with "loss" and
    the KD dicts; teacher_forward(teacher_params, batch) -> the teacher's KD
    tree, already cut to the taps kd_fn reads (it runs under no_grad);
    kd_fn(student_outputs, teacher_outputs) -> {"loss_kd", ...}.

    frozen_zs is stop_prune: the student trains against those fixed gates,
    the Lagrangian is 0, and only the main AdamW steps, so loga, the λs and
    their optimizer states stay as they are. The parts are methods, so a
    caller can time them: teacher_forward, loss_and_grads (student forward +
    backward), apply."""

    data_parallel = None  # a utils/dist.GradientSync above one process

    def __init__(self, student_forward, teacher_forward, kd_fn, l0_module: L0Module,
                 optimizers, *, teacher_params, task_weight: float, kd_weight: float,
                 frozen_zs: Optional[dict] = None):
        self.student_forward, self.teacher_fn, self.kd_fn = (student_forward, teacher_forward,
                                                             kd_fn)
        self.l0, self.optimizers, self.teacher_params = l0_module, optimizers, teacher_params
        self.task_weight, self.kd_weight, self.frozen_zs = task_weight, kd_weight, frozen_zs

    @torch.no_grad()
    def teacher_forward(self, batch: dict) -> dict:
        return self.teacher_fn(self.teacher_params, batch)

    def loss_and_grads(self, state: TrainState, batch: dict, teacher_outputs: dict,
                       generator: Optional[torch.Generator] = None, *,
                       noise: Optional[dict] = None):
        """The student forward, every loss and the gradients: (metrics,
        (params, loga, λ) grad lists); with frozen_zs the loga and λ lists
        are empty."""
        frozen = self.frozen_zs is not None
        groups = [tree_leaves(state.params)]
        if not frozen:
            groups += [tree_leaves(state.loga), tree_leaves(state.lam)]
        for leaf in (t for g in groups for t in g):
            leaf.requires_grad_(True)
        with torch.enable_grad():
            if frozen:
                zs = {k: v.detach() for k, v in self.frozen_zs.items()}
                zero = torch.zeros((), device=groups[0][0].device)
                lagrangian_loss, expected_sparsity, target_sparsity = zero, zero, zero
            else:
                with span("evlm.step.gates"):
                    zs = self.l0.forward_train({"loga": state.loga}, generator, noise=noise)
                    lagrangian_loss, expected_sparsity, target_sparsity = (
                        self.l0.lagrangian_regularization({"loga": state.loga, **state.lam},
                                                          state.step))
            student_outputs = self.student_forward(state.params, zs, batch, generator)
            kd = self.kd_fn(student_outputs, teacher_outputs)
            loss_task = student_outputs["loss"]
            loss = (self.task_weight * loss_task + self.kd_weight * kd["loss_kd"]
                    + lagrangian_loss)
            grads = _grads_by_group(loss, groups)
        del student_outputs
        if frozen:
            grads += ([], [])  # no loga or λ gradients
        metrics = {"loss": loss, "loss_task": loss_task, "lagrangian_loss": lagrangian_loss,
                   "expected_sparsity": expected_sparsity,
                   "target_sparsity": torch.as_tensor(target_sparsity), **kd}
        return {k: v.detach() for k, v in metrics.items()}, grads

    def apply(self, state: TrainState, grads) -> TrainState:
        if self.frozen_zs is None:
            return apply_updates_3way(state, grads, self.optimizers)
        self.optimizers[0].step(tree_leaves(state.params), grads[0], state.opt_state)
        state.step += 1
        return state

    def __call__(self, state: TrainState, batch: dict,
                 generator: Optional[torch.Generator] = None, *,
                 noise: Optional[dict] = None) -> dict:
        _dp_begin(self, state)
        with span("evlm.step.teacher"):
            teacher_outputs = self.teacher_forward(batch)
        with span("evlm.step.student"):
            metrics, grads = self.loss_and_grads(state, batch, teacher_outputs, generator,
                                                 noise=noise)
        metrics, grads = _dp_sync(self, metrics, grads)
        del teacher_outputs
        with span("evlm.step.apply"):
            self.apply(state, grads)
        return metrics


def make_task_train_step(student_forward, teacher_forward, kd_fn, l0_module: L0Module,
                         optimizers, *, teacher_params, task_weight: float, kd_weight: float,
                         frozen_zs: Optional[dict] = None) -> TaskTrainStep:
    """The generic stage-2 pruning fine-tune step (see TaskTrainStep)."""
    return TaskTrainStep(student_forward, teacher_forward, kd_fn, l0_module, optimizers,
                         teacher_params=teacher_params, task_weight=task_weight,
                         kd_weight=kd_weight, frozen_zs=frozen_zs)


# ---------------------------------------------------------------------------
# general distillation and plain pretraining
# ---------------------------------------------------------------------------


@dataclass
class PretrainState:
    """(params, opt_state, step) of the general-distillation and pretrain
    steps; params are the f32 masters, updated in place."""
    params: Any
    opt_state: dict
    step: int


def init_pretrain_state(params, optimizer) -> PretrainState:
    return PretrainState(params=params, opt_state=optimizer.init(tree_leaves(params)), step=0)


def clamp_temp(params) -> None:
    """temp clamped to [0.001, 0.5] in place, as the reference does after
    each update."""
    if "temp" in params:
        with torch.no_grad():
            params["temp"].clamp_(*TEMP_CLAMP)


def gd_kd_losses(student_outputs: dict, teacher_outputs: dict, *,
                 temperature: float = 1.0) -> dict:
    """The general-distillation KD menu: hidden + attention KD of the text,
    image, ITM-positive, ITM-negative and MLM taps, soft cross-entropy of the
    ITM and MLM logits; the image hidden states weighted 0.1 (their 7th
    entry dropped)."""
    sh, th = student_outputs["hidden_dict"], teacher_outputs["hidden_dict"]
    sa, ta = student_outputs["attention_dict"], teacher_outputs["attention_dict"]
    sl, tl = student_outputs["logits_dict"], teacher_outputs["logits_dict"]

    def pair(name: str, **kw):
        return (D.kd_list(sa[f"{name}_attentions"], ta[f"{name}_attentions"], is_attn=True),
                D.kd_list(sh[f"{name}_hidden_states"], th[f"{name}_hidden_states"], **kw))

    text_a, text_h = pair("text")
    img_a, img_h = pair("image", is_img=True)
    pos_a, pos_h = pair("itm_pos")
    neg_a, neg_h = pair("itm_neg")
    mlm_a, mlm_h = pair("mlm")
    mlm_logits = D.soft_cross_entropy(sl["mlm_logits"] / temperature,
                                      tl["mlm_logits"] / temperature)
    itm_logits = D.soft_cross_entropy(sl["itm_head_logits"] / temperature,
                                      tl["itm_head_logits"] / temperature)
    loss_text_kd = text_a + text_h
    loss_img_kd = img_a + 0.1 * img_h
    loss_cross_kd = neg_a + neg_h + pos_a + pos_h + mlm_a + mlm_h
    loss_kd = itm_logits + mlm_logits + loss_text_kd + loss_img_kd + loss_cross_kd
    return {"loss_kd": loss_kd, "loss_text_kd": loss_text_kd, "loss_img_kd": loss_img_kd,
            "loss_cross_kd": loss_cross_kd, "loss_mlm_logits_kd": mlm_logits,
            "loss_itm_logits_kd": itm_logits}


def gd_teacher_taps(out: dict, **layers) -> dict:
    """The teacher's KD tree cut to what gd_kd_losses reads: the cross maps
    and the bbox taps dropped, then subset_teacher_taps(**layers)."""
    return subset_teacher_taps(
        {"hidden_dict": {k: v for k, v in out["hidden_dict"].items() if not k.startswith("bbox")},
         "attention_dict": {k: v for k, v in out["attention_dict"].items()
                            if not k.startswith("bbox")},
         "logits_dict": out["logits_dict"]}, **layers)


def _forward_kw(batch: dict, with_bbox: bool, bbox_head: bool = True) -> dict:
    """XVLMForPretrain.forward's batch arguments; bbox_head=False leaves out
    target_bbox / is_image, so a region forward skips the bbox head."""
    kw = {k: batch.get(k) for k in ("text_ids_masked", "masked_pos", "masked_ids")}
    if with_bbox:
        kw.update({k: batch.get(k) for k in ("image_atts", "idx_to_group_img")},
                  ret_bbox_loss=True)
        if bbox_head:
            kw.update({k: batch.get(k) for k in ("target_bbox", "is_image")})
    return kw


def _task_loss(loss: dict, with_bbox: bool) -> torch.Tensor:
    total = loss["loss_itc"] + loss["loss_itm"] + loss["loss_mlm"]
    if with_bbox:
        total = total + loss["loss_bbox"] + loss["loss_giou"]
    return total


class PretrainTrainStep:
    """One plain pretrain step (no teacher, no KD): ITC + ITM + MLM (+ bbox
    + GIoU with with_bbox), one AdamW update, the temperature clamp.
    step(state, batch, generator) -> metrics, updating `state` in place.
    batch: {"image", "text_ids", "text_atts", "text_ids_masked",
    "masked_pos", "masked_ids"} and, for region batches, {"image_atts",
    "idx_to_group_img", "target_bbox", "is_image"}. `generator` drives the
    dropout and the hard negatives (XVLMForPretrain's order)."""

    data_parallel = None  # a utils/dist.GradientSync above one process

    def __init__(self, model, optimizer, *, with_bbox: bool = False, dtype=None,
                 impl: str = "fused"):
        self.model, self.optimizer = model, optimizer
        self.with_bbox, self.dtype, self.impl = with_bbox, dtype, impl

    def _student(self, params, batch, generator, **kw) -> dict:
        return self.model.forward(params, batch["image"], batch["text_ids"], batch["text_atts"],
                                  generator=generator, train=True, dtype=self.dtype,
                                  impl=self.impl, group=_dp_group(self),
                                  **_forward_kw(batch, self.with_bbox), **kw)

    def _grads(self, state: PretrainState, loss_fn):
        """(metrics, loss_fn's gradient over the params in tree order)."""
        leaves = tree_leaves(state.params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        with torch.enable_grad():
            loss, metrics = loss_fn()
            with span("evlm.step.backward"):
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return {k: v.detach() for k, v in metrics.items()}, list(grads)

    def loss_and_grads(self, state: PretrainState, batch: dict,
                       generator: Optional[torch.Generator] = None):
        def loss_fn():
            out = self._student(state.params, batch, generator)
            loss = _task_loss(out["loss"], self.with_bbox)
            return loss, {"loss": loss, **out["loss"]}

        return self._grads(state, loss_fn)

    def apply(self, state: PretrainState, grads) -> PretrainState:
        self.optimizer.step(tree_leaves(state.params), grads, state.opt_state)
        clamp_temp(state.params)
        state.step += 1
        return state

    def __call__(self, state: PretrainState, batch: dict,
                 generator: Optional[torch.Generator] = None) -> dict:
        _dp_begin(self, state)
        with span("evlm.step.student"):
            metrics, grads = self.loss_and_grads(state, batch, generator)
        metrics, grads = _dp_sync(self, metrics, grads)
        with span("evlm.step.apply"):
            self.apply(state, grads)
        return metrics


class GDTrainStep(PretrainTrainStep):
    """One general-distillation step: the frozen teacher's pretrain forward
    under no_grad (train=False, without the bbox head, whose outputs no KD
    loss reads; its taps cut by gd_teacher_taps right after), the
    student's, loss = (1 - kd_weight) x task + kd_weight x gd_kd_losses,
    one AdamW update and the temperature clamp. The generator draws the
    teacher's hard negatives first, then the student's dropout and hard
    negatives. The parts are methods, so a caller can time them:
    teacher_forward, loss_and_grads (student forward + backward), apply.

    Region batches change batch inside the vision tower (B image rows before
    the first local layer, n_txt + B after it); student entry i of a tap
    list meets teacher entry 2i (hidden) / 2i+1 (maps) of a tower twice as
    deep with twice the local layers, so both gather at the same mapped
    depth, and distill.kd_loss refuses pairs whose shapes differ."""

    def __init__(self, student_model, teacher_model, optimizer, *, teacher_params,
                 temperature: float = 1.0, kd_weight: float = 0.4, with_bbox: bool = False,
                 dtype=None, impl: str = "fused"):
        super().__init__(student_model, optimizer, with_bbox=with_bbox, dtype=dtype, impl=impl)
        self.teacher, self.teacher_params = teacher_model, teacher_params
        self.temperature, self.kd_weight = temperature, kd_weight

    @torch.no_grad()
    def teacher_forward(self, batch: dict, generator: Optional[torch.Generator] = None) -> dict:
        out = self.teacher.forward(
            self.teacher_params, batch["image"], batch["text_ids"], batch["text_atts"],
            generator=generator, output_attentions=True, output_hidden_states=True,
            train=False, dtype=self.dtype, impl=self.impl,
            **_forward_kw(batch, self.with_bbox, bbox_head=False))
        vcfg, tcfg = self.model.vision_cfg, self.model.text_cfg
        return gd_teacher_taps(
            out, vision_layers=vcfg["num_hidden_layers"], text_fusion=tcfg["fusion_layer"],
            cross_layers=tcfg["num_hidden_layers"] - tcfg["fusion_layer"],
            text_layers=tcfg["num_hidden_layers"])

    def loss_and_grads(self, state: PretrainState, batch: dict, teacher_outputs: dict,
                       generator: Optional[torch.Generator] = None):
        def loss_fn():
            out = self._student(state.params, batch, generator, output_attentions=True,
                                output_hidden_states=True)
            kd = gd_kd_losses(out, teacher_outputs, temperature=self.temperature)
            task = _task_loss(out["loss"], self.with_bbox)
            loss = (1.0 - self.kd_weight) * task + self.kd_weight * kd["loss_kd"]
            return loss, {"loss": loss, **out["loss"], **kd}

        return self._grads(state, loss_fn)

    def __call__(self, state: PretrainState, batch: dict,
                 generator: Optional[torch.Generator] = None) -> dict:
        _dp_begin(self, state)
        with span("evlm.step.teacher"):
            teacher_outputs = self.teacher_forward(batch, generator)
        with span("evlm.step.student"):
            metrics, grads = self.loss_and_grads(state, batch, teacher_outputs, generator)
        metrics, grads = _dp_sync(self, metrics, grads)
        del teacher_outputs
        with span("evlm.step.apply"):
            self.apply(state, grads)
        return metrics


def make_gd_train_step(student_model, teacher_model, optimizer, *, teacher_params,
                       temperature: float = 1.0, kd_weight: float = 0.4,
                       with_bbox: bool = False, dtype=None, impl: str = "fused") -> GDTrainStep:
    """The general-distillation step (see GDTrainStep); with_bbox selects the
    region-batch variant."""
    return GDTrainStep(student_model, teacher_model, optimizer, teacher_params=teacher_params,
                       temperature=temperature, kd_weight=kd_weight, with_bbox=with_bbox,
                       dtype=dtype, impl=impl)


def make_pretrain_train_step(model, optimizer, *, with_bbox: bool = False, dtype=None,
                             impl: str = "fused") -> PretrainTrainStep:
    """The plain pretrain step (see PretrainTrainStep)."""
    return PretrainTrainStep(model, optimizer, with_bbox=with_bbox, dtype=dtype, impl=impl)
