"""Modal-adaptive L0 gate modules with Lagrangian sparsity control (port of
efficientvlm_tpu/pruning/l0_module.py).

One generic `L0Module` over a gate-group layout; `XVLML0Module` builds the
retrieval and captioning layout: vision_head [Lv,H], text_head [Lt,H],
cross_head [2*Lc,H] (self/cross interleaved), vision/text/cross_intermediate
[L,I]; `VQAL0Module` adds the answer decoder's decoder_head [2*Ld,H] and
decoder_intermediate [Ld,I]; `NLVRL0Module` is XVLML0Module's over NLVR's
replicated stack (twice the cross layers).

Params: {"loga": {group: [L, size] tensor}, "lambda_1", "lambda_2"}; the
λs are trained by gradient ascent (train/optim.create_lagrangian_optimizer).
Gates come out in encoder-ready shapes: heads [L,H] (a learned gate per
`head_group` adjacent heads, repeated), cross heads [Lc,2,H] ([:,0] self,
[:,1] cross), FFN [L,I].
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import hard_concrete as hc


class L0Module:
    """groups: name -> dict(shape=(L, size), params_per_dim=int,
    init_mean=float|None, emit=callable|None, prunable_params=int|None);
    `emit` reshapes the raw [L, size] gate to its encoder-ready form."""

    def __init__(self, groups: Dict[str, dict], *, droprate_init: float = 0.5,
                 temperature: float = 2.0 / 3.0, magical_number: float = hc.MAGICAL_NUMBER,
                 lagrangian_warmup: int = 0, start_sparsity: float = 0.0,
                 target_sparsity: float = 0.0):
        self.groups = groups
        self.droprate_init = droprate_init
        self.temperature = temperature
        self.magical_number = magical_number
        self.lagrangian_warmup = lagrangian_warmup
        self.start_sparsity = start_sparsity
        self.target_sparsity = target_sparsity
        self.prunable_model_size = sum(
            g.get("prunable_params", g["params_per_dim"] * int(np.prod(g["shape"])))
            for g in groups.values())

    # -- params ---------------------------------------------------------------

    def init(self, seed: int, *, device=None) -> dict:
        """Gate params from a seed, on `device` (default cuda)."""
        device = resolve_device(device)
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        loga = {name: hc.init_loga(generator, g["shape"], droprate_init=self.droprate_init,
                                   mean=g.get("init_mean"), device=device)
                for name, g in self.groups.items()}
        zero = lambda: torch.zeros((), device=device)  # noqa: E731
        return {"loga": loga, "lambda_1": zero(), "lambda_2": zero()}

    # -- forward ---------------------------------------------------------------

    def _emit(self, name: str, z: torch.Tensor) -> torch.Tensor:
        emit = self.groups[name].get("emit")
        return emit(z) if emit is not None else z

    def forward_train(self, params: dict, generator: Optional[torch.Generator] = None, *,
                      noise: Optional[dict] = None) -> dict:
        """Stochastic gates. noise: {group: uniform(eps, 1 - eps) draws of the
        group's shape} to use instead of drawing from `generator`, so that a
        test can feed this module and the JAX one the same concrete noise."""
        zs = {}
        for name in self.groups:
            loga = params["loga"][name]
            if noise is not None:
                u = torch.as_tensor(noise[name], dtype=loga.dtype, device=loga.device)
                z = hc.quantile_concrete(u, loga, self.temperature).clamp(0.0, 1.0)
            else:
                z = hc.sample_z(generator, loga, self.temperature)
            zs[f"{name}_z"] = self._emit(name, z)
        return zs

    def forward_deterministic(self, params: dict) -> dict:
        """Deterministic per-layer top-k masks (the eval path), host-side,
        returned on the gates' device."""
        zs = {}
        for name in self.groups:
            loga = params["loga"][name]
            rows = np.stack([hc.deterministic_z(row, self.temperature, self.magical_number)
                             for row in loga.detach().float().cpu().numpy()])
            zs[f"{name}_z"] = self._emit(name, torch.from_numpy(rows).to(loga.device))
        return zs

    # -- sparsity / Lagrangian -------------------------------------------------

    def expected_model_size(self, params: dict) -> torch.Tensor:
        total = 0.0
        for name, g in self.groups.items():
            score = 1.0 - hc.cdf_qz(0.0, params["loga"][name], self.temperature)
            total = total + score.sum() * g["params_per_dim"]
        return total

    def get_target_sparsity(self, pruned_steps) -> float:
        frac = min(1.0, pruned_steps / max(self.lagrangian_warmup, 1))
        return (self.target_sparsity - self.start_sparsity) * frac + self.start_sparsity

    def lagrangian_regularization(self, params: dict,
                                  pruned_steps) -> Tuple[torch.Tensor, torch.Tensor, float]:
        """(loss, expected_sparsity, target_sparsity): λ1 (s - t) + λ2 (s - t)²."""
        expected_sparsity = 1.0 - self.expected_model_size(params) / self.prunable_model_size
        target = (self.get_target_sparsity(int(pruned_steps)) if self.lagrangian_warmup > 0
                  else self.target_sparsity)
        diff = expected_sparsity - target
        loss = params["lambda_1"] * diff + params["lambda_2"] * diff * diff
        return loss, expected_sparsity, target

    def calculate_model_size(self, zs: dict) -> dict:
        """Binary accounting of a zs dict. Emitted zs may repeat each raw gate
        `expand` times (head_group > 1): per-unit params = params_per_dim /
        expand."""
        results = {}
        remaining = 0.0
        for name, g in self.groups.items():
            z = np.asarray(torch.as_tensor(zs[f"{name}_z"]).detach().cpu()).reshape(
                g["shape"][0], -1) > 0
            expand = z.size // int(np.prod(g["shape"]))
            results[f"{name}_nums"] = z.sum(-1).tolist()
            remaining += int(z.sum()) * (g["params_per_dim"] / expand)
        results["remaining_params"] = int(remaining)
        results["pruned_params"] = self.prunable_model_size - int(remaining)
        results["pruned_model_sparsity"] = results["pruned_params"] / self.prunable_model_size
        return results


# ---------------------------------------------------------------------------
# the layouts
# ---------------------------------------------------------------------------


def _bert_sizes(hidden_size=768, intermediate_size=3072, num_heads=12):
    params_per_head_layer = hidden_size * hidden_size * 4 + hidden_size * 4
    params_per_mlp_layer = hidden_size * intermediate_size * 2 + hidden_size + hidden_size * 4
    return params_per_head_layer // num_heads, params_per_mlp_layer // intermediate_size


def _mlp_layer_params(hidden_size, intermediate_size):
    return hidden_size * intermediate_size * 2 + hidden_size + hidden_size * 4


def _interleave_to_pairs(z: torch.Tensor) -> torch.Tensor:
    """[2L, H] interleaved self/cross rows -> [L, 2, H]."""
    return z.reshape(-1, 2, z.shape[-1])


def _repeat_heads(group: int):
    """One learned gate drives `group` adjacent heads (at head dim 64 and
    group 2 every kept attention width is a multiple of 128)."""
    return lambda z: torch.repeat_interleave(z, group, dim=-1)


def _head_group(L, H, pph, group: int = 1):
    if H % group:
        raise ValueError(f"{H} heads do not split into groups of {group}")
    g = dict(shape=(L, H // group), params_per_dim=pph * group, init_mean=10.0)
    if group > 1:
        g["emit"] = _repeat_heads(group)
    return g


def _int_group(L, I, ppi, layer_params):
    # prunable_params counts the full per-layer FFN params (the floored
    # per-dim value loses a remainder), as the reference does
    return dict(shape=(L, I), params_per_dim=ppi, init_mean=None,
                prunable_params=layer_params * L)


def _cross_emit(group: int):
    if group == 1:
        return _interleave_to_pairs
    rep = _repeat_heads(group)
    return lambda z: _interleave_to_pairs(rep(z))


def _groups(*, vision_layers, text_layers, cross_layers, decoder_layers, hidden_size,
            intermediate_size, num_heads, vision_hidden_size, vision_intermediate_size,
            vision_num_heads, head_group) -> dict:
    """The head groups, then the FFN groups; the decoder's with
    decoder_layers > 0."""
    v_hidden = vision_hidden_size or hidden_size
    v_int = vision_intermediate_size or intermediate_size
    v_heads = vision_num_heads or num_heads
    pph, ppi = _bert_sizes(hidden_size, intermediate_size, num_heads)
    vpph, vppi = _bert_sizes(v_hidden, v_int, v_heads)
    mlp = _mlp_layer_params(hidden_size, intermediate_size)
    pairs = lambda n: {**_head_group(n * 2, num_heads, pph, head_group),  # noqa: E731
                       "emit": _cross_emit(head_group)}
    heads = {"vision_head": _head_group(vision_layers, v_heads, vpph, head_group),
             "text_head": _head_group(text_layers, num_heads, pph, head_group),
             "cross_head": pairs(cross_layers)}
    ffn = {"vision_intermediate": _int_group(vision_layers, v_int, vppi,
                                             _mlp_layer_params(v_hidden, v_int)),
           "text_intermediate": _int_group(text_layers, intermediate_size, ppi, mlp),
           "cross_intermediate": _int_group(cross_layers, intermediate_size, ppi, mlp)}
    if decoder_layers:
        heads["decoder_head"] = pairs(decoder_layers)
        ffn["decoder_intermediate"] = _int_group(decoder_layers, intermediate_size, ppi, mlp)
    return {**heads, **ffn}


def XVLML0Module(*, vision_layers: int, text_layers: int, cross_layers: int,
                 hidden_size: int = 768, intermediate_size: int = 3072, num_heads: int = 12,
                 vision_hidden_size: int | None = None,
                 vision_intermediate_size: int | None = None,
                 vision_num_heads: int | None = None, head_group: int = 1, **kw) -> L0Module:
    """The retrieval / pretrain / captioning gate layout; the vision_*
    overrides serve towers of other widths, head_group > 1 learns gates over
    head groups."""
    return L0Module(_groups(
        vision_layers=vision_layers, text_layers=text_layers, cross_layers=cross_layers,
        decoder_layers=0, hidden_size=hidden_size, intermediate_size=intermediate_size,
        num_heads=num_heads, vision_hidden_size=vision_hidden_size,
        vision_intermediate_size=vision_intermediate_size, vision_num_heads=vision_num_heads,
        head_group=head_group), **kw)


def NLVRL0Module(*, vision_layers: int, text_layers: int, cross_layers: int,
                 hidden_size: int = 768, intermediate_size: int = 3072, num_heads: int = 12,
                 **kw) -> L0Module:
    """The NLVR layout: XVLML0Module's over the replicated stack, 2 x
    cross_layers cross layers (cross_head [4Lc,H] emitted [2Lc,2,H],
    cross_intermediate [2Lc,I], of which the forward reads rows [0, Lc));
    the vision_* overrides and head_group pass through."""
    return XVLML0Module(vision_layers=vision_layers, text_layers=text_layers,
                        cross_layers=cross_layers * 2, hidden_size=hidden_size,
                        intermediate_size=intermediate_size, num_heads=num_heads, **kw)


def VQAL0Module(*, vision_layers: int, text_layers: int, cross_layers: int,
                decoder_layers: Optional[int] = None, hidden_size: int = 768,
                intermediate_size: int = 3072, num_heads: int = 12,
                vision_hidden_size: int | None = None,
                vision_intermediate_size: int | None = None,
                vision_num_heads: int | None = None, head_group: int = 1, **kw) -> L0Module:
    """The VQA layout: XVLML0Module's groups and the answer decoder's,
    decoder_head [2*Ld,H] (self/cross interleaved, emitted [Ld,2,H]) and
    decoder_intermediate [Ld,I]; Ld defaults to the cross depth."""
    return L0Module(_groups(
        vision_layers=vision_layers, text_layers=text_layers, cross_layers=cross_layers,
        decoder_layers=cross_layers if decoder_layers is None else decoder_layers,
        hidden_size=hidden_size, intermediate_size=intermediate_size, num_heads=num_heads,
        vision_hidden_size=vision_hidden_size,
        vision_intermediate_size=vision_intermediate_size, vision_num_heads=vision_num_heads,
        head_group=head_group), **kw)
