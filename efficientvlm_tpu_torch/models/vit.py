"""CLIP-ViT vision encoder, functional and gated (port of
efficientvlm_tpu/models/vit.py).

conv patch-embed (no bias) -> [CLS] + learned pos-embed -> pre-LN ->
N pre-LN transformer layers (quick_gelu MLP) -> post-LN.

impl="fused" runs the input stage through fused_patch_embed and every
self-attention sublayer through fused_self_attention (hand-written kernels
on CUDA, their plain versions on the CPU); impl="plain" runs the plain
PyTorch path.

Region batches (general distillation): the last `local_attn_depth` layers
run local attention. `image_atts` [n_txt, 1+Np] holds one patch mask per
region text (the CLS position is 1); stacked on all-ones rows for the full
images it is the key mask of the local layers. At the first local layer
the rows of each text's image are gathered (idx_to_group_img) and stacked
on top of the full batch, so those layers run n_txt + B rows; the output
splits into `last_hidden` (the n_txt region rows) and `full_atts_hidden`
(the B full images). On the kernel path the key mask goes into
fused_self_attention(mask=...), whose kernel takes it as a key vector.

Training (train=True): a layer fuses through the kernels' differentiable
forms, and only while attention_dropout is 0 (CLIP's is); otherwise
multi_head_attention runs with dropout on the probabilities. A layer with
int8 projections (ops/quant.py) runs multi_head_attention too: its
projections quantized, its core the flash kernel under impl="fused".
An eval-mode forward (train=False) that autograd records (SCST's
teacher-forced log-probs) takes the differentiable forms too
(ops/attention.graded is the rule).
output_attentions / output_hidden_states collect the KD taps: each layer's
input and the last layer's output (before the post-LN), and each layer's
pre-gate f32 probabilities.

A config's `remat: true` recomputes each layer in the backward
(ops/basic.remat, which replays the generator's dropout draws), as JAX's
jax.checkpoint on its layer scan. Under parallel/sharding.tensor_parallel a
layer runs on its rank's heads and FFN units (the params from
sharding.shard_params); with `act_partition` under
sharding.sequence_parallel each rank runs a token block and
self-attention is the cross form over the gathered tokens (forward only).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..config import VisionConfig
from ..ops.attention import graded, init_attention, make_attention_bias, multi_head_attention
from ..ops.basic import ACT2FN, dense, init_dense, init_layer_norm, layer_norm, remat
from ..ops.fused_mha import fused_cross_attention, fused_self_attention
from ..ops.patch_embed import fused_patch_embed, patch_embed_plain
from ..ops.quant import is_fusable, out_width
from ..parallel.sharding import seq_shard, tp_attention, tp_enter, tp_exit, tp_row, tp_slice


def init_vit(generator: torch.Generator, cfg: VisionConfig, device=None) -> dict:
    d = cfg["vision_width"]
    p = cfg["patch_size"]
    n_pos = cfg.num_patches + 1

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device) * 0.02

    params = {
        "patch_embed": {"kernel": randn(p, p, 3, d)},  # HWIO, no bias
        "class_embedding": randn(d),
        "pos_embed": {"embedding": randn(n_pos, d)},
        "pre_ln": init_layer_norm(d, device),
        "post_ln": init_layer_norm(d, device),
        "layers": [],
    }
    for _ in range(cfg["num_hidden_layers"]):
        params["layers"].append({
            "ln1": init_layer_norm(d, device),
            "attn": init_attention(generator, d, cfg["num_attention_heads"], device=device),
            "ln2": init_layer_norm(d, device),
            "mlp": {
                "fc1": init_dense(generator, d, cfg["intermediate_size"], device=device),
                "fc2": init_dense(generator, cfg["intermediate_size"], d, device=device),
            },
        })
    return params


def _num_heads(layer_params: dict, head_dim: int) -> int:
    if layer_params.get("attn") is None:
        return 0
    return out_width(layer_params["attn"]["q"]) // head_dim


def vit_layer(lp: dict, h: torch.Tensor, *, num_heads: int, act,
              key_mask: Optional[torch.Tensor] = None,
              head_z: Optional[torch.Tensor] = None, head_layer_z=None,
              mlp_z: Optional[torch.Tensor] = None, output_probs: bool = False,
              dropout_rate: float = 0.0, train: bool = False, generator=None, dtype=None,
              impl: str = "fused", seq=None, seq_bias: Optional[torch.Tensor] = None):
    """Pre-LN CLIP layer; returns (h, probs or None). key_mask [B, S] (1 =
    attend) masks keys (the region masks of the local layers). `seq` (a
    sharding.SeqShard) makes h a token block whose self-attention reads the
    gathered tokens' K/V under `seq_bias` [B, S] (additive)."""
    probs = None
    if lp.get("attn") is not None:  # fully-pruned attention -> identity
        x = tp_enter(layer_norm(lp["ln1"], h, eps=1e-5))
        attn, head_z = tp_attention(lp["attn"]), tp_slice(head_z)
        kv = None if seq is None else seq.gather_tokens(x)
        if impl == "fused" and (not train or dropout_rate == 0.0) and is_fusable(attn):
            xd = x.to(dtype) if dtype is not None else x
            kw = dict(num_heads=num_heads, head_z=head_z, return_probs=output_probs,
                      differentiable=graded(x, head_z, attn))
            res = (fused_self_attention(attn, xd, mask=key_mask, **kw) if kv is None else
                   fused_cross_attention(attn, xd, kv.to(xd.dtype), key_bias=seq_bias, **kw))
            attn_out, probs = res if output_probs else (res, None)
            if head_layer_z is not None:
                attn_out = attn_out * torch.as_tensor(
                    head_layer_z, dtype=attn_out.dtype, device=attn_out.device)
        else:
            if kv is not None:
                bias = seq_bias[:, None, None, :]
            else:
                bias = None if key_mask is None else make_attention_bias(key_mask)
            attn_out, probs, _ = multi_head_attention(
                attn, x, kv, num_heads=num_heads, bias=bias,
                head_z=head_z, head_layer_z=head_layer_z, output_probs=output_probs,
                dropout_rate=dropout_rate, generator=generator, train=train, dtype=dtype,
                impl=impl)
        h = h + tp_exit(attn_out)

    if lp.get("mlp") is not None:  # fully-pruned FFN -> identity
        x = tp_enter(layer_norm(lp["ln2"], h, eps=1e-5))
        x = dense(lp["mlp"]["fc1"], x, dtype=dtype)
        if mlp_z is not None:
            # the ViT gates the FFN between fc1 and the activation (the text
            # tower gates after it); continuous gates tell the two apart
            x = x * tp_slice(mlp_z).to(x.dtype)
        x = act(x)
        h = h + tp_exit(dense(tp_row(lp["mlp"]["fc2"]), x, dtype=dtype))
    return h, probs


def vit_apply(params: dict, images: torch.Tensor, cfg: VisionConfig, *,
              idx_to_group_img=None, image_atts=None, head_z=None, head_layer_z=None,
              mlp_z=None, output_attentions: bool = False, output_hidden_states: bool = False,
              train: bool = False, generator=None, dtype=None, impl: str = "fused") -> dict:
    """images [B,H,W,3] NHWC; head_z/mlp_z [L,H] / [L,I] stacked per-layer
    gates (None = dense); idx_to_group_img [n_txt] and image_atts [n_txt,
    1+Np] make a region batch (see the module note). Returns {"last_hidden":
    [B, 1+Np, D], "hidden_states", "attentions"} (the lists None unless
    asked for); a region batch's last_hidden holds its n_txt region rows
    and "full_atts_hidden" [B, 1+Np, D] the full images."""
    act = ACT2FN[cfg["hidden_act"]]
    depth = cfg["num_hidden_layers"]
    local_depth = cfg.get("local_attn_depth", 0)
    if idx_to_group_img is not None and local_depth <= 0:
        # the gather happens at the first local layer: without one there are
        # no region rows, and the bbox head would see an empty batch
        raise ValueError("region batches (idx_to_group_img) need a vision config with "
                         "local_attn_depth > 0")
    head_dim = cfg["vision_width"] // cfg["num_attention_heads"]
    embed_dtype = dtype or torch.promote_types(images.dtype,
                                               params["patch_embed"]["kernel"].dtype)
    if impl == "fused":
        h = fused_patch_embed(params, images, patch_size=cfg["patch_size"], eps=1e-5,
                              dtype=embed_dtype,
                              differentiable=graded(images, *(
                                  params.get(k) for k in ("patch_embed", "class_embedding",
                                                          "pos_embed", "pre_ln"))))
    else:
        h = patch_embed_plain(params, images, patch_size=cfg["patch_size"], eps=1e-5,
                              dtype=embed_dtype)
    local_mask = None
    if idx_to_group_img is not None and image_atts is not None:
        full = torch.ones(h.shape[:2], dtype=torch.float32, device=h.device)
        local_mask = torch.cat([image_atts.float(), full], 0)
    seq = seq_shard(cfg, h.shape[1])
    seq_bias = None
    if seq is not None:
        if idx_to_group_img is not None:
            raise NotImplementedError("act_partition: region batches have no sequence axis")
        seq_bias = seq.key_bias(None, h.shape[0], h.device)
        h = seq.split(h)
    all_hidden = [] if output_hidden_states else None
    all_probs = [] if output_attentions else None
    for i, lp in enumerate(params["layers"]):
        if output_hidden_states:
            all_hidden.append(h)  # before the gather, as JAX takes it
        is_local = local_depth > 0 and i >= depth - local_depth
        if idx_to_group_img is not None and i == depth - local_depth:
            h = torch.cat([h[idx_to_group_img], h], 0)
        layer = functools.partial(
            vit_layer, lp, h, num_heads=_num_heads(lp, head_dim), act=act,
            key_mask=local_mask if is_local else None,
            head_z=None if head_z is None else head_z[i],
            head_layer_z=None if head_layer_z is None else head_layer_z[i],
            mlp_z=None if mlp_z is None else mlp_z[i], output_probs=output_attentions,
            dropout_rate=cfg.get("attention_dropout", 0.0), train=train, generator=generator,
            dtype=dtype, impl=impl, seq=seq, seq_bias=seq_bias)
        h, probs = remat(layer, generators=(generator,)) if cfg.get("remat") else layer()
        if output_attentions:
            all_probs.append(probs)
    if output_hidden_states:
        all_hidden.append(h)
    h = layer_norm(params["post_ln"], h, eps=1e-5)
    if seq is not None:
        h = seq.gather(h)
        all_hidden = None if all_hidden is None else [seq.gather(x) for x in all_hidden]
        all_probs = None if all_probs is None else [seq.gather(p, 2, keys=True)
                                                    for p in all_probs]
    out = {"last_hidden": h, "hidden_states": all_hidden, "attentions": all_probs}
    if idx_to_group_img is not None:
        n_txt = idx_to_group_img.shape[0]
        out["last_hidden"], out["full_atts_hidden"] = h[:n_txt], h[n_txt:]
    return out


def interpolate_pos_embed(pos_embed: torch.Tensor, num_patches_new: int) -> torch.Tensor:
    """[N+1, D] -> [N'+1, D]: the CLS row kept, the sqrt(N) x sqrt(N) grid
    resized to sqrt(N') x sqrt(N') as the reference does (its
    models/vit.py interpolate_pos_embed): F.interpolate(mode="bicubic",
    align_corners=False), Keys' cubic with a = -0.75 and no antialiasing,
    in f32. JAX's interpolate_pos_embed resizes with jax.image.resize
    (a = -0.5, antialiased when it shrinks); the port does not copy that."""
    cls, emb = pos_embed[:1], pos_embed[1:]
    size_old, size_new = int(emb.shape[0] ** 0.5), int(num_patches_new ** 0.5)
    if size_old == size_new:
        return pos_embed
    d = emb.shape[-1]
    grid = emb.float().reshape(1, size_old, size_old, d).permute(0, 3, 1, 2)
    grid = torch.nn.functional.interpolate(grid, size=(size_new, size_new), mode="bicubic",
                                           align_corners=False)
    grid = grid.permute(0, 2, 3, 1).reshape(size_new * size_new, d)
    return torch.cat([cls.float(), grid], 0)
