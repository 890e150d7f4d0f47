"""Bare attention cores over already projected q/k/v (port of
efficientvlm_tpu/ops/pallas_attention.py):

- `flash_attention` <- `_flash_attention_padded` (`_kernel_vec` /
  `_kernel_mat`): q [B,H,Tq,dh] already scaled, k/v [B,H,Tk,dh], an additive
  bias that is a key vector [B|1,1,1,Tk] or a full matrix [B|1,1,Tq,Tk];
- `flash_attention_grouped` <- `_flash_attention_grouped_padded`: q
  [Bk*G,H,Tq,dh] with each group's G rows contiguous, k/v [Bk,H,S,dh] shared
  by the group, one key vector per group [1|Bk,1,1,S].

On a CUDA tensor each wrapper runs csrc/flash_attention.cu in bfloat16 and
raises on anything else; on a CPU tensor it runs the plain version below,
which does the TPU kernels' arithmetic: f32 scores and softmax, the
probabilities rounded to the compute dtype before P.V, f32 accumulation.
Nothing is padded to 128 lanes (a TPU layout fact), and the grouped core
never repeats K/V: the group is folded into the query rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import bindings


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    scores = q.float() @ k.float().transpose(-1, -2)
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return (probs.float() @ v.float()).to(q.dtype)


def _fold(q: torch.Tensor, bk: int, g: int) -> torch.Tensor:
    """[Bk*G, H, Tq, dh] -> [Bk, H, G*Tq, dh]: a group's rows side by side."""
    _, h, tq, dh = q.shape
    return q.reshape(bk, g, h, tq, dh).transpose(1, 2).reshape(bk, h, g * tq, dh)


def flash_attention_grouped_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  kv_groups: int,
                                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    bq, h, tq, dh = q.shape
    bk = k.shape[0]
    out = flash_attention_plain(_fold(q, bk, kv_groups), k, v, bias)
    return out.reshape(bk, h, kv_groups, tq, dh).transpose(1, 2).reshape(bq, h, tq, dh)


def _key_vectors(bias: Optional[torch.Tensor], tk: int, device) -> torch.Tensor:
    """[1|B,1,1,Tk] additive bias (or None) -> f32 [1|B, Tk]."""
    if bias is None:
        return torch.zeros(1, tk, device=device)
    return bias[:, 0, 0, :].float().contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B,H,Tq,dh] (already scaled), k/v [B,H,Tk,dh]; bias additive
    [B|1,1,1,Tk] (key vector) or [B|1,1,Tq,Tk] (matrix) or None. Returns
    [B,H,Tq,dh]."""
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    if k.shape[0] != b or v.shape != k.shape:
        raise ValueError(f"flash attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if bias is not None and (bias.ndim != 4 or bias.shape[0] not in (1, b)
                             or bias.shape[1] != 1 or bias.shape[2] not in (1, tq)
                             or bias.shape[3] != tk):
        raise ValueError(f"flash attention: bias {tuple(bias.shape)} is neither "
                         f"[{b}|1,1,1,{tk}] nor [{b}|1,1,{tq},{tk}]")
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, bias)
    if bias is not None and bias.shape[2] != 1:
        arg = bias[:, 0].float().contiguous()  # [B|1, Tq, Tk]
    else:
        arg = _key_vectors(bias, tk, q.device)
    out = bindings.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), arg)
    flash_attention.launches += 1
    return out


def flash_attention_grouped(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            kv_groups: int,
                            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [Bk*G,H,Tq,dh] (already scaled, groups contiguous), k/v
    [Bk,H,S,dh]; bias one additive key vector per group [1|Bk,1,1,S] or None
    (a per-query-row or matrix bias is an error). Returns [Bk*G,H,Tq,dh]."""
    bq, h, tq, dh = q.shape
    bk, _, s, _ = k.shape
    g = kv_groups
    if bq != bk * g:
        raise ValueError(f"flash grouped: query batch {bq} != {g} * kv batch {bk}")
    if bias is not None and (bias.ndim != 4 or bias.shape[0] not in (1, bk)
                             or bias.shape[1:3] != (1, 1) or bias.shape[3] != s):
        raise ValueError(f"flash grouped: bias {tuple(bias.shape)} is not one key vector "
                         f"per group [{bk}|1,1,1,{s}]")
    if not q.is_cuda:
        return flash_attention_grouped_plain(q, k, v, g, bias)
    out = bindings.flash_attention_grouped(q.contiguous(), k.contiguous(), v.contiguous(),
                                           _key_vectors(bias, s, q.device), groups=g)
    flash_attention_grouped.launches += 1
    return out


flash_attention.launches = 0
flash_attention_grouped.launches = 0
