"""Export a pruned student: learned gates -> deterministic masks -> physically
sliced params -> a native file and a torch-keyed checkpoint (port of
scripts/export_pruned.py; the reference's utils/xvlm_utils.load_model_with_zs
-> update_params -> prune_model_with_z, SURVEY §3.5):

  python -m efficientvlm_tpu_torch.scripts.export_pruned \\
      --training_state out/itr/training_state_latest.ckpt --task itr --out pruned_student

It reads the port's native files (train/checkpoint: a full training state or
a model snapshot with its gates), prints the kept units per gate group and
the parameter reduction, and writes <out>.ckpt (the sliced tree, the port's
native format, which the service, infer and --evaluate read as a dense
model) and <out>.th (the reference's X-VLM keys; skipped, as JAX's script
skips it, for a tree without them: the captioning and VQA layouts).
Reading the JAX package's msgpack .ckpt is not supported (ROADMAP A2).

The gate layout's head grouping (a config's head_gate_group) is read from
the stored head log-alphas: num_heads / their width. JAX's script builds its
layout with one gate a head whatever the state holds (ROADMAP C).
"""

from __future__ import annotations

import argparse
import json

import torch

from ..pruning.export import prune_xvlm_params
from ..pruning.l0_module import NLVRL0Module, VQAL0Module, XVLML0Module
from ..train import checkpoint as C
from ..utils.params import count_all_parameters


def build_l0(task: str, *, vision_layers=6, text_layers=3, cross_layers=3, **kw):
    factory = {"itr": XVLML0Module, "caption": XVLML0Module, "vqa": VQAL0Module,
               "nlvr": NLVRL0Module}[task]
    return factory(vision_layers=vision_layers, text_layers=text_layers,
                   cross_layers=cross_layers, **kw)


def head_group(loga: dict, num_heads: int) -> int:
    """The heads one learned gate drives: num_heads over the width of the
    stored head log-alphas (1 without head gates)."""
    width = next((v.shape[-1] for k, v in loga.items() if k.endswith("_head")), num_heads)
    if num_heads % width:
        raise SystemExit(f"head log-alphas of width {width} do not divide {num_heads} heads")
    return num_heads // width


def _l0_kw(args, loga: dict) -> dict:
    kw = dict(vision_layers=args.vision_layers, text_layers=args.text_layers,
              cross_layers=args.cross_layers, hidden_size=args.hidden_size,
              intermediate_size=args.intermediate_size, num_heads=args.num_heads,
              head_group=head_group(loga, args.num_heads))
    if args.task == "vqa":
        kw["decoder_layers"] = args.decoder_layers
    return kw


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--training_state", required=True)
    ap.add_argument("--task", default="itr", choices=["itr", "vqa", "nlvr", "caption"])
    ap.add_argument("--out", default="pruned_student")
    ap.add_argument("--fusion_layer", type=int, default=3)
    ap.add_argument("--head_dim", type=int, default=64)
    # the gate layout's geometry, as trained (defaults: the x-vlm-small student,
    # 6L vision / 3 + 3 text + cross, 768 / 12 / 3072 towers)
    ap.add_argument("--vision_layers", type=int, default=6)
    ap.add_argument("--text_layers", type=int, default=3)
    ap.add_argument("--cross_layers", type=int, default=3)
    ap.add_argument("--decoder_layers", type=int, default=None)
    ap.add_argument("--hidden_size", type=int, default=768)
    ap.add_argument("--intermediate_size", type=int, default=3072)
    ap.add_argument("--num_heads", type=int, default=12)
    ap.add_argument("--quantize", default="none", choices=["none", "w8", "w8a8"],
                    help="post-training int8 quantization of the sliced params (ops/quant.py); "
                         "no .th for a quantized tree (the torch loaders expect float kernels)")
    ap.add_argument("--quant_min_dim", type=int, default=256,
                    help="only quantize 2-D kernels with min(shape) >= this")
    args = ap.parse_args(argv)

    params, l0_params = C.extract_model_and_gates(C.load_params(args.training_state))
    if l0_params is None:
        raise SystemExit(
            f"{args.training_state} carries no L0 gate parameters (a physical export or a "
            "gate-free pretrain state): nothing to slice. Export needs a pruning fine-tune's "
            "training state or model snapshot.")

    l0 = build_l0(args.task, **_l0_kw(args, l0_params["loga"]))
    zs = l0.forward_deterministic({"loga": l0_params["loga"]})
    sizes = l0.calculate_model_size(zs)
    print(json.dumps({k: v for k, v in sizes.items() if not isinstance(v, list)}, indent=2))
    for k, v in sizes.items():
        if isinstance(v, list):
            print(f"  {k}: {v}")

    n_before = count_all_parameters(params)
    pruned = prune_xvlm_params(params, {k: v.cpu().numpy() for k, v in zs.items()},
                               fusion_layer=args.fusion_layer, head_dim=args.head_dim,
                               nlvr=args.task == "nlvr")
    n_after = count_all_parameters(pruned)
    print(f"params: {n_before:,} -> {n_after:,} ({100 * (1 - n_after / n_before):.1f}% removed)")

    if args.quantize != "none":
        from ..ops.quant import quantize_params, quantized_bytes

        pruned = quantize_params(pruned, mode=args.quantize, min_dim=args.quant_min_dim)
        b = quantized_bytes(pruned)
        print(f"int8 {args.quantize}: {b['quantized_bytes']:,} bytes "
              f"({100 * b['quantized_bytes'] / b['float32_bytes']:.0f}% of float32)")

    C.save_pytree(args.out + ".ckpt", pruned)
    print(f"saved {args.out}.ckpt")
    if args.quantize != "none":
        return
    try:  # the reference's X-VLM keys: a tree without its text tower or heads has none
        sd = C.xvlm_state_dict_from_params(pruned, fusion_layer=args.fusion_layer)
    except KeyError as e:
        print(f"torch export skipped: no {e} in the tree for the reference's keys")
        return
    torch.save({"model": sd}, args.out + ".th")
    print(f"saved {args.out}.th (torch-keyed)")


if __name__ == "__main__":
    main()
