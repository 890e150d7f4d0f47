"""Times the probs forms of #2 and #3 (the KD attention maps) of the tree at
--root (this repository by default), on one NVIDIA GPU, so that two trees
can be compared in one run on one card:

    python3 scripts/torch_probs_bench.py [--root DIR] [--tag NAME]

The sublayer cases, their inputs and their library composition are the
tree's own: `probs_cases` (seed 0), `gd_probs_cases` (seed 3) and
`task_probs_cases` (seed 4) of DIR/chip_smoke.py, each calling the wrapper
with return_probs=True as the training paths do. The core alone is timed at
this repository's `probs_core_cases` (seed 5) through the tree's
bindings.attn_core(probs=True), which is the probs core where the tree has
one, else attn_core's two-sweep form. The timing helpers are this
repository's chip_smoke.py. One JSON line per case:
- `ms` / `library_ms`: CUDA events, median of 7 runs of 20 calls, the
  wrapper's and the library composition's runs in turns;
- `device_us` and `device_launches` per call (torch.profiler device
  events); `host_us`: host time per call when it only queues work;
- `bound_ms`: bytes (each input read once, the output and the f32 maps
  written once) over 3.35 TB/s, or FLOP over 989 TFLOP/s if larger;
- for the core: `maps_gbps`, the maps' bytes over its CUDA-event time, and
  `zero_ms` / `zero_gbps`, the card's own write of the same maps buffer
  (maps.zero_(), timed in turns with the core); at the shapes of more than
  40 query rows `no_maps_ms`: attention without maps at the same shape
  (the tree's attn_core and attn_wgmma, in turns);
- where the tree has the probs core, its tile sweep: `tiles`, the core's
  ms by tile (rows a block x warps a 16-row group), from 32 rows below to
  16 above probs_tile's and 1-5 warps, each that fits (the measurement
  behind bindings.probs_tile's rule).
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(root: str, name: str):
    """root/chip_smoke.py as module `name`."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(root, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=HERE)
    p.add_argument("--tag", default="")
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_probs_bench: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)  # the tree's own efficientvlm_tpu_torch
    from efficientvlm_tpu_torch.kernels.build import build

    build()
    smoke, tree = load(HERE, "bench_helpers"), load(root, "tree_chip_smoke")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"tag": args.tag, "root": root, "card": smi}))
    cases = (tree.probs_cases(tree.Rand(0)) + tree.gd_probs_cases(tree.Rand(3))
             + tree.task_probs_cases(tree.Rand(4)))
    for name, case, run, _, flops, nbytes, _, lib in cases:
        with torch.inference_mode():
            ms, lib_ms = smoke.timed_pair_ms(run, lib)
            dev, launches = smoke.device_us(run)
            host = smoke.host_us(run, calls=50)
        print(json.dumps({"case": case, "kernel": name, "tag": args.tag, "ms": ms,
                          "library_ms": lib_ms, "device_us": dev, "device_launches": launches,
                          "host_us": host, "bound_ms": smoke.bound(flops, nbytes)[0]}))
    del cases
    from efficientvlm_tpu_torch.kernels import bindings as K

    for name, case, run, _, flops, nbytes, _, lib, zero, core_args in \
            smoke.probs_core_cases(smoke.Rand(5)):
        q, k, v, kb, hz, b, tq, s = core_args
        maps_bytes = 4 * b * hz.numel() * tq * s
        row = {"case": case, "kernel": name, "tag": args.tag}
        with torch.inference_mode():
            ms, lib_ms = smoke.timed_pair_ms(run, lib)
            zero_ms = smoke.timed_pair_ms(run, zero)[1]
            dev = smoke.device_us(run)[0]
            if tq > 40:
                row["no_maps_ms"] = dict(zip(("attn_core", "attn_wgmma"), smoke.timed_pair_ms(
                    lambda: K.attn_core(q, k, v, kb, hz, batch=b, tq=tq, s=s),
                    lambda: K.attn_wgmma(q, k, v, kb, hz, batch=b, tq=tq, s=s))))
            if hasattr(K, "_attn_probs_tile"):
                row["tiles"] = tile_sweep(smoke, K, core_args)
        print(json.dumps({**row, "ms": ms, "library_ms": lib_ms, "device_us": dev,
                          "maps_gbps": maps_bytes / ms / 1e6, "zero_ms": zero_ms,
                          "zero_gbps": 4 * zero.__self__.numel() / zero_ms / 1e6,
                          "bound_ms": smoke.bound(flops, nbytes)[0]}))
    return 0


def tile_sweep(smoke, K, core_args) -> dict:
    """The probs core's CUDA-event ms at each tile around probs_tile's: rows
    a block from 32 below to 16 above its rows (up to Tq's 16-row groups),
    1-5 warps a 16-row group, each that fits."""
    q, k, v, kb, hz, b, tq, s = core_args
    r0, times = K.probs_tile(64, tq, s)[0], {}
    for rows in range(r0 - 32, r0 + 17, 16):
        for warps in range(1, 6):
            if rows > -(-tq // 16) * 16 or not K.probs_tile_fits(rows, s, warps):
                continue
            times[f"{rows}x{warps}"] = smoke.timed_ms(
                lambda: K._attn_probs_tile(q, k, v, kb, hz, b, tq, s, rows, warps))
    return times


if __name__ == "__main__":
    sys.exit(main())
