"""Times the port's kernel wrappers at every main-path shape of the tree at
--root (this repository by default), on one NVIDIA GPU, so that two trees
can be compared in one run on one card:

    python3 scripts/torch_flash_bench.py [--root DIR] [--tag NAME] [--kernels K1,K2]

By default the two bare attention cores (#5 flash_attention_grouped, #6
flash_attention); --kernels names others of chip_smoke.py's kernel cases
(patch_embed for #1, fused_cross_attention_grouped for #4, ...). The
cases, their inputs (seed 0) and their library yardstick are the tree's
own: `kernel_cases`, `library_yardstick` and `patch_yardstick` of
DIR/chip_smoke.py, each case calling the wrapper as that tree's callers
call it; the edge cases are left out. The timing helpers are this
repository's chip_smoke.py. Per case it prints one JSON line with
- `wrapper_ms` / `library_ms`: CUDA events, median of 7 runs of 20 calls,
  the wrapper's and the library call's runs in turns;
- `device_us` / `library_device_us`: device time per call from
  torch.profiler device events, and `device_launches` per wrapper call;
- `host_us`: host time per wrapper call, when it only queues work;
- `bound_ms`: bytes (each input read once, the output written once) over
  3.35 TB/s, or FLOP over 989 TFLOP/s if larger.
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
    p.add_argument("--kernels", default="flash_attention,flash_attention_grouped")
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_flash_bench: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)  # the tree's own efficientvlm_tpu_torch
    from efficientvlm_tpu_torch.kernels.build import build

    build()
    smoke, tree = load(HERE, "bench_helpers"), load(root, "tree_chip_smoke")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"tag": args.tag, "root": root, "card": smi}))
    kernels = args.kernels.split(",")
    for name, case, run, _, flops, nbytes, extra in tree.kernel_cases(tree.Rand(0)):
        if name not in kernels or case.startswith("edge_"):
            continue
        lib = (tree.patch_yardstick(*extra) if name == "patch_embed"
               else tree.library_yardstick(name, extra))
        with torch.inference_mode():
            ms, lib_ms = smoke.timed_pair_ms(run, lib)
            (dev, launches), lib_dev = smoke.device_us(run), smoke.device_us(lib)[0]
            host = smoke.host_us(run)
        print(json.dumps({"case": case, "kernel": name, "tag": args.tag, "wrapper_ms": ms,
                          "library_ms": lib_ms, "device_us": dev, "device_launches": launches,
                          "library_device_us": lib_dev, "host_us": host,
                          "bound_ms": smoke.bound(flops, nbytes)[0]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
