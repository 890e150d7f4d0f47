"""What bounds the probs core attn_probs (csrc/attn_probs.cuh) on the card:
builds copies of the port in which one part of the kernel is taken out, and
times each against the kernel as it is, on one NVIDIA GPU:

    python3 scripts/torch_probs_probe.py [--out DIR]

Variants (their results are wrong by design; only their time is read):
- `full`: the kernel as it is;
- `no_map_stores`: no TMA store of the maps and no plain store of their
  last keys (the staging and everything else as before);
- `no_kv_loads`: the producer hands out the ring slots without loading K or
  V (the consumers work on whatever the slots hold);
- `no_staging`: the consumers neither write the exponentiated scores to
  shared memory nor read and rewrite them when normalising;
- `no_ring_waits`: the consumers never wait on a slot or release it, and
  the producer loads only Q (the consumer warps' own work alone).
Each variant is a copy of efficientvlm_tpu_torch under --out (default
build/probe/, git-ignored) with its own kernel build, timed in its own
process at the ViT shapes of the training paths ([24, 577], [8, 901],
[128, 197], 12 heads): device us per call from torch.profiler, one JSON line
each, with the card's name and power limit. A patch that no longer applies
to the source fails the run. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((24, 577), (8, 901), (128, 197))

PRODUCER_LOAD = """        mbar_expect_tx(&full[sl.slot], TILE_BYTES);
        tma_load_3d(ring + sl.slot * TILE_BYTES, t < nt ? &p.k : &p.v, h * DH, (t % nt) * TK, b,
                    &full[sl.slot]);"""
STAGE_WRITES = """        *stage_at(chunk, row0, (nb % 4) * 8 + c2) = make_float2(e0, e1);
        *stage_at(chunk, row0 + 8, (nb % 4) * 8 + c2) = make_float2(e2, e3);"""
NORMALISE = """        const float2 pa = make_float2(a->x * f0, a->y * f0);
        const float2 pd = make_float2(d->x * f1, d->y * f1);
        *a = pa;
        *d = pd;"""
PATCHES = {
    "full": [],
    "no_map_stores": [("if (j * TK + c * HALF < p.s4)", "if (false)"),
                      ("if (key + 1 >= p.s4 && key < p.s)", "if (false)")],
    "no_kv_loads": [(PRODUCER_LOAD, "        mbar_arrive(&full[sl.slot]);")],
    "no_staging": [
        (STAGE_WRITES, "        if (e0 == -1.0f) *stage_at(chunk, row0, c2) = make_float2(e2, e3);"),
        (NORMALISE, "        const float2 pa = make_float2(f0 * nb, f0), pd = make_float2(f1 * nb, f1);\n"
                    "        if (f0 == -1.0f) *a = pa, *d = pd;")],
    "no_ring_waits": [
        ("      for (int t = 0; t < 2 * nt; ++t) {\n        const Slot sl = slot_of(t, nt, KS);",
         "      for (int t = 0; t < 0; ++t) {\n        const Slot sl = slot_of(t, nt, KS);"),
        ("      mbar_wait(&full[st], sl.round & 1);\n      const uint32_t tile",
         "      const uint32_t tile"),
        ("      if (lane == 0) mbar_arrive(&empty[st]);  // K read", "      // K read"),
        ("      mbar_wait(&full[st], sl.round & 1);\n      const uint32_t tile",
         "      const uint32_t tile"),
        ("      __syncwarp();\n      if (lane == 0) mbar_arrive(&empty[st]);\n    }",
         "      __syncwarp();\n    }")],
}


def make_variant(out: str, name: str) -> str:
    root = os.path.join(out, name)
    pkg = os.path.join(root, "efficientvlm_tpu_torch")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "efficientvlm_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(pkg, "csrc", "attn_probs.cuh")
    with open(path) as f:
        src = f.read()
    for old, new in PATCHES[name]:
        if old not in src:
            raise SystemExit(f"torch_probs_probe: the {name} patch no longer applies")
        src = src.replace(old, new, 1)
    with open(path, "w") as f:
        f.write(src)
    return root


def time_variant(root: str, name: str) -> dict:
    """In this process: the variant's kernel, built from its copy, timed."""
    sys.path.insert(0, root)
    sys.path.insert(1, HERE)
    import torch

    from efficientvlm_tpu_torch.kernels import bindings as K
    from efficientvlm_tpu_torch.ops import fused_mha as F

    import chip_smoke as cs

    rnd, us = cs.Rand(7), {}
    for b, s in SHAPES:
        q, k, v = rnd(b * s, 768), rnd(b * s, 768), rnd(b * s, 768)
        kb = F._key_bias(b, s, rnd.mask(b, s, s // 4), None, q.device)
        hz = rnd.gates(12)
        with torch.inference_mode():
            us[f"[{b},{s}]"] = cs.device_us(
                lambda: K.attn_probs(q, k, v, kb, hz, batch=b, tq=s, s=s))[0]
    return {"variant": name, "device_us": us,
            "tile": {f"[{b},{s}]": K.probs_tile(64, s, s) for b, s in SHAPES}}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(HERE, "build", "probe"))
    p.add_argument("--variant")  # internal: time one variant in this process
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_probs_probe: no CUDA device", file=sys.stderr)
        return 2
    if args.variant:
        print(json.dumps(time_variant(os.path.join(args.out, args.variant), args.variant)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi}))
    for name in PATCHES:
        make_variant(args.out, name)
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--out", args.out,
                              "--variant", name], capture_output=True, text=True, timeout=600)
        lines = [line for line in run.stdout.splitlines() if line.startswith("{")]
        if run.returncode != 0 or not lines:
            print(run.stdout[-2000:], run.stderr[-2000:], file=sys.stderr)
            raise SystemExit(f"torch_probs_probe: variant {name} failed")
        print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
