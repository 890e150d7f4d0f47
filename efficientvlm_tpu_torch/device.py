"""Device policy: the port runs on CUDA unless the caller asks for the CPU.

An entry point given no device resolves to `cuda` and raises when there is
no GPU; it never moves to the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: pass device='cpu' to run the "
                "port's plain versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def strict_fp32() -> None:
    """Full-f32 matmuls and convolutions (no TF32) wherever the port is
    compared with a reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
