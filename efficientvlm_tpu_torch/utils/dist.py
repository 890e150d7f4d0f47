"""Process topology, single process (port of the single-process part of
efficientvlm_tpu/utils/dist.py). A run is rank 0 of 1; a launch of more
than one process (WORLD_SIZE > 1) raises until distribution is ported
(ROADMAP A6)."""

from __future__ import annotations

import builtins
import os
from typing import Optional


def get_rank() -> int:
    return 0


def get_world_size() -> int:
    return 1


def is_main_process() -> bool:
    return get_rank() == 0


def setup_for_distributed(is_master: bool) -> None:
    """print only on the main process, unless called with force=True."""
    builtin_print = builtins.print

    def print_fn(*args, **kwargs):
        force = kwargs.pop("force", False)
        if is_master or force:
            builtin_print(*args, **kwargs)

    builtins.print = print_fn


def init_distributed_mode(args: Optional[dict] = None) -> dict:
    """{"rank", "world_size", "num_devices", "local_devices"} of this run:
    rank 0 of 1. WORLD_SIZE above 1 raises NotImplementedError."""
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world > 1:
        raise NotImplementedError(
            f"WORLD_SIZE={world}: multi-process runs come with distribution (ROADMAP A6); "
            "the port runs one process on one device")
    return {"rank": 0, "world_size": 1, "num_devices": 1, "local_devices": 1}
