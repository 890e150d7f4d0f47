"""The sharded full-state checkpoint backend (port of
efficientvlm_tpu/train/orbax_io.py; a config's `checkpoint_backend: orbax`
selects it, JAX's key and value).

The default backend writes the whole state from rank 0 into one file, so a
ZeRO-1 state's moments are gathered first. This one writes a directory,
<output_dir>/training_state_latest.shards:

- manifest.json (rank 0): the format, the world size, the driver's `extra`
  (as JSON: numpy numbers become plain ones) and the paths of the slices;
- replicated.pt (rank 0): the state's CPU copy (a TrainState as its field
  dict) with each ZeRO-1 slice left out (None);
- shards.rank<r>.pt (every rank): {path: tensor} of its own slices.

So each rank writes only its own shards, the moments go to disk sharded and
come back sharded. A save goes into <dir>.tmp and is renamed over the old
directory once every rank has written (atomic). prepare_save copies the
state to the CPU on the caller's thread (AdamW updates in place) and
returns the write and the commit; drivers/common.save_full_state runs the
write there or on its one background thread, and wait_for_saves joins it
and runs the commit, which synchronises the ranks: every rank calls it at
the same points.

torch.distributed.checkpoint would also write per-rank files, but it saves
plain tensors as replicated (rank 0's copy) and treats a tensor as a shard
only as a DTensor or ShardedTensor; the port's states are plain tensors and
dicts, so this backend writes its own files, read with weights_only=True.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Optional, Tuple

import numpy as np
import torch

from ..parallel import zero as Z
from ..utils import dist as D
from . import checkpoint as ckpt_io

FORMAT = "efficientvlm_tpu_torch.sharded/1"


def _jsonable(x):
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    if isinstance(x, np.bool_):
        return bool(x)
    if isinstance(x, torch.Tensor):
        return x.item() if x.numel() == 1 else x.tolist()
    return x


def _split(state) -> Tuple[dict, dict]:
    """(the state's field dict with the slices set to None, {path: slice}),
    the containers copied, the tensors the state's own."""
    fields = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    fields = {k: Z.copy_dicts(v) if isinstance(v, dict) else v for k, v in fields.items()}
    shards = {}
    for name in Z.MOMENT_FIELDS:
        opt_state = fields.get(name)
        if not isinstance(opt_state, dict) or Z.DIMS_KEY not in opt_state:
            continue
        dims = Z.dims_of(opt_state)
        for path, box, k in Z.leaf_lists(opt_state, len(dims), (name,)):
            for i, d in enumerate(dims):
                if d is not None:
                    shards["/".join(map(str, path + (i,)))] = box[k][i]
                    box[k][i] = None
    return fields, shards


def _fill(fields: dict, shards: dict) -> dict:
    for path, t in shards.items():
        *keys, i = path.split("/")
        node = fields
        for k in keys:
            node = node[k]
        node[int(i)] = t
    return fields


def _commit(tmp: str, final: str) -> None:
    D.barrier()
    if D.is_main_process():
        old = final + ".old"
        shutil.rmtree(old, ignore_errors=True)
        if os.path.isdir(final):
            os.rename(final, old)
        os.rename(tmp, final)
        shutil.rmtree(old, ignore_errors=True)
    D.barrier()


def _write(tmp: str, rank: int, fields: Optional[dict], shards: dict, manifest: Optional[dict]):
    torch.save(shards, os.path.join(tmp, f"shards.rank{rank}.pt"))
    if fields is not None:
        torch.save(fields, os.path.join(tmp, "replicated.pt"))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)


def prepare_save(path: str, state, extra: dict):
    """(write, commit) of `state` and `extra` into the directory `path`:
    every rank calls it, and then write() (its own slices; rank 0 the rest
    too) and commit() (the rename, a barrier), the write on any thread."""
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    rank = D.get_rank()
    if D.is_main_process():
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    D.barrier()
    fields, shards = _split(state)
    shards = ckpt_io.to_cpu(shards)  # copied on this thread: AdamW updates in place
    manifest = None
    if rank == 0:
        fields = ckpt_io.to_cpu(fields)
        manifest = {"format": FORMAT, "world": D.get_world_size(), "extra": _jsonable(extra),
                    "sharded": sorted(shards)}
    else:
        fields = None
    return (lambda: _write(tmp, rank, fields, shards, manifest)), (lambda: _commit(tmp, path))


def restore_state_dir(path: str, template_state):
    """(state, extra) of prepare_save's directory rebuilt in the template's
    structure on its devices, or None without the directory. The slices
    come back as this rank's slices: a whole-moment template is cut to the
    saved layout first (parallel/zero.shard_moments)."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        return None
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise ValueError(f"{path}: not a sharded state of this port ({manifest.get('format')})")
    if manifest["sharded"] and manifest["world"] != D.get_world_size():
        raise ValueError(f"{path}: sharded over {manifest['world']} ranks, restored over "
                         f"{D.get_world_size()}")
    fields = torch.load(os.path.join(path, "replicated.pt"), map_location="cpu",
                        weights_only=True)
    shards = torch.load(os.path.join(path, f"shards.rank{D.get_rank()}.pt"),
                        map_location="cpu", weights_only=True)
    fields = _fill(fields, shards)
    saved_sharded = any(isinstance(fields.get(n), dict) and Z.DIMS_KEY in fields[n]
                        for n in Z.MOMENT_FIELDS)
    if saved_sharded and not Z.is_sharded(template_state):
        template_state = Z.shard_moments(_clone_state(template_state))
    elif Z.is_sharded(template_state) and not saved_sharded:
        fields = Z.shard_saved(template_state, fields)
    state = ckpt_io.restore_pytree_like(template_state, fields)
    return state, dict(manifest["extra"] or {})


def _clone_state(state):
    """A copy of a state's containers (tensors shared) that shard_moments
    can cut without touching the caller's."""
    return dataclasses.replace(state, **{
        n: Z.copy_dicts(getattr(state, n)) for n in Z.MOMENT_FIELDS
        if isinstance(getattr(state, n, None), dict)})
