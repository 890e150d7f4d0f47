"""Parameter accounting (port of efficientvlm_tpu/utils/params.py):
calculate_parameters leaves out embeddings and classifier heads, as the
reference's utils/utils.py does; log_all_parameters prints the tree."""

from __future__ import annotations

from typing import Iterable

from ..train.optim import path_str, tree_leaves_with_path

EXCLUDE_SUBSTRINGS = ("embedding", "cls", "head", "pos_embed", "temp")


def calculate_parameters(params, *, exclude: Iterable[str] = EXCLUDE_SUBSTRINGS) -> int:
    """Elements of the leaves whose path names none of `exclude`."""
    return sum(leaf.numel() for path, leaf in tree_leaves_with_path(params)
               if not any(e in path_str(path) for e in exclude))


def count_all_parameters(params) -> int:
    return sum(leaf.numel() for _, leaf in tree_leaves_with_path(params))


def log_all_parameters(params, *, print_fn=print) -> None:
    for path, leaf in tree_leaves_with_path(params):
        print_fn(f"{path_str(path)}: {tuple(leaf.shape)}")
    print_fn(f"total: {count_all_parameters(params):,} "
             f"(ex-embeddings/heads: {calculate_parameters(params):,})")
