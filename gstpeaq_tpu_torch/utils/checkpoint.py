"""Checkpoint and resume of a stream's state, in the JAX package's npz form.

A stream's state (parallel/stream.py) is a tree of tensors: dicts, tuples
and leaves.  `save_state` writes it as gstpeaq_tpu/utils/checkpoint.py
writes its npz fallback: `format_version` and one `leaf_i` per leaf in the
order `jax.tree.flatten` gives (dict keys sorted, tuples and lists in
order, None dropped), so that either package resumes the other's
checkpoint.  The JAX package writes that form only where orbax is absent;
an orbax checkpoint (a directory) is not read here.

The tree walk (`tree_flatten`, `tree_unflatten`, `tree_map`) is written
here, without JAX.
"""

from __future__ import annotations

import pathlib
from typing import Any, Callable

import numpy as np
import torch


def _format_version() -> int:
    from ..parallel.stream import STATE_FORMAT_VERSION
    return STATE_FORMAT_VERSION


def _children(tree):
    """A node's children in flatten order, or None for a leaf."""
    if isinstance(tree, dict):
        return [tree[key] for key in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return list(tree)
    return None


def tree_flatten(tree) -> list:
    """The leaves of `tree` in jax.tree.flatten's order."""
    if tree is None:
        return []
    children = _children(tree)
    if children is None:
        return [tree]
    return [leaf for child in children for leaf in tree_flatten(child)]


def tree_unflatten(like, leaves):
    """A tree of `like`'s structure holding `leaves` in flatten order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {key: build(node[key]) for key in sorted(node)}
            return {key: built[key] for key in node}
        if isinstance(node, (tuple, list)):
            return type(node)(build(child) for child in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree):
    """`tree` with fn applied to each leaf."""
    return tree_unflatten(tree, [fn(leaf) for leaf in tree_flatten(tree)])


def _check_version(found: int | None, path: str) -> None:
    want = _format_version()
    if found is None:
        raise ValueError(
            f"checkpoint {path!r} carries no state-format version: it was "
            f"written by a pre-v{want} revision whose state layout is "
            "incompatible (complex biquad carries / transposed e0 tail); "
            "re-run the evaluation from the start")
    if int(found) != want:
        raise ValueError(
            f"checkpoint {path!r} has state-format version {int(found)}, "
            f"this build expects {want}; the carried state layouts are "
            "incompatible — re-run the evaluation from the start")


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_state(path: str, state: Any) -> None:
    """Write a stream's state to `path` + ".npz"."""
    np.savez(str(pathlib.Path(path)) + ".npz",
             format_version=np.int64(_format_version()),
             **{f"leaf_{i}": _numpy(v)
                for i, v in enumerate(tree_flatten(state))})


def load_state(path: str, like: Any) -> Any:
    """Read a state that save_state (of either package, in its npz form)
    wrote to `path` + ".npz".  `like` gives the tree (a fresh stream's
    .state); each leaf goes to the device of like's leaf in its place and
    keeps the dtype it was saved in."""
    npz = pathlib.Path(str(pathlib.Path(path)) + ".npz")
    if not npz.exists():
        raise FileNotFoundError(
            f"no checkpoint {str(npz)!r}: this package reads the npz form "
            "only (the JAX package writes an orbax directory instead "
            "wherever orbax is installed)")
    with np.load(str(npz)) as data:
        _check_version(data["format_version"]
                       if "format_version" in data else None, path)
        places = tree_flatten(like)
        leaves = [torch.as_tensor(data[f"leaf_{i}"], device=place.device)
                  for i, place in enumerate(places)]
    return tree_unflatten(like, leaves)
