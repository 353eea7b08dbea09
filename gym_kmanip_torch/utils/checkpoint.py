"""Checkpoint and resume of solver state and warm-start trajectories.

Port of `gym_kmanip_tpu/utils/checkpoint.py`, in its file format: a tree's
leaves as `leaf_{i}` arrays in one `.npz`, published by an atomic rename.
Trees are flattened in `jax.tree_util`'s leaf order (NamedTuples by field,
tuples and lists in order, dicts by sorted key, None a node with no leaf),
so a file of array leaves written by either package restores in the other.
A `torch.Generator` leaf is saved as its state and restored into the
template's generator, so an `MPPIState` resumes its noise stream.
"""

import os
from typing import Any, Iterator, List

import numpy as np
import torch


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of `tree` in `jax.tree_util`'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in tree_leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [x for child in tree for x in tree_leaves(child)]
    return [tree]


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _rebuild(template: Any, arrays: Iterator[np.ndarray]) -> Any:
    if template is None:
        return None
    if isinstance(template, dict):
        rebuilt = {key: _rebuild(template[key], arrays) for key in sorted(template)}
        return type(template)((key, rebuilt[key]) for key in template)
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(child, arrays) for child in template))
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(child, arrays) for child in template)
    a = next(arrays)
    if isinstance(template, torch.Generator):
        template.set_state(torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint8)))
        return template
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.array(a)).to(dtype=template.dtype, device=template.device)
    if isinstance(template, np.ndarray) or hasattr(template, "dtype"):
        return np.asarray(a, dtype=template.dtype)
    return a


def save(path: str, tree: Any) -> None:
    """Save a tree of tensors, arrays and generators to `path` (.npz)."""
    arrays = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(tree_leaves(tree))}
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)  # atomic publish


def restore(path: str, template: Any) -> Any:
    """Restore a tree saved by `save` into `template`'s structure, each
    tensor on the template's dtype and device."""
    n = len(tree_leaves(template))
    with np.load(path) as data:
        arrays = [data[f"leaf_{i}"] for i in range(n)]
    return _rebuild(template, iter(arrays))
