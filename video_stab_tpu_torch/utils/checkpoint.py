"""Stream-state checkpointing — port of
``video_stab_tpu/utils/checkpoint.py``.

Serializes a state tree (``StabilizerState``, ``ChainState``, a batched
state, or a tree of numpy arrays such as ``Stabilizer.state_dict()``) to a
single .npz, so a live stream can be snapshotted, moved and resumed.

The file is the JAX package's format: the leaves as ``leaf_0`` ... in
``jax.tree_util``'s flatten order (named tuples and tuples in order, dicts
by sorted key, None and empty tuples without leaves) and the structure's
description under ``__treedef__``. A file either package writes loads into
the other with a template of the same structure. A torch.Generator is
written as its JAX-shaped key (the seed's two uint32 words) and its
position in its stream as ``key_state_<i>`` / ``key_device_<i>`` beside
the leaves, which the JAX package ignores; a stream saved and loaded here
on the same kind of device continues its own draws. A deep-stabilization
network in the state is not written: ``load_state`` keeps the template's.
"""

from __future__ import annotations

import json
from typing import Any, Iterator

import numpy as np
import torch

from video_stab_tpu_torch.core.state import _generator, _key_seed


def _key_words(gen: torch.Generator) -> np.ndarray:
    seed = gen.initial_seed()
    return np.asarray([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                      np.uint32)


def _flatten(tree: Any, out: list, gens: dict) -> None:
    """Append ``tree``'s leaves to ``out`` in JAX's order; record each
    generator's leaf index in ``gens``."""
    if tree is None or isinstance(tree, torch.nn.Module):
        return
    if isinstance(tree, torch.Generator):
        gens[len(out)] = tree
        out.append(_key_words(tree))
    elif isinstance(tree, (tuple, list)):
        for child in tree:
            _flatten(child, out, gens)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], out, gens)
    elif isinstance(tree, torch.Tensor):
        out.append(tree.detach().cpu().numpy())
    else:
        out.append(np.asarray(tree))


def _unflatten(template: Any, leaves: Iterator, data, index: list) -> Any:
    """``template``'s structure with the next leaves of ``leaves``."""
    if template is None or isinstance(template, torch.nn.Module):
        return template
    if isinstance(template, (tuple, list)):
        kids = [_unflatten(c, leaves, data, index) for c in template]
        if hasattr(template, "_fields"):
            return type(template)(*kids)
        return type(template)(kids)
    if isinstance(template, dict):
        kids = {k: _unflatten(template[k], leaves, data, index)
                for k in sorted(template)}
        return {k: kids[k] for k in template}
    i = index[0]
    index[0] += 1
    leaf = next(leaves, None)
    if leaf is None:
        raise ValueError(f"snapshot has {i} leaves, the template more")
    if isinstance(template, torch.Generator):
        gen = _generator(_key_seed(leaf), template.device)
        saved = f"key_state_{i}"
        if saved in data.files and \
                str(data[f"key_device_{i}"]) == template.device.type:
            gen.set_state(torch.from_numpy(np.array(data[saved], np.uint8)))
        return gen
    want = tuple(getattr(template, "shape", ()))
    if tuple(leaf.shape) != want:
        raise ValueError(f"leaf {i}: snapshot shape {leaf.shape} != "
                         f"template {want}")
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.array(leaf)).to(template.device)
    return np.array(leaf)


def save_state(state, path: str) -> None:
    """Write a state tree to ``path`` (.npz + structure description)."""
    leaves: list = []
    gens: dict = {}
    _flatten(state, leaves, gens)
    arrays = {f"leaf_{i}": x for i, x in enumerate(leaves)}
    for i, gen in gens.items():
        arrays[f"key_state_{i}"] = gen.get_state().cpu().numpy()
        arrays[f"key_device_{i}"] = np.asarray(gen.device.type)
    # The JAX package writes str(treedef) here; neither package reads it.
    arrays["__treedef__"] = np.frombuffer(json.dumps(
        f"{type(state).__name__}, {len(leaves)} leaves").encode(),
        dtype=np.uint8)
    np.savez(path, **arrays)


def load_state(path: str, template):
    """Load a tree saved by ``save_state`` (this package's or the JAX
    package's) into ``template``'s structure.

    The template (e.g. a freshly initialized state) supplies the structure
    and the device of each tensor; leaf count and shapes must match the
    saved snapshot."""
    with np.load(path) as data:
        n_leaves = sum(1 for k in data.files if k.startswith("leaf_"))
        leaves = (data[f"leaf_{i}"] for i in range(n_leaves))
        index = [0]
        out = _unflatten(template, leaves, data, index)
    if index[0] != n_leaves:
        raise ValueError(f"snapshot has {n_leaves} leaves, template "
                         f"{index[0]}")
    return out


__all__ = ["load_state", "save_state"]
