"""Solver-state checkpoint / resume (counterpart of
:mod:`ipmzoo_tpu.utils.checkpoint`).

A solver state (``IPMState``, ``SchurState``, ``ArrowState``, a fused
warm-start dict, or any nesting of tensors in tuples, dicts and
dataclasses) is saved as a plain ``.npz`` of its leaves, without pickle.
Loading needs a structurally identical ``like`` tree, whose leaves also
give the device of the loaded tensors.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np
import torch


def _leaves(tree, out: List[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors of ``tree`` in the order ``state.tree_map`` visits
    them."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, tuple):
        for a in tree:
            _leaves(a, out)
    elif isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            _leaves(getattr(tree, f.name), out)
    else:
        raise TypeError(f"checkpoint: unsupported node {type(tree).__name__}")
    return out


def save_state(path: str, state, metadata: Optional[dict] = None) -> None:
    """Save a state (any tree of tensors) to ``path`` as .npz.

    Only the leaves are stored; :func:`load_state` rebuilds the tree
    around a ``like`` of the same structure."""
    leaves = _leaves(state, [])
    arrays = {f"leaf_{i}": leaf.detach().cpu().numpy()
              for i, leaf in enumerate(leaves)}
    arrays["__num_leaves__"] = np.asarray(len(leaves))
    if metadata:
        arrays["__metadata__"] = np.frombuffer(
            json.dumps(metadata).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_state(path: str, like):
    """Load a state saved by :func:`save_state`; ``like`` provides the
    structure (for example a freshly built state) and the device of each
    leaf.  The stored dtypes are kept."""
    from ..models.state import tree_map
    leaves_like = _leaves(like, [])
    with np.load(path, allow_pickle=False) as data:
        if "__num_leaves__" in data and \
                int(data["__num_leaves__"]) != len(leaves_like):
            raise ValueError(
                f"checkpoint has {int(data['__num_leaves__'])} leaves but "
                f"'like' tree has {len(leaves_like)}: structure mismatch")
        loaded = iter([torch.tensor(data[f"leaf_{i}"]).to(leaf.device)
                       for i, leaf in enumerate(leaves_like)])
    return tree_map(lambda _: next(loaded), like)


def load_metadata(path: str) -> Optional[dict]:
    with np.load(path, allow_pickle=False) as data:
        if "__metadata__" not in data:
            return None
        return json.loads(bytes(data["__metadata__"]).decode())
