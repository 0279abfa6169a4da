"""Carry parameters between the flax tree and the port's ``state_dict``.

The port's modules are named after the flax tree and keep its tensor
layouts, so the mapping is a rename: the flax path
``input_track_transformer/layer_0/self_att/dense_query/kernel`` is the
``state_dict`` key ``input_track_transformer.layer_0.self_att.dense_query.kernel``.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_flax(tree: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """Nested flax params (numpy or array-likes) -> flat f32 ``state_dict``."""
    out: dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, dict):
            out.update(params_from_flax(value, path))
        else:
            out[path] = torch.from_numpy(np.array(value, dtype=np.float32))
    return out


def params_to_flax(state_dict) -> dict:
    """Flat ``state_dict`` -> nested dict of numpy arrays (the flax tree)."""
    tree: dict = {}
    for key, value in state_dict.items():
        *parents, leaf = key.split(".")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value.detach().cpu().numpy()
    return tree
