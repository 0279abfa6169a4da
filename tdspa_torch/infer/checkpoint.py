"""Checkpoint loading for the port (port of the ``.npz`` side of
``tdspa/infer/checkpoint.py``).

``load_checkpoint`` reads the three ``.npz`` layouts of the reference
loader, (a) a pickled ``params`` object, (b) a pickled ``optimizer`` dict
exposing ``target``, (c) flat ``a/b/c`` keys (what
``tdspa.infer.checkpoint.save_checkpoint_npz`` writes), adapts
reference-layout feature projections, and returns a ``state_dict`` for
``TrackAutoEncoder3D.load_state_dict`` on the requested device. Layouts (a)
and (b) unpickle, so load only files from a trusted source. The Orbax
directory layout comes with the training slice (ROADMAP.md).
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from tdspa_torch.infer.convert import params_from_flax
from tdspa_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def unflatten_params(flat_dict: dict) -> dict:
    """'a/b/c' flat keys -> nested dicts."""
    result: dict = {}
    for key, value in flat_dict.items():
        *parents, leaf = key.split("/")
        node = result
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return result


def _load_npz(checkpoint_path: str):
    with np.load(checkpoint_path, allow_pickle=True) as data:
        if "params" in data:
            p = data["params"]
            return p.item() if p.ndim == 0 else dict(p)
        if "optimizer" in data:
            opt = data["optimizer"]
            opt = opt.item() if opt.ndim == 0 else dict(opt)
            return opt.get("target", opt) if isinstance(opt, dict) else opt
        return unflatten_params({k: np.array(data[k]) for k in data.files})


def load_params_tree(checkpoint_path: str, projection_policy: str = "error",
                     track_token_dim: int = 384) -> dict:
    """The nested flax parameter tree (numpy) of an ``.npz`` checkpoint.

    ``projection_policy`` handles reference-layout feature projections (see
    ``adapt_reference_projections``): ``'error'`` raises, ``'slice'``
    adapts, ``'ignore'`` loads as-is.
    """
    logger.info("Loading checkpoint from %s", checkpoint_path)
    if not os.path.exists(checkpoint_path):
        raise FileNotFoundError(f"Checkpoint not found: {checkpoint_path}")
    if not checkpoint_path.endswith(".npz"):
        raise NotImplementedError(
            f"{checkpoint_path}: only .npz checkpoints load in the port; the "
            "Orbax directory layout comes with the training slice (ROADMAP.md)"
        )
    params = _load_npz(checkpoint_path)
    if projection_policy != "ignore" and isinstance(params, dict):
        params = adapt_reference_projections(
            params, track_token_dim=track_token_dim, policy=projection_policy
        )
    return params


def load_checkpoint(checkpoint_path: str, projection_policy: str = "error",
                    track_token_dim: int = 384,
                    device="cuda") -> dict[str, torch.Tensor]:
    """``state_dict`` on ``device`` (GPU unless ``device="cpu"``) from an
    ``.npz`` checkpoint; see ``load_params_tree`` for the policy."""
    device = resolve_device(device)
    tree = load_params_tree(checkpoint_path, projection_policy, track_token_dim)
    return {k: v.to(device) for k, v in params_from_flax(tree).items()}


_PROJECTION_NAMES = ("dino_projection", "depth_projection")


def adapt_reference_projections(params: dict, track_token_dim: int = 384,
                                policy: str = "error") -> dict:
    """Handle reference-declared square feature-projection kernels.

    The reference declares ``dino_projection = Dense(768)`` and
    ``depth_projection = Dense(256)``, whose outputs cannot be added to
    ``track_token_dim``-wide tokens. For such square kernels,
    ``policy='slice'`` cuts (768 -> 384) or zero-pads (256 -> 384) the output
    channels, kernel and bias alike; ``policy='error'`` raises with the
    offending paths and the fix.
    """
    if policy not in ("slice", "error"):
        raise ValueError(f"Unknown projection_policy: {policy!r}")

    hits: list[tuple[str, dict]] = []

    def walk(node, path):
        if not isinstance(node, dict):
            return
        for key, value in node.items():
            sub = f"{path}/{key}" if path else str(key)
            if key in _PROJECTION_NAMES and isinstance(value, dict):
                kernel = value.get("kernel")
                if (
                    kernel is not None
                    and getattr(kernel, "ndim", 0) == 2
                    and kernel.shape[1] != track_token_dim
                    and kernel.shape[0] == kernel.shape[1]
                ):
                    hits.append((sub, value))
            else:
                walk(value, sub)

    walk(params, "")
    if not hits:
        return params
    if policy == "error":
        detail = ", ".join(
            f"{p} kernel{tuple(np.asarray(v['kernel']).shape)}" for p, v in hits
        )
        raise ValueError(
            "Checkpoint carries reference-layout square feature-projection "
            f"kernels that cannot be residual-added to {track_token_dim}-wide "
            f"track tokens: {detail}. Re-load with projection_policy='slice' to "
            f"keep the first {track_token_dim} output channels, or 'ignore' to "
            "load as-is."
        )
    for path, value in hits:
        kernel = np.asarray(value["kernel"])
        width = kernel.shape[1]
        logger.warning(
            "%s reference projection %s: kernel %s -> (%d, %d)",
            "Slicing" if width > track_token_dim else "Zero-padding",
            path, kernel.shape, kernel.shape[0], track_token_dim,
        )
        if width > track_token_dim:
            value["kernel"] = kernel[:, :track_token_dim]
        else:
            value["kernel"] = np.pad(kernel, ((0, 0), (0, track_token_dim - width)))
        if "bias" in value:
            bias = np.asarray(value["bias"])
            value["bias"] = (
                bias[:track_token_dim] if bias.shape[0] > track_token_dim
                else np.pad(bias, (0, track_token_dim - bias.shape[0]))
            )
    return params


def check_params_structure(expected, actual, path: str = "") -> list[str]:
    """Recursive key/shape diff; returns human-readable mismatch strings."""
    problems: list[str] = []
    if isinstance(expected, dict) and isinstance(actual, dict):
        for key in expected:
            sub = f"{path}.{key}" if path else str(key)
            if key not in actual:
                problems.append(f"Key {sub} missing in checkpoint")
            else:
                problems += check_params_structure(expected[key], actual[key], sub)
        for key in actual:
            if key not in expected:
                problems.append(f"Unexpected key {path}.{key} in checkpoint")
    elif hasattr(expected, "shape") and hasattr(actual, "shape"):
        if tuple(expected.shape) != tuple(actual.shape):
            problems.append(
                f"Shape mismatch at {path}: {tuple(expected.shape)} vs {tuple(actual.shape)}"
            )
    return problems
