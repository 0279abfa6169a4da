"""Checkpoint I/O for the port (port of ``tdspa/infer/checkpoint.py``).

* ``load_checkpoint`` reads the three ``.npz`` layouts of the reference
  loader, (a) a pickled ``params`` object, (b) a pickled ``optimizer`` dict
  exposing ``target``, (c) flat ``a/b/c`` keys (what ``save_checkpoint_npz``
  writes, here and in JAX), and (d) a step directory of
  ``TrainCheckpointer``; it adapts reference-layout feature projections and
  returns a ``state_dict`` for the models' ``load_state_dict`` on the
  requested device. Layouts (a) and (b) unpickle, so load only files from a
  trusted source.
* ``save_checkpoint_npz`` writes layout (c), which JAX's ``load_checkpoint``
  reads too.
* ``TrainCheckpointer`` saves and restores ``{params, opt_state, step}`` for
  resuming training, with ``torch.save``. It stands where JAX's
  ``OrbaxCheckpointer`` does, but neither reads the other's directories:
  there is no Orbax on the card's machine.
"""

from __future__ import annotations

import logging
import os
import re
import shutil

import numpy as np
import torch

from tdspa_torch.infer.convert import params_from_flax, params_to_flax
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
    """The nested flax parameter tree (numpy) of an ``.npz`` checkpoint or a
    ``TrainCheckpointer`` step directory.

    ``projection_policy`` handles reference-layout feature projections (see
    ``adapt_reference_projections``): ``'error'`` raises, ``'slice'``
    adapts, ``'ignore'`` loads as-is.
    """
    logger.info("Loading checkpoint from %s", checkpoint_path)
    if not os.path.exists(checkpoint_path):
        raise FileNotFoundError(f"Checkpoint not found: {checkpoint_path}")
    if os.path.isdir(checkpoint_path):
        state_file = os.path.join(checkpoint_path, TrainCheckpointer.FILE)
        if not os.path.isfile(state_file):
            raise NotImplementedError(
                f"{checkpoint_path}: a directory loads only as a TrainCheckpointer "
                f"step directory (holding {TrainCheckpointer.FILE}); the port "
                "cannot read Orbax or flax msgpack directories"
            )
        return params_to_flax(torch.load(state_file, weights_only=True)["params"])
    if not checkpoint_path.endswith(".npz"):
        raise NotImplementedError(
            f"{checkpoint_path}: the port loads .npz files and TrainCheckpointer "
            "step directories"
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
    ``.npz`` checkpoint or a ``TrainCheckpointer`` step directory; see
    ``load_params_tree`` for the policy."""
    device = resolve_device(device)
    tree = load_params_tree(checkpoint_path, projection_policy, track_token_dim)
    return {k: v.to(device) for k, v in params_from_flax(tree).items()}


def flatten_params(tree: dict, prefix: str = "") -> dict:
    """Nested dicts -> 'a/b/c' flat keys (inverse of ``unflatten_params``)."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            flat.update(flatten_params(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def save_checkpoint_npz(checkpoint_path: str, params) -> None:
    """Write ``params`` (a model's ``state_dict`` or a nested flax-layout
    tree) as the flat-key ``.npz`` the reference loader reads back."""
    if all(isinstance(v, torch.Tensor) for v in params.values()):
        params = params_to_flax(params)
    flat = flatten_params(params)
    os.makedirs(os.path.dirname(os.path.abspath(checkpoint_path)), exist_ok=True)
    np.savez(checkpoint_path, **flat)
    logger.info("Saved %d arrays to %s", len(flat), checkpoint_path)


class TrainCheckpointer:
    """Train-state save/restore with retention, for resume after a failure.

    ``save(step, tree)`` writes ``tree`` (``{"params", "opt_state", "step"}``:
    tensors, dicts of them and numbers) to ``directory/<step>/state.pt``,
    written to a temporary name and renamed, so a step directory holds a
    whole checkpoint or none, and keeps the newest ``max_to_keep`` steps.
    Files load with ``weights_only=True``: no pickled code runs.
    """

    FILE = "state.pt"

    def __init__(self, directory: str, max_to_keep: int = 3):
        self._directory = os.path.abspath(directory)
        self._max_to_keep = max_to_keep
        os.makedirs(self._directory, exist_ok=True)

    def _steps(self) -> list[int]:
        return sorted(
            int(name) for name in os.listdir(self._directory)
            if re.fullmatch(r"\d+", name)
            and os.path.isfile(os.path.join(self._directory, name, self.FILE))
        )

    def save(self, step: int, state_tree) -> None:
        step_dir = os.path.join(self._directory, str(step))
        os.makedirs(step_dir, exist_ok=True)
        path = os.path.join(step_dir, self.FILE)
        torch.save(state_tree, path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in self._steps()[: -self._max_to_keep]:
            shutil.rmtree(os.path.join(self._directory, str(old)))

    def restore(self, step: int | None = None, device="cpu"):
        """The tree saved at ``step`` (the latest when None) with its tensors
        on ``device``, or None when there is no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        path = os.path.join(self._directory, str(step), self.FILE)
        return torch.load(path, map_location=device, weights_only=True)

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None


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
