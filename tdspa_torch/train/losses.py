"""Training losses (port of ``tdspa/train/losses.py``): visibility-masked L1
position + BCE occlusion.

Both terms are divided by the clamped visible mass ``max(sum(vis), 1)`` (of
the whole batch: a sharded step passes the mass summed over its ranks); the
L1 term is summed over coordinates and frames of visible points, the BCE
over every entry (occluded ones too). Weights: L1 * 5000 + BCE * 1e-8. The
2D and 3D losses are the same formula over 2 or 3 coordinates.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's ``sigmoid_binary_cross_entropy``, elementwise."""
    labels = labels.to(logits.dtype)
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def _compute_loss(predictions, targets, l1_weight: float, bce_weight: float,
                  visible_mass=None) -> dict:
    visible_mask = targets["query_tracks_visible"].float()  # [B Q T 1]
    mass = visible_mask.sum() if visible_mass is None else visible_mass
    denom = torch.clamp(mass, min=1.0)
    position_error = (predictions.tracks - targets["query_tracks"]).abs()
    position_loss = (position_error * visible_mask).sum() / denom
    visible_loss = sigmoid_binary_cross_entropy(
        predictions.visible_logits, targets["query_tracks_visible"]
    ).sum() / denom
    return {
        "total_loss": l1_weight * position_loss + bce_weight * visible_loss,
        "position_loss": position_loss,
        "visible_loss": visible_loss,
    }


def compute_loss_2d(predictions, targets, l1_weight=5000.0, bce_weight=1e-8,
                    visible_mass=None) -> dict:
    """TRAJAN 2D loss. ``visible_mass``: the denominator's mass where
    ``targets`` is one rank's shard (the whole batch's), else the targets'."""
    return _compute_loss(predictions, targets, l1_weight, bce_weight, visible_mass)


def compute_loss_3d(predictions, targets, l1_weight=5000.0, bce_weight=1e-8,
                    visible_mass=None) -> dict:
    """3DSPA 3D loss; ``visible_mass`` as in ``compute_loss_2d``."""
    return _compute_loss(predictions, targets, l1_weight, bce_weight, visible_mass)
