"""Input/output containers of the track autoencoders (port of
``tdspa/models/containers.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NotRequired, TypedDict

import torch


class TrackAutoEncoder3DInputs(TypedDict):
    """3DSPA inputs.

    Attributes:
      support_tracks: [*B N T 3] (x, y, z) tracks.
      support_tracks_visible: [*B N T 1] visibility.
      query_points: optional [*B Q 4] (t, x, y, z) decoder queries.
      boundary_frame: int[*B] first padding frame.
      dino_features: optional [*B N T 768] DINOv2 features per track-frame.
      depth_features: optional [*B N T 256] depth features per track-frame.
    """

    support_tracks: Any
    support_tracks_visible: Any
    query_points: NotRequired[Any]
    boundary_frame: Any
    dino_features: NotRequired[Any]
    depth_features: NotRequired[Any]


@dataclass
class TrackAutoEncoderResults:
    """Decoder outputs.

    Attributes:
      tracks: [*B Q T 2|3] predicted positions.
      visible_logits: [*B Q T 1] pre-sigmoid visibility.
      certain_logits: [*B Q T 1] pre-sigmoid certainty (zeros for 3DSPA).
    """

    tracks: torch.Tensor
    visible_logits: torch.Tensor
    certain_logits: torch.Tensor

    @property
    def visible(self) -> torch.Tensor:
        return (self.visible_logits > 0).float()

    @property
    def certain(self) -> torch.Tensor:
        return (self.certain_logits > 0).float()

    @property
    def visible_and_certain(self) -> torch.Tensor:
        visible = torch.sigmoid(self.visible_logits)
        certain = torch.sigmoid(self.certain_logits)
        return ((visible * certain) > 0.5).float()


@dataclass
class TrackAutoEncoderDecoderContext:
    """Decoder-side context: embedded query identities + query frames."""

    decoder_query: torch.Tensor  # float['*B Q FF']
    query_frame: torch.Tensor  # int['*B Q']
    boundary_frame: torch.Tensor  # int['*B']
