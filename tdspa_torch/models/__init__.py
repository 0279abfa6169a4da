from tdspa_torch.models.spa3d import TrackAutoEncoder3D
from tdspa_torch.models.trajan2d import TrackAutoEncoder

__all__ = ["TrackAutoEncoder", "TrackAutoEncoder3D"]
