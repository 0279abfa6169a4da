from tdspa_torch.models.spa3d import TrackAutoEncoder3D

__all__ = ["TrackAutoEncoder3D"]
