"""DINOv2 feature extraction (port of ``tdspa/features/dino.py``).

The video is resized to patch multiples and ImageNet-normalised on the
device, then runs through the ``Dinov2`` encoder in groups of
``frame_chunk`` frames (the last group padded with zeros), one forward per
group; the ViT attention runs in the Hopper kernel on a GPU.

Weights resolve in order: explicit ``params`` (a flax tree) -> HF checkpoint
through ``transformers`` from the local cache only -> random weights from
``seed`` with a loud warning (the pipeline stays runnable end to end; the
features are then shape-correct but meaningless).
"""

from __future__ import annotations

import functools
import logging
import os

import numpy as np
import torch

from tdspa_torch.core.layers import init_parameters
from tdspa_torch.features.vit import Dinov2, ViTConfig, convert_hf_dinov2_params
from tdspa_torch.infer.convert import params_from_flax
from tdspa_torch.ops.resize import resize
from tdspa_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_NAME_TO_PRESET = {
    "facebook/dinov2-small": "vits",
    "facebook/dinov2-base": "vitb",
    "facebook/dinov2-large": "vitl",
    "facebook/dinov2-giant": "vitg",
}


def load_dinov2_params(model_name: str, config: ViTConfig):
    """HF-cached weights -> flax tree; None when unavailable. Reads the local
    cache only: there is no download. The snapshot is looked up in the cache
    first and loaded from its directory, because ``from_pretrained`` with a
    hub name can still send requests (for an adapter config) even with
    ``local_files_only``."""
    try:
        from huggingface_hub import try_to_load_from_cache
        import transformers

        config_path = try_to_load_from_cache(model_name, "config.json")
        if not isinstance(config_path, str):
            raise FileNotFoundError(f"{model_name} is not in the local Hugging Face cache")
        hf_model = transformers.AutoModel.from_pretrained(os.path.dirname(config_path),
                                                          local_files_only=True)
        return convert_hf_dinov2_params(hf_model.state_dict(), config)
    except Exception as e:  # noqa: BLE001 - not installed / not cached
        logger.warning("Could not load %s (%s); DINO features will use RANDOM weights",
                       model_name, e)
        return None


@functools.cache
def _imagenet_stats(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean and std kept on ``device`` (no host copy per call)."""
    return (torch.tensor(IMAGENET_MEAN, device=device), torch.tensor(IMAGENET_STD, device=device))


def normalize_frames(video, device, out_hw=None) -> torch.Tensor:
    """[T H W 3] in [0, 255] -> f32 on ``device``, resized (bilinear, JAX's
    antialiasing) to ``out_hw`` and ImageNet-normalised."""
    x = torch.as_tensor(video, device=device).float() / 255.0
    if out_hw is not None and tuple(out_hw) != tuple(x.shape[1:3]):
        x = resize(x, out_hw, method="bilinear")
    mean, std = _imagenet_stats(x.device)
    return (x - mean) / std


class DinoFeatureExtractor:
    """video [T H W 3] (uint8 or float in [0, 255]) -> [T Hp Wp D] f32 features.

    ``frame_chunk`` = 8 divides the pipeline's upload chunks (40 and 30
    frames), so streamed per-chunk calls pad nothing. ``residual_dtype`` and
    ``gelu_approximate`` are the ViT's knobs; ``fused_attention=False`` keeps
    the plain attention on a GPU too; ``vit_config`` replaces the preset
    that ``model_name`` names (a small encoder for tests).
    """

    def __init__(
        self,
        model_name: str = "facebook/dinov2-base",
        params=None,
        dtype=torch.bfloat16,
        frame_chunk: int = 8,
        residual_dtype=torch.float32,
        gelu_approximate: bool = False,
        fused_attention: bool = True,
        vit_config: ViTConfig | None = None,
        device="cuda",
        seed: int = 0,
    ):
        self.device = resolve_device(device)
        self.config = vit_config or ViTConfig.preset(_NAME_TO_PRESET.get(model_name, "vitb"))
        self.model = Dinov2(self.config, dtype, residual_dtype, gelu_approximate,
                            fused_attention, self.device)
        self.frame_chunk = frame_chunk
        if params is None:
            params = load_dinov2_params(model_name, self.config)
        if params is None:
            init_parameters(self.model, seed, self.device)
        else:
            self.model.load_state_dict(params_from_flax(params))

    def preprocess(self, video) -> torch.Tensor:
        """Resize to patch multiples + ImageNet-normalise (on the device)."""
        p = self.config.patch_size
        h, w = video.shape[1:3]
        return normalize_frames(video, self.device, ((h // p) * p, (w // p) * p))

    @torch.inference_mode()
    def __call__(self, video) -> torch.Tensor:
        """video [T H W 3] -> [T Hp Wp D] features on the device."""
        frames = self.preprocess(video)
        t, chunk = frames.shape[0], self.frame_chunk
        pad = (-t) % chunk
        if pad:
            frames = torch.cat([frames, frames.new_zeros((pad,) + frames.shape[1:])])
        out = [self.model.patch_grid(frames[i : i + chunk]) for i in range(0, t + pad, chunk)]
        return torch.cat(out)[:t]


def extract_dino_features(video: np.ndarray, model_name: str = "facebook/dinov2-base",
                          extractor: DinoFeatureExtractor | None = None) -> np.ndarray:
    """Reference-compatible entry point -> host array; the pipeline calls the
    extractor itself to keep the features on the device."""
    extractor = extractor or DinoFeatureExtractor(model_name=model_name)
    return extractor(video).cpu().numpy().astype(np.float32)
