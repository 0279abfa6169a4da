"""End-to-end single-video inference: video -> 3D track predictions (port of
``tdspa/infer/pipeline.py``: ``fused_tail``, ``InferencePipeline`` and
``save_results``).

``run(video_path)`` decodes a video file with OpenCV and calls
``run_on_frames``; ``run_inference`` builds the pipeline and does both.
The default front ends are the port's own: ``PyramidalLKTracker`` (LK
kernel ``tdspa_torch/csrc/lk.cu``, matcher kernel ``csrc/matcher.cu``),
``DinoFeatureExtractor`` and ``VideoDepthEstimator`` (their ViT attention in
``csrc/vit_attention.cu``), built lazily on the pipeline's device. A video
longer than ``upload_chunk_frames`` streams to the device in chunks, as YUV
4:2:0; each chunk is tracked (``track_chunks``), and the port's own DINO
and depth stages run on it as it arrives (depth only when the chunk is a
multiple of its 8-frame temporal groups). Providers passed in take the
whole device video. Everything after the front ends is ``fused_tail``:
2D->3D lifting, bilinear feature sampling, the support/query split and the
``TrackAutoEncoder3D`` forward, all on the pipeline's device. With
``dtype=bfloat16`` (the default) the model's attention runs in the fused
CUDA kernel (``tdspa_torch/csrc/attention.cu``) and the tail's three
bilinear samplings in ``csrc/bilinear.cu``. Two serving configurations of
the model, as in JAX: ``quantize=True`` (int8 projections,
``csrc/quant_matmul.cu``) and ``fused_block=True`` (``csrc/block.cu``).

Output schema (``predictions.npz`` + ``video_info.txt``) is the JAX
package's.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from tdspa_torch.data.batch_prep import split_and_sample_queries
from tdspa_torch.features.depth import VideoDepthEstimator
from tdspa_torch.features.dino import DinoFeatureExtractor
from tdspa_torch.features.tracks import PyramidalLKTracker
from tdspa_torch.infer.checkpoint import check_params_structure, load_checkpoint
from tdspa_torch.infer.convert import params_from_flax
from tdspa_torch.infer.video import load_video
from tdspa_torch.models import TrackAutoEncoder3D
from tdspa_torch.ops.geometry import (
    lift_2d_to_3d,
    sample_depth_features_for_tracks,
    sample_dino_features_for_tracks,
)
from tdspa_torch.utils.device import resolve_device, synchronize

logger = logging.getLogger(__name__)


def fused_tail(
    model,
    tracks_2d,  # [N T 2]
    visible,  # [N T 1]
    dino_grid,  # [T Hp Wp D] | None
    depth_maps,  # [T H W 1] | None
    perm,  # int[N]
    ts,  # int[num_queries]
    num_support: int,
    num_queries: int,
    video_hw: tuple,
    use_dino: bool = True,
    use_depth: bool = True,
):
    """Lift + sample + split + autoencode; returns (predictions, batch, tracks_3d)."""
    num_frames = tracks_2d.shape[1]
    if use_depth and depth_maps is not None:
        tracks_3d = lift_2d_to_3d(tracks_2d, depth_maps)
    else:
        tracks_3d = torch.cat([tracks_2d, torch.ones_like(tracks_2d[..., :1])], dim=-1)
    dino_feats = (
        sample_dino_features_for_tracks(
            dino_grid, tracks_2d, (num_frames,) + tuple(video_hw) + (3,)
        )
        if use_dino and dino_grid is not None
        else None
    )
    depth_feats = (
        sample_depth_features_for_tracks(depth_maps, tracks_2d)
        if use_depth and depth_maps is not None
        else None
    )
    batch = split_and_sample_queries(
        perm, ts, tracks_3d, visible, num_support=num_support,
        num_queries=num_queries, num_frames=num_frames,
        dino_features=dino_feats, depth_features=depth_feats,
    )
    return model(batch), batch, tracks_3d


class InferencePipeline:
    """Configured end-to-end pipeline with pluggable front ends.

    ``params`` is a flax-layout parameter tree (e.g. from the JAX package or
    ``load_params_tree``); ``checkpoint_path`` an ``.npz`` checkpoint. With
    neither, the model keeps its seeded random initialisation.
    """

    def __init__(
        self,
        checkpoint_path: str | None = None,
        params=None,
        num_output_frames: int = 150,
        use_dino: bool = True,
        use_depth: bool = True,
        num_query_points: int = 512,
        num_support_tracks: int = 2048,
        tracking_grid_size: int = 64,
        dino_model: str = "facebook/dinov2-base",
        vda_encoder: str = "vitb",
        track_provider=None,
        dino_extractor=None,
        depth_provider=None,
        model: TrackAutoEncoder3D | None = None,
        seed: int = 0,
        dtype=torch.bfloat16,
        mesh=None,
        upload_chunk_frames: int = 40,
        upload_yuv420: bool = True,
        projection_policy: str = "error",
        quantize: bool = False,
        residual_dtype=None,
        depth_output_scale: float = 1.0,
        depth_input_size: int = 518,
        gelu_approximate: bool = False,
        tracking_input_scale: float = 1.0,
        fused_block: bool = False,
        tail_artifact: str | None = None,
        device="cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(
                "mesh: the sharded tail comes with the multi-GPU slice (ROADMAP.md)"
            )
        if tail_artifact is not None:
            raise NotImplementedError(
                "tail_artifact: exported tails come with the export slice (ROADMAP.md)"
            )
        self.device = resolve_device(device)
        self.num_output_frames = num_output_frames
        self.use_dino = use_dino
        self.use_depth = use_depth
        self.num_query_points = num_query_points
        self.num_support_tracks = num_support_tracks
        self.tracking_grid_size = tracking_grid_size
        self.dino_model_name = dino_model
        self.vda_encoder = vda_encoder
        # Chunk size of the streamed upload (multiples of 8 keep the depth
        # extractor's 8-frame temporal groups aligned, as in JAX).
        self.upload_chunk_frames = upload_chunk_frames
        self.upload_yuv420 = upload_yuv420
        # 0.5 tracks on half-resolution luma; coordinates stay full-res.
        self.tracking_input_scale = tracking_input_scale
        self.seed = seed
        # The model's stacks and the lazily built DINOv2/VDA backbones share
        # the residual dtype (providers passed in keep their own).
        self.residual_dtype = residual_dtype or torch.float32
        # < 1.0 runs the depth head's full-resolution tail smaller; < 518
        # feeds the depth backbone smaller frames; tanh GELU in the lazily
        # built backbones. All approximate serving knobs, off by default.
        self.depth_output_scale = depth_output_scale
        self.depth_input_size = depth_input_size
        self.gelu_approximate = gelu_approximate
        self.model = model or TrackAutoEncoder3D(
            num_output_frames=num_output_frames,
            use_dino=use_dino,
            use_depth=use_depth,
            dtype=dtype,
            # The fused kernel computes in bf16: engage it only when bf16
            # compute was asked for (and only on CUDA tensors).
            fused_attention=(dtype == torch.bfloat16),
            # Dynamic int8 projections and MLPs (the same parameters):
            # kernel csrc/quant_matmul.cu. Inference knob, off by default.
            quantize=quantize,
            residual_dtype=self.residual_dtype,
            # The decompress and readout stacks' blocks through the fused
            # block kernel (csrc/block.cu); not under quantize.
            fused_block=fused_block,
            device=self.device,
            seed=42,
        )
        self._track_provider = track_provider
        self._dino_extractor = dino_extractor
        self._depth_provider = depth_provider
        self.params = params
        self.checkpoint_path = checkpoint_path
        self.projection_policy = projection_policy
        self.timings: dict[str, float] = {}
        self.load_params()

    @property
    def track_provider(self):
        if self._track_provider is None:
            # The JAX pipeline's fast configuration: NCC occlusion checks
            # instead of the backward pass, 3 LK iterations, and the 'auto'
            # policy (matcher on degraded content, rescue on collapse).
            self._track_provider = PyramidalLKTracker(
                grid_size=self.tracking_grid_size, fb_threshold=-1.0, iterations=3,
                matcher="auto", input_scale=self.tracking_input_scale, device=self.device,
            )
        return self._track_provider

    @property
    def dino_extractor(self):
        if self._dino_extractor is None:
            self._dino_extractor = DinoFeatureExtractor(
                model_name=self.dino_model_name, residual_dtype=self.residual_dtype,
                gelu_approximate=self.gelu_approximate, device=self.device,
            )
        return self._dino_extractor

    @property
    def depth_provider(self):
        if self._depth_provider is None:
            self._depth_provider = VideoDepthEstimator(
                encoder=self.vda_encoder, residual_dtype=self.residual_dtype,
                output_scale=self.depth_output_scale, input_size=self.depth_input_size,
                gelu_approximate=self.gelu_approximate, device=self.device,
            )
        return self._depth_provider

    def load_params(self):
        """Load ``params`` or the checkpoint into the model, after a structure check."""
        if self.params is not None:
            state = params_from_flax(self.params)
        elif self.checkpoint_path:
            state = load_checkpoint(
                self.checkpoint_path, projection_policy=self.projection_policy,
                track_token_dim=self.model.track_token_dim, device=self.device,
            )
        else:
            logger.warning("No checkpoint given; using randomly initialized params")
            return
        problems = check_params_structure(self.model.state_dict(), state)
        if problems:
            logger.warning("Checkpoint structure mismatches (%d): %s",
                           len(problems), "; ".join(problems[:5]))
        self.model.load_state_dict(state)

    def split_indices(self, num_tracks: int, num_queries: int, num_frames: int):
        """(perm, ts) for the support/query split, from ``seed`` on the CPU."""
        gen = torch.Generator().manual_seed(self.seed)
        perm = torch.randperm(num_tracks, generator=gen)
        ts = torch.randint(0, num_frames, (num_queries,), generator=gen)
        return perm.to(self.device), ts.to(self.device)

    def _timed(self, name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        synchronize(self.device)
        self.timings[name] = time.perf_counter() - t0
        logger.info("%s: %.3fs", name, self.timings[name])
        return out

    def _tensor(self, x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor; on a GPU from pinned memory without
        waiting, so that the next chunk's host work overlaps the copy."""
        host = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type != "cuda":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def _streamed_upload_and_tracking(self, video: np.ndarray):
        """Upload in ``upload_chunk_frames`` chunks (YUV 4:2:0 on the wire
        for even frames, RGB rebuilt on the device), track chunk by chunk,
        and run the port's own DINO and depth stages on each chunk.

        Returns (track_data, the device video or None, DINO grid or None,
        depth maps or None): the whole video only where a provider that is
        not streamed needs it, a feature only where it was streamed.
        """
        from tdspa_torch.ops.yuv import rgb_to_yuv420, yuv420_to_rgb

        t, h, w = video.shape[:3]
        chunk = self.upload_chunk_frames
        stream_dino = self.use_dino and isinstance(self.dino_extractor, DinoFeatureExtractor)
        # Per-chunk depth equals the whole-video result only when chunk
        # boundaries align with the estimator's temporal-attention groups.
        stream_depth = (
            self.use_depth
            and isinstance(self.depth_provider, VideoDepthEstimator)
            and chunk % self.depth_provider.frame_chunk == 0
        )
        t0 = time.perf_counter()
        chunks = []
        for i in range(0, t, chunk):
            if self.upload_yuv420 and h % 2 == 0 and w % 2 == 0:
                planes = rgb_to_yuv420(video[i : i + chunk])
                chunks.append(yuv420_to_rgb(*(self._upload(p) for p in planes)))
            else:
                chunks.append(self._upload(video[i : i + chunk]))
        track_data = self.track_provider.track_chunks(chunks)
        dino_parts = [self.dino_extractor(c) for c in chunks] if stream_dino else None
        depth_parts = [self.depth_provider(c) for c in chunks] if stream_depth else None
        # The whole video only for feature providers that are not streamed.
        need_full = (self.use_dino and not stream_dino) or (self.use_depth and not stream_depth)
        video_dev = torch.cat(chunks, dim=0) if need_full else None
        dino_grid = torch.cat(dino_parts, dim=0) if dino_parts is not None else None
        depth_maps = torch.cat(depth_parts, dim=0) if depth_parts is not None else None
        # One queue on the device: the sync waits for the upload, the tracking
        # and every chunk's features, so none of them leaks into the tail.
        synchronize(self.device)
        self.timings["upload_tracking_features"] = time.perf_counter() - t0
        logger.info("upload+tracking%s%s (streamed): %.3fs", "+dino" if stream_dino else "",
                    "+depth" if stream_depth else "", self.timings["upload_tracking_features"])
        return track_data, video_dev, dino_grid, depth_maps

    @torch.inference_mode()
    def run_on_frames(self, video: np.ndarray, fps: float = 30.0) -> dict:
        """Full pipeline on an in-memory [T H W 3] uint8 video."""
        t, h, w = video.shape[:3]
        wants_dev = getattr(self.track_provider, "prefers_device_input", None)
        on_device_tracker = bool(wants_dev and wants_dev(video.shape))
        chunk = self.upload_chunk_frames
        dino_grid = depth_maps = None
        if on_device_tracker and hasattr(self.track_provider, "track_chunks") and chunk and t > chunk:
            track_data, video_dev, dino_grid, depth_maps = self._streamed_upload_and_tracking(video)
        else:
            # One upload of the video, shared by the device front ends; host
            # trackers work from the numpy copy.
            video_dev = self._timed("video_upload", self._tensor, video)
            track_data = self._timed(
                "tracking", self.track_provider, video_dev if on_device_tracker else video
            )
        tracks_2d = self._tensor(track_data["tracks"], torch.float32)
        visible = self._tensor(track_data["visible"], torch.float32)
        if self.use_dino and dino_grid is None:
            dino_grid = self._tensor(self._timed("dino_features", self.dino_extractor, video_dev))
        if self.use_depth and depth_maps is None:
            depth_maps = self._tensor(self._timed("depth", self.depth_provider, video_dev))

        num_tracks = int(tracks_2d.shape[0])
        num_support = min(self.num_support_tracks, max(num_tracks - 1, 1))
        num_queries = min(self.num_query_points, max(num_tracks - num_support, 1))
        perm, ts = self.split_indices(num_tracks, num_queries, t)

        predictions, batch, tracks_3d = self._timed(
            "fused_tail", fused_tail, self.model, tracks_2d, visible, dino_grid,
            depth_maps, perm, ts, num_support, num_queries, (h, w),
            self.use_dino, self.use_depth,
        )
        return {
            "predictions": predictions,
            "video": video,
            "tracks_3d": tracks_3d,
            "support_tracks": batch["support_tracks"][0],
            "query_tracks": batch["query_tracks"][0],
            "depth": depth_maps,
            "dino_grid": dino_grid,
            "fps": fps,
            "timings": dict(self.timings),
        }

    def run(self, video_path: str) -> dict:
        """Full pipeline on a video file: its first ``num_output_frames``
        frames, decoded on the host with OpenCV."""
        video, fps = load_video(video_path, max_frames=self.num_output_frames)
        logger.info("Loaded video: %d frames, %dx%d, %.2f fps",
                    video.shape[0], video.shape[1], video.shape[2], fps)
        return self.run_on_frames(video, fps)


def run_inference(video_path: str, checkpoint_path: str | None, **kwargs) -> dict:
    """Reference-compatible entry: ``InferencePipeline(checkpoint_path,
    **kwargs).run(video_path)``; ``device`` defaults to "cuda"."""
    return InferencePipeline(checkpoint_path=checkpoint_path, **kwargs).run(video_path)


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_results(results: dict, output_dir: str) -> None:
    """predictions.npz + video_info.txt (the reference's schema)."""
    os.makedirs(output_dir, exist_ok=True)
    pred_tracks = _numpy(results["predictions"].tracks[0])
    pred_visible = _numpy(results["predictions"].visible_logits[0])
    np.savez(
        os.path.join(output_dir, "predictions.npz"),
        tracks_3d=pred_tracks,
        visible_logits=pred_visible,
        query_tracks=_numpy(results["query_tracks"]),
        support_tracks=_numpy(results["support_tracks"]),
    )
    with open(os.path.join(output_dir, "video_info.txt"), "w") as f:
        f.write(f"FPS: {results['fps']}\n")
        f.write(f"Frames: {pred_tracks.shape[1]}\n")
        f.write(f"Query points: {pred_tracks.shape[0]}\n")
    logger.info("Results saved to %s", output_dir)
