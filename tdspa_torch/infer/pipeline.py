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
``tail_artifact`` runs an exported tail (``infer/export.py``) in its place;
``mesh`` runs it sharded over the ranks of a ``torch.distributed`` group
(``make_mesh_tail``).

Output schema (``predictions.npz`` + ``video_info.txt``) is the JAX
package's.
"""

from __future__ import annotations

import functools
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from tdspa_torch.data.batch_prep import split_and_sample_queries
from tdspa_torch.features.depth import VideoDepthEstimator
from tdspa_torch.features.dino import DinoFeatureExtractor, dino_config
from tdspa_torch.features.tracks import PyramidalLKTracker
from tdspa_torch.features.vit import ViTConfig
from tdspa_torch.infer.checkpoint import check_params_structure, load_checkpoint
from tdspa_torch.infer.convert import params_from_flax
from tdspa_torch.infer.video import load_video
from tdspa_torch.models import TrackAutoEncoder3D
from tdspa_torch.models.containers import TrackAutoEncoderResults
from tdspa_torch.ops.geometry import (
    lift_2d_to_3d,
    sample_depth_features_for_tracks,
    sample_dino_features_for_tracks,
)
from tdspa_torch.parallel.mesh import gather, world_group
from tdspa_torch.utils.device import resolve_device
from tdspa_torch.utils.profiling import span, stage_timer

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
    """Lift + sample + split + autoencode; returns (predictions, batch, tracks_3d).
    Spans: ``tdspa.tail`` holds ``tdspa.tail.{lift,sample,split,model}``."""
    with span("tdspa.tail"):
        num_frames = tracks_2d.shape[1]
        with span("tdspa.tail.lift"):
            if use_depth and depth_maps is not None:
                tracks_3d = lift_2d_to_3d(tracks_2d, depth_maps)
            else:
                tracks_3d = torch.cat([tracks_2d, torch.ones_like(tracks_2d[..., :1])], dim=-1)
        with span("tdspa.tail.sample"):
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
        with span("tdspa.tail.split"):
            batch = split_and_sample_queries(
                perm, ts, tracks_3d, visible, num_support=num_support,
                num_queries=num_queries, num_frames=num_frames,
                dino_features=dino_feats, depth_features=depth_feats,
            )
        with span("tdspa.tail.model"):
            return model(batch), batch, tracks_3d


SUPPORT_KEYS = ("support_tracks", "support_tracks_visible")
QUERY_KEYS = ("query_points", "query_tracks", "query_tracks_visible")


def mesh_fused_tail(
    model,
    group,
    shard,  # this rank's position in ``group``: an int, or an int64 0-d tensor
    tracks_2d,  # [N T 2]
    visible,  # [N T 1]
    dino_grid,  # [T Hp Wp D] | None
    depth_maps,  # [T H W 1] | None
    perm,  # int[N], the same on every rank
    ts,  # int[num_queries], the same on every rank
    num_support: int,
    num_queries: int,
    video_hw: tuple,
    use_dino: bool = True,
    use_depth: bool = True,
):
    """``fused_tail`` with the track set sharded over the ranks of ``group``;
    every rank returns what ``fused_tail`` returns.

    Each rank lifts its contiguous slice of the N tracks (gathered into the
    whole ``tracks_3d``, from which every rank splits the same batch), samples
    the DINO and depth features of its slice of the support tracks only (a
    bilinear sample depends on its point alone), encodes those tracks, and
    decodes its slice of the queries against latents computed from every
    rank's readout tokens. Predictions and features are gathered back in
    rank order. The call is the span ``tdspa.tail``.
    """
    with span("tdspa.tail"):
        count = dist.get_world_size(group)
        num_frames = tracks_2d.shape[1]
        device = tracks_2d.device

        def rows(total: int) -> torch.Tensor:  # this rank's contiguous positions
            part = total // count
            return torch.arange(part, device=device) + shard * part

        mine = tracks_2d[rows(tracks_2d.shape[0])]
        if use_depth and depth_maps is not None:
            local_3d = lift_2d_to_3d(mine, depth_maps)
        else:
            local_3d = torch.cat([mine, torch.ones_like(mine[..., :1])], dim=-1)
        tracks_3d = gather(local_3d, group)
        batch = split_and_sample_queries(perm, ts, tracks_3d, visible, num_support=num_support,
                                         num_queries=num_queries, num_frames=num_frames)
        support_rows, query_rows = rows(num_support), rows(num_queries)
        local = {k: batch[k][:, support_rows] for k in SUPPORT_KEYS}
        local.update({k: batch[k][:, query_rows] for k in QUERY_KEYS})
        local["boundary_frame"] = batch["boundary_frame"]
        support_2d = tracks_2d[perm[support_rows]]
        if use_dino and dino_grid is not None:
            local["dino_features"] = sample_dino_features_for_tracks(
                dino_grid, support_2d, (num_frames,) + tuple(video_hw) + (3,))[None]
        if use_depth and depth_maps is not None:
            local["depth_features"] = sample_depth_features_for_tracks(depth_maps, support_2d)[None]
        preds = model(local, gather_tokens=lambda tokens: gather(tokens, group, dim=1))
        predictions = TrackAutoEncoderResults(
            tracks=gather(preds.tracks, group, dim=1),
            visible_logits=gather(preds.visible_logits, group, dim=1),
            certain_logits=gather(preds.certain_logits, group, dim=1),
        )
        for key in ("dino_features", "depth_features"):
            if key in local:
                batch[key] = gather(local[key], group, dim=1)
        return predictions, batch, tracks_3d


def make_mesh_tail(mesh, model, num_support: int, num_queries: int, video_hw: tuple,
                   use_dino: bool = True, use_depth: bool = True):
    """Mesh-sharded fused tail, the multi-GPU decode path: the track set over
    ('data', 'seq') jointly (``query_sharded_batch_spec``), so each rank
    encodes its share of the support tracks and decodes its share of the
    queries (``mesh_fused_tail``); parameters and the feature grids are
    whole on every rank. The kernels run on each rank's shard unchanged.

    Returns ``tail(tracks_2d, visible, dino_grid, depth_maps, perm, ts)`` ->
    (predictions, batch, tracks_3d), the same on every rank; ``perm`` and
    ``ts`` must be the same on every rank (``broadcast_split``).
    """
    group = world_group(mesh)
    count = dist.get_world_size(group)
    if num_support % count or num_queries % count:
        raise ValueError(f"num_support={num_support} and num_queries={num_queries} must "
                         f"divide by the mesh's {count} ranks")

    def tail(tracks_2d, visible, dino_grid, depth_maps, perm, ts):
        if tracks_2d.shape[0] % count:
            raise ValueError(f"the {tracks_2d.shape[0]} tracks must divide by the mesh's "
                             f"{count} ranks")
        return mesh_fused_tail(model, group, dist.get_rank(group), tracks_2d, visible,
                               dino_grid, depth_maps, perm, ts, num_support, num_queries,
                               tuple(video_hw), use_dino, use_depth)

    return tail


def broadcast_split(perm: torch.Tensor, ts: torch.Tensor, mesh) -> None:
    """Overwrite the split's indices on every rank with rank 0's, in place:
    the sharded tail needs one split, whatever each rank drew."""
    group = world_group(mesh)
    for x in (perm, ts):
        dist.broadcast(x, src=0, group=group)


class InferencePipeline:
    """Configured end-to-end pipeline with pluggable front ends.

    ``params`` is a flax-layout parameter tree (e.g. from the JAX package or
    ``load_params_tree``); ``checkpoint_path`` an ``.npz`` checkpoint. With
    neither, the model keeps its seeded random initialisation.
    ``tail_artifact`` is an exported tail (``infer/export.py``) run in place
    of ``fused_tail`` with the model's parameters; its manifest must match
    this pipeline's configuration (``ValueError`` otherwise). ``mesh``
    (``tdspa_torch.parallel.make_mesh``, every rank in order) runs the tail
    sharded over its ranks (``make_mesh_tail``), with rank 0's split; every
    rank runs the pipeline and gets the whole result.

    The model's DINO projection is as wide as the DINO backbone: the passed
    extractor's ``ViTConfig``, else ``dino_model``'s. A passed model or
    extractor of another width is refused (``ValueError``): at construction
    where both are passed, else when the extractor is built.
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
        self.device = resolve_device(device)
        self.mesh = mesh
        self._mesh_tail = None
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
        self._dino_extractor = dino_extractor
        # The DINO backbone's width (a provider of unknown width: the default).
        dino_width = {}
        if model is None and use_dino:
            width = (_backbone_width(dino_extractor) if dino_extractor is not None
                     else dino_config(dino_model).hidden_size)
            dino_width = {"dino_feature_dim": width} if width else {}
        self.model = model or TrackAutoEncoder3D(
            num_output_frames=num_output_frames,
            use_dino=use_dino,
            use_depth=use_depth,
            **dino_width,
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
        if model is not None and dino_extractor is not None:
            self._check_dino_width(dino_extractor)
        self._track_provider = track_provider
        self._depth_provider = depth_provider
        self.params = params
        self.checkpoint_path = checkpoint_path
        self.projection_policy = projection_policy
        self.timings: dict[str, float] = {}
        self.load_params()
        # An exported tail (infer/export.py) in place of fused_tail: loaded at
        # the first run, called with the model's parameters (the same
        # tensors every call, which the kernels' caches key on).
        self.tail_artifact = tail_artifact
        self._artifact = None
        if tail_artifact:
            self._artifact_params = dict(self.model.state_dict())

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
            self._check_dino_width(self._dino_extractor)
        return self._dino_extractor

    def _check_dino_width(self, extractor) -> None:
        """``ValueError`` where the model's DINO projection and the backbone
        (an extractor with a ``ViTConfig``) differ in width."""
        width = _backbone_width(extractor)
        if not (self.use_dino and getattr(self.model, "use_dino", False) and width):
            return
        model_width = self.model.dino_projection.kernel.shape[0]
        if model_width != width:
            raise ValueError(f"the model's DINO projection takes {model_width}-d features, "
                             f"the DINO backbone gives {width}-d ones")

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
        """``fn(*args)`` as stage ``name`` of this run's ``timings`` and as
        the span ``tdspa.video.<name>``."""
        with stage_timer(name, self.timings):
            return fn(*args)

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
        not streamed needs it, a feature only where it was streamed. Spans:
        ``tdspa.video.upload`` (host encode and copy), ``tdspa.video.dino``
        and ``tdspa.video.depth`` per chunk, ``tdspa.video.track`` once.
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
        # One queue on the device: the stage's closing sync waits for the
        # upload, the tracking and every chunk's features, so none of them
        # leaks into the tail.
        with stage_timer("upload_tracking_features", self.timings):
            chunks = []
            for i in range(0, t, chunk):
                with span("tdspa.video.upload"):
                    if self.upload_yuv420 and h % 2 == 0 and w % 2 == 0:
                        planes = rgb_to_yuv420(video[i : i + chunk])
                        chunks.append(yuv420_to_rgb(*(self._upload(p) for p in planes)))
                    else:
                        chunks.append(self._upload(video[i : i + chunk]))
            with span("tdspa.video.track"):
                track_data = self.track_provider.track_chunks(chunks)
            dino_parts = [self._spanned("tdspa.video.dino", self.dino_extractor, c)
                          for c in chunks] if stream_dino else None
            depth_parts = [self._spanned("tdspa.video.depth", self.depth_provider, c)
                           for c in chunks] if stream_depth else None
            # The whole video only for feature providers that are not streamed.
            need_full = (self.use_dino and not stream_dino) or (self.use_depth and not stream_depth)
            video_dev = torch.cat(chunks, dim=0) if need_full else None
            dino_grid = torch.cat(dino_parts, dim=0) if dino_parts is not None else None
            depth_maps = torch.cat(depth_parts, dim=0) if depth_parts is not None else None
        return track_data, video_dev, dino_grid, depth_maps

    @staticmethod
    def _spanned(name, fn, *args):
        with span(name):
            return fn(*args)

    @torch.inference_mode()
    def run_on_frames(self, video: np.ndarray, fps: float = 30.0) -> dict:
        """Full pipeline on an in-memory [T H W 3] uint8 video; ``timings``
        holds this run's stages alone."""
        self.timings = {}
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

        if self.mesh is not None:
            broadcast_split(perm, ts, self.mesh)
            if self._mesh_tail is None:
                self._mesh_tail = make_mesh_tail(self.mesh, self.model, num_support,
                                                 num_queries, (h, w), self.use_dino,
                                                 self.use_depth)
            predictions, batch, tracks_3d = self._timed(
                "fused_tail", self._mesh_tail, tracks_2d, visible, dino_grid, depth_maps, perm,
                ts)
        else:
            tail = (self._artifact_tail if self.tail_artifact
                    else functools.partial(fused_tail, self.model))
            predictions, batch, tracks_3d = self._timed(
                "fused_tail", tail, tracks_2d, visible, dino_grid, depth_maps, perm, ts,
                num_support, num_queries, (h, w), self.use_dino, self.use_depth,
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

    def _artifact_tail(self, tracks_2d, visible, dino_grid, depth_maps, perm, ts,
                       num_support: int, num_queries: int, video_hw: tuple, use_dino: bool,
                       use_depth: bool):
        """``fused_tail`` through the exported artifact, after a check of its
        manifest against this pipeline's configuration (JAX runs the
        artifact's own split and shapes without one). The call is the span
        ``tdspa.tail``."""
        with span("tdspa.tail"):
            from tdspa_torch.infer.export import load_exported, read_manifest, tail_config

            manifest = read_manifest(self.tail_artifact)
            want = tail_config(
                self.model, num_tracks=tracks_2d.shape[0], num_frames=tracks_2d.shape[1],
                video_hw=video_hw, num_support=num_support, num_queries=num_queries,
                use_dino=use_dino, use_depth=use_depth, device=self.device.type,
            )
            wrong = {k: (manifest.get(k), v) for k, v in want.items() if manifest.get(k) != v}
            if wrong:
                raise ValueError(f"tail artifact {self.tail_artifact} was exported for another "
                                 f"configuration; (manifest, pipeline) differ at {wrong}")
            if self._artifact is None:
                self._artifact = load_exported(self.tail_artifact)
            features = [x for x, used in ((dino_grid, use_dino), (depth_maps, use_depth)) if used]
            out = self._artifact.call(self._artifact_params, perm, ts, tracks_2d,
                                      visible.to(torch.float32), *features)
            predictions = TrackAutoEncoderResults(
                tracks=out["tracks"], visible_logits=out["visible_logits"],
                certain_logits=out["certain_logits"],
            )
            batch = {"support_tracks": out["support_tracks"], "query_tracks": out["query_tracks"]}
            return predictions, batch, out["tracks_3d"]

    def run(self, video_path: str) -> dict:
        """Full pipeline on a video file: its first ``num_output_frames``
        frames, decoded on the host with OpenCV."""
        video, fps = load_video(video_path, max_frames=self.num_output_frames)
        logger.info("Loaded video: %d frames, %dx%d, %.2f fps",
                    video.shape[0], video.shape[1], video.shape[2], fps)
        return self.run_on_frames(video, fps)


def _backbone_width(extractor) -> int | None:
    """Hidden size of an extractor's ViT; None for a provider without one."""
    config = getattr(extractor, "config", None)
    return config.hidden_size if isinstance(config, ViTConfig) else None


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
