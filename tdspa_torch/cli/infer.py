"""Inference CLI (port of ``tdspa/cli/infer.py``: the same flags and defaults).

Example (on the GPU; ``--device=cpu`` runs the plain versions on the CPU):

  python -m tdspa_torch.cli.infer --video_path=clip.mp4 \
      --checkpoint_path=3dspa_ckpt.npz --output_dir=./out

Writes ``predictions.npz`` and ``video_info.txt`` in the reference's schema.
``--device`` (default ``cuda``) is the only flag the JAX CLI does not have.
Four flags name pieces the port does not have yet and raise:
``--track_provider=cotracker`` and ``--vda_torch_adapter`` (external
packages), ``--tail_artifact`` (the export slice) and ``--debug_nans``.
"""

from __future__ import annotations

import argparse
import logging
import sys

import torch

from tdspa_torch.cli import flags as F

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Score a video with the 3DSPA pipeline (PyTorch/CUDA port).",
        allow_abbrev=False)
    arg = p.add_argument
    arg("--checkpoint_path", help="Path to 3DSPA model checkpoint (.npz)")
    arg("--video_path", help="Path to input video file")
    arg("--output_dir", default="./inference_output", help="Output directory")
    arg("--num_output_frames", type=int, default=150, help="Number of output frames")
    F.boolean(p, "use_dino", True, "Use DINOv2 features")
    F.boolean(p, "use_depth", True, "Use depth features")
    F.boolean(p, "quantize", False, "Dynamic int8 projections and MLPs in the model "
              "(csrc/quant_matmul.cu); same checkpoint layout")
    F.boolean(p, "bf16_residual", False,
              "bf16 residual stream in the model's stacks and the ViT backbones")
    F.boolean(p, "fused_block", False,
              "Fused block kernel (csrc/block.cu) for the unmasked self-attention stacks")
    arg("--tracking_input_scale", type=float, default=1.0,
        help="LK tracker luma resolution factor (1.0 or 0.5)")
    arg("--depth_output_scale", type=float, default=1.0,
        help="Run the depth head's full-resolution tail at this scale (approximate; 1.0 exact)")
    arg("--depth_input_size", type=int, default=518,
        help="Long side of the frames fed to the depth backbone (approximate; 518 exact)")
    F.boolean(p, "fast_gelu", False, "tanh-approximate GELU in the DINOv2/VDA backbones")
    arg("--num_query_points", type=int, default=512, help="Number of query points")
    arg("--num_support_tracks", type=int, default=2048, help="Number of support tracks")
    arg("--tracking_grid_size", type=int, default=64, help="Grid size for dense tracking")
    arg("--dino_model", default="facebook/dinov2-base", help="DINOv2 model name")
    arg("--vda_model_path", help="VideoDepthAnything checkpoint (.pth)")
    arg("--projection_policy", default="error", choices=["error", "slice", "ignore"],
        help="Handling of reference-layout square dino/depth projection kernels "
             "(tdspa_torch.infer.checkpoint.adapt_reference_projections)")
    F.boolean(p, "vda_torch_adapter", False,
              "Run VDA through the external Video-Depth-Anything repository (not in the port)")
    arg("--vda_encoder", default="vitb", help="VideoDepthAnything encoder: vits, vitb, or vitl")
    arg("--track_provider", default="auto",
        help="auto | cotracker | lk | static | npz:<path-to-tracks.npz>")
    arg("--seed", type=int, default=0, help="Support/query split RNG seed")
    arg("--tracker_corr_radius", type=int, default=0,
        help="LK tracker: cost-volume re-localization radius (0 disables)")
    arg("--tracker_corr_rescue_level", type=int, default=0,
        help="LK tracker: also search the cost volume at this pyramid level (0 disables)")
    arg("--tracker_matcher", default="",
        help="LK tracker: learned matching head ('' disables, 'auto' = on degraded video, "
             "'default' = always the shipped matcher, else a matcher .npz path)")
    F.boolean(p, "debug_nans", False, "Raise on the first NaN (not in the port)")
    arg("--tail_artifact", help="Pre-exported fused-tail artifact (not in the port)")
    arg("--profile_dir",
        help="Write a torch.profiler (Chrome/Perfetto) trace of the pipeline run here")
    arg("--device", default="cuda", help="Where the pipeline runs: cuda (default) or cpu")
    return p


def check_supported(args) -> None:
    """Raise on the flags whose piece the port does not have."""
    missing = []
    if args.track_provider == "cotracker":
        missing.append("--track_provider=cotracker needs CoTrackerProvider and the external "
                       "cotracker package, which the port does not carry (ROADMAP.md, queue 1: "
                       "not queued, outside the repository); use --track_provider=lk or auto")
    if args.vda_torch_adapter:
        missing.append("--vda_torch_adapter needs TorchVDAProvider and the external "
                       "Video-Depth-Anything repository (ROADMAP.md, queue 1: not queued, "
                       "outside the repository); --vda_model_path alone converts the .pth "
                       "into the port's estimator")
    if args.tail_artifact:
        missing.append("--tail_artifact needs the exported tail of the export slice "
                       "(ROADMAP.md, queue 1, item 6)")
    if args.debug_nans:
        missing.append("--debug_nans is JAX's jax_debug_nans; the port's counterpart comes "
                       "with tdspa/utils/debug.py (ROADMAP.md, queue 1, item 8)")
    if missing:
        raise NotImplementedError("; ".join(missing))


def build_track_provider(args, device):
    from tdspa_torch.features import tracks as T

    choice = args.track_provider
    if choice.startswith("npz:"):
        return T.PrecomputedTrackProvider(choice[4:])
    if choice == "lk":
        return T.PyramidalLKTracker(
            grid_size=args.tracking_grid_size,
            corr_radius=args.tracker_corr_radius,
            corr_rescue_level=args.tracker_corr_rescue_level,
            matcher=args.tracker_matcher or None,
            input_scale=args.tracking_input_scale,
            device=device,
        )
    if choice == "static":
        return T.StaticGridProvider(grid_size=args.tracking_grid_size)
    if choice != "auto":
        raise ValueError(f"--track_provider={choice!r}: expected auto, lk, static or npz:<path>")
    return None  # auto: the pipeline's own LK tracker (the port has no CoTracker)


def build_depth_provider(args, device):
    if not args.vda_model_path:
        return None
    from tdspa_torch.features.depth import VideoDepthEstimator

    return VideoDepthEstimator.from_checkpoint(
        args.vda_model_path, encoder=args.vda_encoder, output_scale=args.depth_output_scale,
        input_size=args.depth_input_size, gelu_approximate=args.fast_gelu, device=device,
    )


def pipeline_kwargs(args) -> dict:
    """The ``InferencePipeline`` keyword arguments the flags ask for."""
    return dict(
        checkpoint_path=args.checkpoint_path,
        num_output_frames=args.num_output_frames,
        use_dino=args.use_dino,
        use_depth=args.use_depth,
        num_query_points=args.num_query_points,
        num_support_tracks=args.num_support_tracks,
        tracking_grid_size=args.tracking_grid_size,
        dino_model=args.dino_model,
        vda_encoder=args.vda_encoder,
        track_provider=build_track_provider(args, args.device),
        depth_provider=build_depth_provider(args, args.device),
        seed=args.seed,
        projection_policy=args.projection_policy,
        quantize=args.quantize,
        residual_dtype=torch.bfloat16 if args.bf16_residual else None,
        depth_output_scale=args.depth_output_scale,
        depth_input_size=args.depth_input_size,
        gelu_approximate=args.fast_gelu,
        tracking_input_scale=args.tracking_input_scale,
        fused_block=args.fused_block,
        device=args.device,
    )


def main(argv: list[str] | None = None) -> dict:
    """Run the CLI on ``argv`` (default: the command line); returns the
    pipeline's results."""
    args = build_parser().parse_args(argv)
    if args.video_path is None:
        raise ValueError("Must provide video_path")
    if args.checkpoint_path is None:
        raise ValueError("Must provide checkpoint_path")
    check_supported(args)

    from tdspa_torch.infer.pipeline import InferencePipeline, save_results

    pipeline = InferencePipeline(**pipeline_kwargs(args))
    if args.profile_dir:
        from tdspa_torch.utils.profiling import profile_trace

        with profile_trace(args.profile_dir):
            results = pipeline.run(args.video_path)
    else:
        results = pipeline.run(args.video_path)
    save_results(results, args.output_dir)
    logger.info("Inference completed!")
    return results


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main(sys.argv[1:])
