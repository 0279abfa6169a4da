"""Export the fused serving tail to a ``torch.export`` artifact (port of
``tdspa/cli/export.py``: the same flags and defaults).

Builds the flagship 3DSPA model at the given serving configuration, loads
the checkpoint (structure-checked as inference does), and writes a ``.pt2``
artifact and its JSON manifest that a server runs with
``tdspa_torch.infer.export.load_exported(path).call(params, perm, ts,
tracks_2d, visible, [dino_grid], [depth_maps])``, without the model's source.
``--platforms`` is the artifact's device: ``cuda`` (the default) or ``cpu``;
a CUDA artifact exports on a host without a GPU (the model is built on the
CPU and traced on fake CUDA tensors). ``--fused_block`` is the infer CLI's
serving knob, which the JAX CLI does not have. Run the artifact with
``python -m tdspa_torch.cli.infer --tail_artifact=<path>`` and the same
configuration flags.

Example:
  python -m tdspa_torch.cli.export --checkpoint_path=3dspa_ckpt.npz \
      --output_path=./out/tail_512x512.pt2 --bf16_residual
"""

from __future__ import annotations

import argparse
import logging
import sys

import torch

from tdspa_torch.cli import flags as F

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Export the 3DSPA serving tail (PyTorch/CUDA port).",
                                allow_abbrev=False)
    arg = p.add_argument
    arg("--checkpoint_path", help="3DSPA checkpoint (optional: without one the artifact is "
                                  "exported from random-init weights; it holds no weights)")
    arg("--output_path", help="Artifact path (the manifest lands at <output_path>.json)")
    arg("--platforms", default="cuda", choices=["cuda", "cpu"],
        help="The artifact's device: cuda (default) or cpu")
    arg("--num_output_frames", type=int, default=150, help="Number of output frames")
    arg("--video_height", type=int, default=512, help="Serving video height")
    arg("--video_width", type=int, default=512, help="Serving video width")
    F.boolean(p, "use_dino", True, "Use DINOv2 features")
    F.boolean(p, "use_depth", True, "Use depth features")
    arg("--num_query_points", type=int, default=512, help="Number of query points")
    arg("--num_support_tracks", type=int, default=2048, help="Number of support tracks")
    arg("--tracking_grid_size", type=int, default=64,
        help="Dense tracking grid (the track-set size the tail is traced for = grid^2)")
    arg("--dino_dim", type=int, default=768, help="DINOv2 feature dim (ViT-B: 768)")
    F.boolean(p, "quantize", False, "int8 dynamic-quant projection/MLP matmuls (serving knob)")
    F.boolean(p, "bf16_residual", False, "bf16 residual stream (serving knob)")
    F.boolean(p, "fused_block", False,
              "Fused block kernel (csrc/block.cu) for the unmasked self-attention stacks")
    arg("--projection_policy", default="error", choices=["error", "slice", "ignore"],
        help="Reference square-projection-kernel handling "
             "(tdspa_torch.infer.checkpoint.adapt_reference_projections)")
    F.boolean(p, "tiny_model", False, "Use the tiny 3DSPA config (smoke tests / CI)")
    return p


def main(argv: list[str] | None = None) -> dict:
    """Run the CLI on ``argv`` (default: the command line); returns the manifest."""
    args = build_parser().parse_args(argv)
    if args.output_path is None:
        raise ValueError("Must provide output_path")

    from tdspa_torch.infer.export import export_serving_tail, save_exported, tail_config
    from tdspa_torch.infer.pipeline import InferencePipeline

    t = args.num_output_frames
    num_tracks = args.tracking_grid_size ** 2
    num_support = min(args.num_support_tracks, max(num_tracks - 1, 1))
    num_queries = min(args.num_query_points, max(num_tracks - num_support, 1))
    residual_dtype = torch.bfloat16 if args.bf16_residual else None
    model = None  # default: the flagship full-size 3DSPA
    if args.tiny_model:
        from tdspa_torch.utils.testing import tiny_model_3d

        model = tiny_model_3d(t, use_dino=args.use_dino, use_depth=args.use_depth,
                              dino_feature_dim=args.dino_dim, device="cpu", dtype=torch.bfloat16,
                              fused_attention=True, quantize=args.quantize,
                              fused_block=args.fused_block,
                              residual_dtype=residual_dtype or torch.float32)
    # The pipeline builds the flagship model and loads and structure-checks
    # the checkpoint as inference does, on the CPU: tracing needs no device.
    pipeline = InferencePipeline(
        model=model, checkpoint_path=args.checkpoint_path, num_output_frames=t,
        use_dino=args.use_dino, use_depth=args.use_depth,
        num_query_points=args.num_query_points, num_support_tracks=args.num_support_tracks,
        tracking_grid_size=args.tracking_grid_size, projection_policy=args.projection_policy,
        quantize=args.quantize, residual_dtype=residual_dtype, fused_block=args.fused_block,
        device="cpu",
    )
    video_hw = (args.video_height, args.video_width)
    shapes = dict(num_tracks=num_tracks, num_frames=t, video_hw=video_hw,
                  num_support=num_support, num_queries=num_queries, use_dino=args.use_dino,
                  use_depth=args.use_depth)
    exported = export_serving_tail(pipeline.model, dino_dim=args.dino_dim,
                                   device=args.platforms, **shapes)
    manifest = save_exported(exported, args.output_path, {
        "checkpoint_path": args.checkpoint_path,
        **tail_config(pipeline.model, device=args.platforms, **shapes),
    })
    logger.info("Exported %s (%d bytes, device=%s) + manifest", args.output_path,
                manifest["bytes"], manifest["device"])
    return manifest


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main(sys.argv[1:])
