"""Visualizer CLI (port of ``tdspa/cli/visualize.py``: the same flags and
defaults, parsed absl-style with ``cli/flags.py``, plus ``--device``).

Example (on the GPU; ``--device=cpu`` projects on the CPU):

  python -m tdspa_torch.cli.visualize --npz_path=results.npz --save_frames

Loads coords/coords_score/video/intrinsics/extrinsics from the npz (the
contract ``tdspa_torch.eval.realism.save_visualization_npz`` writes),
projects the 3D tracks with ``tdspa_torch.ops.geometry.project_all_tracks``
on ``--device``, paints score-coloured trails (``tdspa_torch.viz``), and
writes an mp4 (+ PNG frames with ``--save_frames``).
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

import numpy as np
import torch

from tdspa_torch.cli import flags as F

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Visualize 3DSPA point tracks on video with color coding (PyTorch port)",
        allow_abbrev=False)
    arg = p.add_argument
    arg("--npz_path", required=True,
        help="Path to .npz with coords, coords_score, video, intrinsics, extrinsics")
    arg("--output_dir", help="Output directory (default: npz directory)")
    arg("--output_name", help="Output video name (default: {stem}_visualized.mp4)")
    arg("--trail", type=int, default=5, help="Number of frames for trail")
    arg("--point_size", type=int, default=2, help="Radius of points")
    arg("--resize_height", type=int, default=1024, help="Height used for projection scaling")
    arg("--resize_width", type=int, default=1024, help="Width used for projection scaling")
    arg("--fps", type=int, default=10, help="Frames per second for output video")
    F.boolean(p, "normalize_scores", True, "Normalize scores to [0, 1] range")
    # JAX's spelling of the negation, kept beside the absl one.
    arg("--no_normalize_scores", dest="normalize_scores", action="store_false",
        help=argparse.SUPPRESS)
    F.boolean(p, "save_frames", False, "Save individual frames as PNG images")
    arg("--device", default="cuda", help="Where the projection runs: cuda (default) or cpu")
    return p


def main(argv: list[str] | None = None) -> Path:
    """Run the CLI on ``argv`` (default: the command line); returns the mp4's path."""
    args = build_parser().parse_args(argv)

    from tdspa_torch.ops.geometry import project_all_tracks
    from tdspa_torch.utils.device import resolve_device
    from tdspa_torch.viz.paint import (
        load_visualization_data,
        normalize_scores,
        paint_point_track_with_colors,
        prepare_video_for_visualization,
        save_frames,
        save_video_opencv,
    )

    device = resolve_device(args.device)
    logger.info("Loading data from %s", args.npz_path)
    data = load_visualization_data(args.npz_path)
    coords = data["coords"]
    num_frames, num_points = coords.shape[:2]
    _, _, h_orig, w_orig = data["video"].shape
    logger.info("Loaded %d frames, %d points (%dx%d)", num_frames, num_points, h_orig, w_orig)

    _, video_bgr = prepare_video_for_visualization(data["video"])
    tracks_2d = project_all_tracks(
        torch.as_tensor(coords, dtype=torch.float32, device=device), data["intrinsics"],
        data["extrinsics"], resize_height=args.resize_height, resize_width=args.resize_width,
        original_height=h_orig, original_width=w_orig,
    ).cpu().numpy()

    scores = data["coords_score"]
    if args.normalize_scores:
        scores = normalize_scores(scores, normalize=True)

    video_viz = paint_point_track_with_colors(video_bgr, tracks_2d, data["visibs"].T, scores,
                                              trail=args.trail, point_size=args.point_size)

    npz_path = Path(args.npz_path)
    output_dir = Path(args.output_dir) if args.output_dir else npz_path.parent
    stem = Path(args.output_name).stem if args.output_name else npz_path.stem + "_visualized"
    output_video_path = output_dir / f"{stem}.mp4"
    output_dir.mkdir(parents=True, exist_ok=True)
    save_video_opencv(video_viz, output_video_path, fps=args.fps)
    logger.info("Saved visualized video to: %s", output_video_path)

    if args.save_frames:
        frames_rgb = np.ascontiguousarray(video_viz[..., ::-1])  # BGR -> RGB
        frames_dir = output_dir / stem
        save_frames(frames_rgb, frames_dir)
        logger.info("Saved %d frames to: %s", num_frames, frames_dir)
    return output_video_path


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main(sys.argv[1:])
