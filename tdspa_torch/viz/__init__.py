"""Track visualization (port of ``tdspa/viz``)."""

from tdspa_torch.viz.paint import (
    load_visualization_data,
    normalize_scores,
    paint_point_track_with_colors,
    prepare_video_for_visualization,
    save_frames,
    save_video_opencv,
    score_to_color_bgr,
    scores_to_colors_bgr,
)
