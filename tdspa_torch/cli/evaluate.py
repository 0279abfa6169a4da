"""TAPVid-3D evaluation CLI (port of ``tdspa/cli/evaluate.py``: the same flags
and defaults, plus ``--device``).

Example (on the GPU; ``--device=cpu`` runs on the CPU):

  python -m tdspa_torch.cli.evaluate --checkpoint_path=3dspa_ckpt.npz \
      --dataset_path=/data/tapvid3d --data_sources=drivetrack,adt,pstudio

Writes ``<output_dir>/results.json``: ``{"per_source": {source: {scaling:
metrics}}, "overall": {scaling: ...}, "split": {source: "minival" |
"full_eval" | "all_files"}}``. Split files come from
``tapnet.tapvid3d.splits`` when importable; otherwise every ``.npz`` under
``<dataset_path>/<source>/`` is evaluated (``"all_files"``). ``--debug_nans``
raises ``FloatingPointError`` at the first operator that makes a NaN
(``tdspa_torch.utils.debug``). Under ``torchrun`` the CLI joins the process
group, as JAX's joins its multi-host runtime.
"""

from __future__ import annotations

import json
import argparse
import logging
import os
import sys

import numpy as np

from tdspa_torch.cli import flags as F

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Evaluate 3DSPA on TAPVid-3D ground truth (PyTorch/CUDA port).",
        allow_abbrev=False)
    arg = p.add_argument
    arg("--checkpoint_path", help="Path to model checkpoint (.npz)")
    arg("--dataset_path", help="Path to TAPVid-3D dataset")
    arg("--output_dir", default="./eval_results", help="Output directory")
    arg("--batch_size", type=int, default=8, help="Batch size for evaluation")
    arg("--num_output_frames", type=int, default=150, help="Number of output frames")
    F.boolean(p, "use_dino", True, "Use DINO features")
    F.boolean(p, "use_depth", True, "Use depth features")
    arg("--depth_scalings", type=F.comma_list, default=["median"],
        help="Depth scaling strategies: median, per_trajectory, none")
    arg("--data_sources", type=F.comma_list, default=["drivetrack", "adt", "pstudio"],
        help="Data sources to evaluate")
    F.boolean(p, "use_minival", True, "Use minival split (otherwise full_eval)")
    arg("--track_bucket", type=int, default=256, help="Pad track counts to this multiple")
    arg("--projection_policy", default="error", choices=["error", "slice", "ignore"],
        help="Handling of reference-layout square dino/depth projection kernels "
             "(tdspa_torch.infer.checkpoint.adapt_reference_projections)")
    F.boolean(p, "debug_nans", False,
              "Raise FloatingPointError at the first operator whose output holds a NaN")
    F.boolean(p, "tiny_model", False,
              "Use the tiny 3DSPA config (smoke tests / CI; checkpoint must match)")
    arg("--device", default="cuda", help="Where the model runs: cuda (default) or cpu")
    return p


def _split_files(source: str, use_minival: bool) -> list | None:
    try:
        from tapnet.tapvid3d.splits import tapvid3d_splits
    except ImportError:
        return None
    if use_minival:
        return tapvid3d_splits.get_minival_files(subset=source)
    return tapvid3d_splits.get_full_eval_files(subset=source)


def main(argv: list[str] | None = None) -> dict:
    """Run the CLI on ``argv`` (default: the command line); returns what it
    wrote to ``results.json``."""
    args = build_parser().parse_args(argv)
    if args.checkpoint_path is None:
        raise ValueError("Must provide checkpoint_path")
    if args.dataset_path is None:
        raise ValueError("Must provide dataset_path")
    os.makedirs(args.output_dir, exist_ok=True)

    from tdspa_torch.data.providers import NpzDirectoryProvider
    from tdspa_torch.eval.harness import evaluate_model
    from tdspa_torch.infer.checkpoint import load_checkpoint
    from tdspa_torch.parallel.mesh import maybe_initialize_distributed
    from tdspa_torch.utils.device import resolve_device
    from tdspa_torch.utils.profiling import debug_nans

    device = resolve_device(args.device)
    maybe_initialize_distributed(args.device)  # multi-process when launched as such
    model = None  # evaluate_model builds the full-size 3DSPA by default
    if args.tiny_model:
        from tdspa_torch.utils.testing import tiny_model_3d

        model = tiny_model_3d(args.num_output_frames, use_dino=args.use_dino,
                              use_depth=args.use_depth, device=device)
    track_token_dim = model.track_token_dim if model is not None else 384
    logger.info("Loading checkpoint from %s", args.checkpoint_path)
    params = load_checkpoint(args.checkpoint_path, projection_policy=args.projection_policy,
                             track_token_dim=track_token_dim, device=device)

    all_metrics, splits_used = {}, {}
    for source in args.data_sources:
        logger.info("Evaluating on %s", source)
        provider = NpzDirectoryProvider(os.path.join(args.dataset_path, source))
        split = _split_files(source, args.use_minival)
        if split is not None:
            wanted = set(split)
            indices = [i for i, f in enumerate(provider.files) if os.path.basename(f) in wanted]
            splits_used[source] = "minival" if args.use_minival else "full_eval"
        else:
            logger.info("tapnet splits unavailable; evaluating all %d files", len(provider.files))
            indices = range(len(provider.files))
            splits_used[source] = "all_files"
        with debug_nans(args.debug_nans):
            all_metrics[source] = evaluate_model(
                params,
                (provider[int(i)] for i in indices),
                num_output_frames=args.num_output_frames,
                use_dino=args.use_dino,
                use_depth=args.use_depth,
                depth_scalings=args.depth_scalings,
                track_bucket=args.track_bucket,
                batch_size=args.batch_size,
                model=model,
                device=device,
            )
        for scaling in args.depth_scalings:
            for key, value in all_metrics[source][scaling].items():
                if not key.endswith("_std"):
                    logger.info("  %s / %s: %s: %.4f", source, scaling, key, value)

    overall = {}
    for scaling in args.depth_scalings:
        overall[scaling] = {}
        for key in all_metrics[args.data_sources[0]][scaling]:
            if key.endswith("_std"):
                continue
            values = [all_metrics[s][scaling][key] for s in args.data_sources]
            overall[scaling][key] = float(np.mean(values))
            overall[scaling][f"{key}_std"] = float(np.std(values))

    results = {"per_source": all_metrics, "overall": overall, "split": splits_used}
    results_file = os.path.join(args.output_dir, "results.json")
    with open(results_file, "w") as f:
        json.dump(results, f, indent=2)
    logger.info("Results saved to %s", results_file)
    return results


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main(sys.argv[1:])
