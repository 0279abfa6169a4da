"""Training CLI (port of ``tdspa/cli/train.py``: the same flags and defaults).

Example (on the GPU; ``--device=cpu`` trains on the CPU):

  python -m tdspa_torch.cli.train --model_type=3dspa --dataset_path=/data/kubric3d \
      --batch_size=64 --num_epochs=300

With no ``--dataset_path`` (or ``--config_path``, used as the dataset path
as in the reference) it reads ``./data`` when that directory exists and
otherwise trains on synthetic tracks (128 videos of 64 tracks). A path that
is not a directory names a tfds dataset and raises without tfds.
``--device`` (default ``cuda``) is the only flag the JAX CLI does not have.
``--debug_nans`` raises ``FloatingPointError`` at the first operator that
makes a NaN (``tdspa_torch.utils.debug``). Under ``torchrun
--nproc_per_node=N`` the ranks join one process group and train data
parallel (``train``'s mesh); rank 0 alone logs and writes checkpoints.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys

import torch
import torch.distributed as dist

from tdspa_torch.cli import flags as F

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train a track autoencoder (PyTorch/CUDA port).", allow_abbrev=False)
    arg = p.add_argument
    arg("--model_type", default="trajan", help="Model type: trajan or 3dspa")
    arg("--config_path", help="Path to config file (the dataset path without --dataset_path)")
    arg("--checkpoint_dir", default="./checkpoints", help="Checkpoint directory")
    arg("--wandb_project", default="3dspa", help="WandB project name")
    arg("--wandb_entity", help="WandB entity name")
    arg("--wandb_run_name", help="WandB run name")
    arg("--num_epochs", type=int, default=300, help="Number of training epochs")
    arg("--batch_size", type=int, default=64, help="Batch size")
    arg("--eval_freq", type=int, default=1000, help="Evaluation frequency in steps")
    arg("--save_freq", type=int, default=5000, help="Checkpoint save frequency in steps")
    arg("--learning_rate", type=float, default=1e-4, help="Learning rate")
    arg("--warmup_steps", type=int, default=10000, help="Warmup steps")
    arg("--num_output_frames", type=int, default=150, help="Number of output frames")
    F.boolean(p, "use_dino", True, "Use DINO features (for 3DSPA)")
    F.boolean(p, "use_depth", True, "Use depth features (for 3DSPA)")
    arg("--dataset_path", help="Dataset directory (.npz per video)")
    arg("--max_steps", type=int, help="Stop after this many steps")
    F.boolean(p, "tiny_model", False, "Use a tiny model config (smoke tests)")
    F.boolean(p, "bf16", False, "bfloat16 matmul compute in the model (parameters, optimizer "
              "state, softmax, losses and the residual stream stay float32)")
    F.boolean(p, "use_wandb", True, "Log to WandB when available")
    F.boolean(p, "debug_nans", False,
              "Raise FloatingPointError at the first operator whose output holds a NaN")
    arg("--profile_dir",
        help="Write a torch.profiler (Chrome/Perfetto) trace of the training run here")
    arg("--log_jsonl", help="Also append metrics to this JSONL file")
    arg("--num_support_tracks", type=int, default=2048, help="Support tracks per example")
    arg("--num_query_tracks", type=int, default=2048, help="Query tracks per example")
    arg("--log_freq", type=int, default=10, help="Metric logging frequency in steps")
    arg("--decoder_scan_chunk_size", type=int,
        help="Decode queries in chunks of this size (memory knob)")
    arg("--encoder_scan_chunk_size", type=int,
        help="Encode support tracks in chunks of this size, recomputed in the backward pass "
             "(memory knob)")
    arg("--grad_accum_steps", type=int, default=1,
        help="Split each batch into this many microbatches and accumulate gradients "
             "(one optimizer update per batch)")
    arg("--device", default="cuda", help="Where training runs: cuda (default) or cpu")
    return p


def main(argv: list[str] | None = None):
    """Run the CLI on ``argv`` (default: the command line); returns the
    final ``TrainState``."""
    args = build_parser().parse_args(argv)

    from tdspa_torch.data.providers import load_kubric3d_dataset, load_tapvid_dataset
    from tdspa_torch.parallel.mesh import maybe_initialize_distributed
    from tdspa_torch.train.loop import train
    from tdspa_torch.train.metrics import MetricLogger
    from tdspa_torch.utils.profiling import debug_nans, profile_trace

    main_rank = not maybe_initialize_distributed(args.device) or dist.get_rank() == 0

    dataset_path = args.dataset_path or args.config_path or (
        "./data" if os.path.isdir("./data") else "")
    loader_kwargs = dict(batch_size=args.batch_size, num_support_tracks=args.num_support_tracks,
                         num_query_tracks=args.num_query_tracks,
                         num_frames=args.num_output_frames)
    if args.model_type == "3dspa":
        features = dict(use_dino=args.use_dino, use_depth=args.use_depth)
        train_ds = load_kubric3d_dataset(dataset_path, split="train", shuffle=True,
                                         **features, **loader_kwargs)
        eval_ds = load_kubric3d_dataset(dataset_path, split="validation", shuffle=False,
                                        **features, **loader_kwargs)
    else:
        train_ds = load_tapvid_dataset(dataset_path, split="train", shuffle=True,
                                       **loader_kwargs)
        eval_ds = load_tapvid_dataset(dataset_path, split="validation", shuffle=False,
                                      **loader_kwargs)

    metric_logger = MetricLogger(
        project=args.wandb_project, entity=args.wandb_entity,
        run_name=args.wandb_run_name or f"{args.model_type}_{args.wandb_project}",
        config={k: getattr(args, k) for k in ("model_type", "batch_size", "learning_rate",
                                              "num_epochs", "num_output_frames", "use_dino",
                                              "use_depth")},
        use_wandb=args.use_wandb and main_rank, jsonl_path=args.log_jsonl if main_rank else None,
    )

    overrides = {}
    if args.tiny_model:
        from tdspa_torch.utils.testing import TINY_3D

        overrides = dict(TINY_3D)
    if args.decoder_scan_chunk_size:
        overrides["decoder_scan_chunk_size"] = args.decoder_scan_chunk_size
    if args.encoder_scan_chunk_size:
        overrides["encoder_scan_chunk_size"] = args.encoder_scan_chunk_size
    if args.bf16:
        overrides["dtype"] = torch.bfloat16

    trace = profile_trace(args.profile_dir) if args.profile_dir else contextlib.nullcontext()
    with trace, debug_nans(args.debug_nans):
        state = train(
            train_ds, eval_ds=eval_ds, model_type=args.model_type, num_epochs=args.num_epochs,
            learning_rate=args.learning_rate, warmup_steps=args.warmup_steps,
            num_output_frames=args.num_output_frames, use_dino=args.use_dino,
            use_depth=args.use_depth, eval_freq=args.eval_freq, save_freq=args.save_freq,
            log_freq=args.log_freq, checkpoint_dir=args.checkpoint_dir, logger=metric_logger,
            max_steps=args.max_steps, grad_accum_steps=args.grad_accum_steps,
            device=args.device, **overrides,
        )
    logger.info("Training completed")
    return state


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main(sys.argv[1:])
