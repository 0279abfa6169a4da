#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``tdspa_torch``).

Run from the repository root on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases, each printing one JSON line (``{"phase": ...}``); any failure raises
and the script exits non-zero:

1. device: requires CUDA; prints the card's ``name, power.limit`` as
   ``nvidia-smi`` reports them; turns TF32 off so the plain references are
   full f32.
2. build: compiles every kernel under ``tdspa_torch/csrc/`` with ``nvcc``
   (one process per source, in parallel) into ``build/tdspa_torch/`` and
   prints each kernel's registers, static shared memory and spills from
   the compiler's ``-Xptxas -v`` report.
3. kernel: the fused attention kernel against its plain PyTorch version
   (``attention_reference``) at the five attention shapes of the 3DSPA
   forward, in both output dtypes, plus edge cases; each with its error
   against the stated tolerance, the kernel's time, the plain version's,
   ``scaled_dot_product_attention``'s (timed only, as a yardstick), the
   bound (the larger of bytes over 3.35 TB/s and flops over 989 TFLOP/s)
   and the kernel's work plan; then one forward's totals with f32 and with
   bf16 output beside SDPA's. Each shape first prints ``{"phase": "kernel",
   "shape": name}`` on its own, and each comparison ends in a synchronise, so
   a fault of the kernel is reported at its shape and not inside the next
   shape's SDPA timing; phases vit_attention_kernel, quant_matmul_kernel,
   bilinear_kernel and attention_backward do the same before their library
   timings.
   vit_attention_kernel: the same for the maskless ViT kernel
   (``csrc/vit_attention.cu``) at the DINO and depth backbones' frames,
   (8,1297,12,64) and (8,1370,12,64), and a ragged (2,77|1000,12,64).
4. pipeline: ``InferencePipeline.run_on_frames`` at full width (150 frames
   of 512x512, 4096 tracks, 2048 support, 512 queries, DINO and depth
   features, bf16 model with fused attention, random weights from a seed)
   a few times, counting kernel launches (19 attention per forward, 3
   bilinear per tail); then the same
   pipeline with the plain attention path, same weights and split, and
   their agreement.
5. lk_kernel: the LK kernel (``tdspa_torch/csrc/lk.cu``) against its plain
   version (``tdspa_torch/ops/lk.py``) on a full-width synthetic scene
   (150 frames of 512x512, 4096 grid points) in four configurations: the
   pipeline's, the tracker's defaults, the cost-volume rescue, and half
   resolution. Tracks within 0.05 px on 99 % of (point, frame) pairs and 99 %
   visibility agreement; kernel, plain and bound times of one 150-frame
   launch. In the pipeline's configuration also the video as the streamed
   pipeline tracks it: 4 chunk launches (frames 0-39, 39-79, 79-119,
   119-149, positions, velocity and template carried across) equal to the
   150-frame launch within 1e-4 px, timed together as ``video_ms`` beside
   their bound (``video_bound_ms``): the kernel's time per video.
6. matcher_kernel: the cost-patch kernel (``csrc/matcher.cu``) against its
   plain version on that scene's real feature map ([150,256,256,16], the
   shipped matcher) at the LK tracks, with 1 and 4 templates, atol 1e-4;
   time per launch beside its bound.
7. tracking: the pipeline's default tracker on the clean scene (no tier
   engages: 1 LK launch) and on a noisy one (the matcher alone: 1 LK and 8
   matcher launches), each scored against the scene's ground truth and held
   to within 0.02 of the JAX tracker's scores on the same scenes.
8. pipeline_tracked: ``InferencePipeline.run_on_frames`` with its default
   tracker on the clean scene's video: streamed upload in 4 chunks as YUV
   4:2:0, 4 LK launches per run; chunked tracks equal one unchunked call;
   then the noisy video, whose chunks engage the matcher (8 launches).
9. features: ``DinoFeatureExtractor`` and ``VideoDepthEstimator`` (ViT-B,
   seeded weights) on the clean scene's whole video: [150,36,36,768] and
   [150,512,512,1] (finite, depth >= 0), 228 ViT kernel and 703 ViT row
   kernel launches each, no SwiGLU gate, and their agreement with the same
   extractors on plain attention (which share the row kernels).
10. pipeline_full: ``InferencePipeline()`` with no front end passed in, on
   the clean scene: DINO and depth streamed per upload chunk; per run 456
   ViT, 1406 ViT row kernel, no SwiGLU gate, 19 tail attention, 3 bilinear
   and 4 LK launches; the streamed features equal
   one whole-video call of the same extractors; tracking quality as in 7;
   ``save_results`` writes the reference's ``predictions.npz``.

11. quant_matmul_kernel: the dynamic-int8 kernels (``csrc/quant_matmul.cu``:
   quantise pass + TMA/wgmma GEMM) against ``quant_matmul_reference`` at
   every (M, K, N) of the quantised full-width forward (f32 x, as the
   pipeline gives it), plus a bf16 x and a ragged M: equal bit for bit; the
   product's time, each pass's alone, the wrapper's (cached weights),
   plain and bound times, ``torch._int_mm`` on the pre-quantised operands
   and a bf16 matmul timed only, as yardsticks.
12. block_kernel: the fused block (``csrc/block.cu``) against
   ``block_reference`` at the readout [512,129,1280] (MLP 1536) and
   decompress [1,128,1152] (MLP 2048) layers, each of its seven CUDA
   kernels timed alone beside its own bound (``stage_ms``,
   ``stage_bound_ms``, ``stage_share``), the readout's attention stage
   beside ``csrc/attention.cu`` at the same shape, and the port's unfused
   layer (what ``fused_block=False`` runs) timed beside it.
13. bilinear_kernel: the bilinear kernel (``csrc/bilinear.cu``) against the
   plain gather on the tail's DINO grid [150,36,36,768] and depth maps
   [150,512,512,1] at 4096 tracks: equal bit for bit; ``grid_sample`` with
   border padding and ``align_corners`` (the same function) timed only, as
   the yardstick.
14. pipeline_quantized and pipeline_fused_block: ``InferencePipeline(
   quantize=True)`` and ``(fused_block=True)`` with phase 4's providers,
   seed and weights: per forward 106 int8 + 19 attention launches, and 8
   block + 11 attention launches; 3 bilinear launches per tail in every
   pipeline; each against phase 4's bf16 pipeline.

15. tracking_tiers: the pipeline's default tracker on three more full-width
   scenes that engage the 'auto' tiers the clean and noisy ones leave off: a
   fast pan (the cost-volume rescue, kept), a 60-degree roll (roll-stabilise)
   and heavy noise over natural texture (the rescue runs and is discarded,
   then the denoise re-track is kept); the tiers, LK launches split by
   configuration (plain, cost volume), matcher launches, seconds per scene,
   and quality within 0.02 of the JAX tracker's on the same scenes.
16. realism: ``score_tracks`` on phase 10's tail batch (2048 support, 512
   queries, 150 frames) with the fused attention kernel and with plain
   attention; ``save_visualization_npz`` writes the reference's contract.
17. video_entry: the clean scene written as an mp4 (``save_video``), then
   ``run_inference(path)`` and the infer CLI (``tdspa_torch.cli.infer.main``)
   on it: per run 456 ViT, 1406 ViT row kernel, 19 attention, 3 bilinear
   and 4 LK launches, and
   ``predictions.npz`` in the reference's schema.
18. eval_harness: ``evaluate_model`` at full width (default 3DSPA, seeded
   weights, 150 frames, DINO and depth on, no features supplied) on 16
   synthetic videos in the TAPVid-3D npz layout with 100-1000 tracks
   (buckets of 256, 512, 768 and 1024 tracks, batch_size 8): attention
   launches and the work plans of the new batched shapes, wall time per
   video, the forward against plain attention, the metrics against plain
   attention and batched against per video.

19. trajan2d: the default 2D ``TrackAutoEncoder`` (68,333,080 parameters,
   seeded, bf16 compute, fused attention) at T = 150, B = 1, 2048 support
   and 2048 query tracks: 21 attention launches per forward, outputs within
   5e-2 of the range of the same model on plain attention.
20. attention_backward: the backward kernel (``csrc/attention_backward.cu``)
   at the training path's shapes (3D encoder, latents' cross-attention,
   readout, 2D encoder; B = 1 of the model): ``fused_attention_fn``'s dq, dk,
   dv (one launch of each kernel) against the plain version
   (``attention_backward_reference``) within 2e-2 of each gradient's
   largest value, dq = 0 on the fully masked item, all finite; the kernel's
   ms beside its bound (bytes and flops), the plain version's, autograd
   through ``xla_reference`` (the eager recompute it replaced), SDPA's
   backward alone and its forward + backward (timed only).
21. train_3d and train_2d: ``train()`` with each default model at full width
   (bf16, fused attention, encoder and decoder chunks of 256, T = 150, 2048
   support and 2048 query tracks from ``SyntheticTrackProvider``, batch 2, 3
   steps, a checkpoint per step), the resume from step 2 against the
   uninterrupted step 3; then the step alone: step ms, peak memory,
   attention launches per step (each chunk's forward and its recompute)
   and backward-kernel launches per step (one per differentiated call),
   row-norm launches per step (``step_norm_launches``: forward each chunk's
   norms twice, the recompute too; backward once a norm; the shared query
   norm once a ``norm_q`` launch, its backward summing 3 cotangents a layer,
   4 with cross-attention),
   one accumulated step (2 microbatches) against the full step, the first
   step's loss and gradients against plain attention (bf16, and f32 as the
   yardstick of bf16 noise), and where a step's time goes.
22. train_cli: ``python -m tdspa_torch.cli.train`` per model type on the
   synthetic fallback: JAX's JSONL keys, and the step-2 checkpoint through
   ``load_checkpoint`` gives the logged eval loss.

23. export (after phase 14): the full-width tail exported with
   ``torch.export`` in the default, quantised and fused-block
   configurations (phase 4's model, split and inputs), saved, then loaded
   and called in a fresh process that imports no model module: launches per
   call (the ``tdspa::`` custom ops' CUDA implementations), call ms beside
   the eager ``fused_tail``'s, outputs against the eager tail within 1e-5 of
   the range (bit-equal expected); export_manifest_check: an artifact whose
   manifest differs from the pipeline's configuration is refused.
24. matcher_train (after phase 7): the bilinear and cost-patch wrappers
   refuse autograd on CUDA tensors; the matcher's training at the shipped
   recipe's widths and scenes: the first 3 steps on the card against the
   CPU, the feature net's gradient on the card, 1500 steps (step ms, peak
   memory, the logged losses, which must fall below 0.6 x the first, as in
   JAX's test), then the trained matcher saved, loaded and run by the
   tracker on the noisy scene through ``csrc/matcher.cu`` beside the
   shipped matcher.
25. export_entry (after phase 17): ``InferencePipeline(tail_artifact=...)``
   with phase 10's front ends and model on the clean scene, equal to phase
   10's predictions; the infer CLI with ``--tail_artifact``.
26. export_forward_2d (after phase 19): ``export_model_forward`` of the
   default 2D TRAJAN against its eager forward.
27. visualize (after phase 16): the visualize CLI
   (``tdspa_torch.cli.visualize``) on phase 16's visualization npz: the
   mp4's frame count and size; the tracks projected on the card against the
   CPU's within 1e-4 px.
28. debug_nans (after phase 23): the full-width default tail (phase 4's
   model, split and inputs) under ``debug_nans``: clean, it raises nothing
   and equals the unchecked tail; with a NaN in one DINO feature it raises
   ``FloatingPointError`` naming the operator (the bilinear kernel's
   ``tdspa::bilinear_sample``); unchecked, it equals phase 4's outputs; the
   time of each.
29. mesh (after phase 22): a one-rank NCCL process group (a ``FileStore`` in
   a temporary directory; the card's machine has one GPU, so multi-GPU speed
   is not measured): one sharded 3DSPA train step at phase 21's batch
   against the single-device step; ``make_mesh_tail`` in the default,
   quantised and fused-block configurations against ``fused_tail``, with
   their launches per call; ``export_mesh_tail``, saved, loaded and called
   through ``call_exported_mesh``, against the live mesh tail. The group is
   destroyed at the end, also on failure.
30. norm_kernel (after phase 12): the row-norm kernels (``csrc/norm.cu``)
   against their plain versions at the main paths' shapes: the tail
   encoder's [309248, 384] f32 -> bf16 LayerNorm and its [2473984, 96] bf16
   RMSNorm, the decoder's [66048, 1280]; TRAJAN training's f32 LayerNorm at
   [1056768, 1024] and bf16 RMSNorm at [9895936, 64], forward and backward.
   Each row: error, card ms, the plain chain's ms, the library's ms
   (``F.layer_norm`` / ``F.rms_norm`` and a cast, timed only: the port never
   calls them) and the bound (bytes over 3.35 TB/s: each operand read once,
   each output written once). Then the backward that sums a training
   query norm's three bf16 cotangents, at 3DSPA's [1056768, 1280] and
   [1236992, 384] f32 LayerNorms, against the plain backward of their f32
   sum, beside its bound (x, the cotangents, dx) and the chain it replaced.
31. vit_block_kernel (after phase 30): the ViT block's kernels
   (``csrc/vit_block.cu``) at ViT-g/14's shapes, 8 frames of 1297 tokens:
   the row kernel's four launches (norm1, the attention's residual with norm2,
   the FFN's residual, the final norm; f32 stream, bf16 projections) over
   [10376, 1536] and the SwiGLU gate over [10376, 8192] -> [10376, 4096]
   bf16; the row kernel's four launches also at ViT-B/14's width 768 over
   the pipeline's DINO rows (8 x 1297) and depth rows (8 x 1370). Each
   against its plain version (the stream and the gate bit for bit
   or within an ulp, the norms within f32 rounding of the row plus a bf16
   ulp), timed beside its bound (bytes over 3.35 TB/s) and beside the eager
   chain it replaces (the norms, bias adds, layer scales, residual sums, the
   casts of the norms' f32 output at each projection, SiLU and product); then
   the totals of one giant block call and of a request's 760; then one
   8-frame ViT-g/14 forward (seeded weights) with its launches counted: 121
   row, 40 gate and 40 ViT attention.

``python3 chip_smoke.py --matcher_recipe OUT.npz [SEED,SEED,...]`` runs, in
place of the phases, the one-off measurement of the matcher's whole recipe
(the round-4 recipe: 4000 steps, ``python -m tdspa_torch.features.matcher
OUT.npz --seed N --natural_frac=0`` for each seed, 0 by default) scored on
the noisy scene beside the shipped matcher, then the seeds' spread.

Where the card's time goes is not read here: the CLIs' ``--profile_dir``
writes a ``torch.profiler`` trace that holds the port's ``tdspa.*`` spans,
and ``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace 1`` reduces one of the benchmark's cells in memory.

Then one line ``{"kernels": [...]}`` with each kernel's launches on its
main-path run and its totals per forward or video, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a GPU it exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import inspect
import json
import logging
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from benchmark.harness.peaks import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S
from tdspa_torch.cli import infer as infer_cli
from tdspa_torch.data.providers import NpzDirectoryProvider
from tdspa_torch.eval import harness
from tdspa_torch.eval.realism import save_visualization_npz, score_tracks
from tdspa_torch.eval.tracking_quality import tracking_quality
from tdspa_torch.features import matcher as matcher_lib
from tdspa_torch.features.depth import VideoDepthEstimator
from tdspa_torch.features.dino import DinoFeatureExtractor
from tdspa_torch.features.tracks import PyramidalLKTracker, make_query_grid
from tdspa_torch.infer import export as export_lib
from tdspa_torch.infer.pipeline import InferencePipeline, fused_tail, run_inference, save_results
from tdspa_torch.infer.video import save_video
from tdspa_torch.core.attention import ParallelTransformerBlock, reset_parameters
from tdspa_torch.kernels import build
from tdspa_torch.kernels import lk as lk_kernel
from tdspa_torch.kernels import quant_matmul as qmm
from tdspa_torch.kernels.attention import (
    VIT_HEAD,
    attention_backward,
    attention_backward_reference,
    attention_reference,
    fused_attention_fn,
    fused_masked_attention,
    vit_attention,
    work_plan,
    xla_reference,
)
from tdspa_torch.kernels.bilinear import bilinear_sample as bilinear_kernel
from tdspa_torch.kernels.bilinear import bilinear_sample_reference
from tdspa_torch.kernels.block import (
    KERNELS_PER_CALL,
    STAGES as BLOCK_STAGES,
    _operands,
    attention_plan,
    block_reference,
    fused_transformer_block,
    launch_stages as block_launch_stages,
)
from tdspa_torch.kernels.matcher import cost_patches_multi, cost_patches_reference
from tdspa_torch.kernels import norm as norm_lib
from tdspa_torch.kernels import vit_block
from tdspa_torch.data.batch_prep import prepare_2d_batch, prepare_3d_batch
from tdspa_torch.data.prefetch import to_device
from tdspa_torch.data.providers import (
    SyntheticTrackProvider,
    load_kubric3d_dataset,
    load_tapvid_dataset,
)
from tdspa_torch.infer.checkpoint import TrainCheckpointer, load_checkpoint
from tdspa_torch.models import TrackAutoEncoder, TrackAutoEncoder3D
from tdspa_torch.ops.geometry import bilinear_sample
from tdspa_torch.ops.lk import to_gray, track_video_lk
from tdspa_torch.ops.yuv import rgb_to_yuv420
from tdspa_torch.train.losses import compute_loss_2d, compute_loss_3d
from tdspa_torch.train.loop import train
from tdspa_torch.train.metrics import MetricLogger
from tdspa_torch.train.state import build_model, create_model_state
from tdspa_torch.train.step import (
    loss_and_grads,
    make_eval_step,
    make_grad_accum_step,
    make_train_step,
)
from tdspa_torch.utils.synthetic_video import make_tracking_scene

SEED = 0
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor cores
SMS = 132  # H100 SXM streaming multiprocessors; read from the card in phase_device
# Kernel vs plain version, same bf16 inputs. Both round P to bf16 (the kernel
# before normalising, the plain version after), each a relative error
# <= 2**-9 per probability, so |diff| <= 2 * 2**-9 * max|v| ~ 0.018 for the
# N(0, 1) values used here; a bf16 output adds up to one bf16 ulp.
KERNEL_ATOL = 2e-2
KERNEL_RTOL_BF16_OUT = 2.0 ** -7
# Whole forward, fused kernel vs plain attention (both bf16 models): the two
# round differently inside every one of the 19 attentions and the
# differences pass through 15 layers; relative to the output's range.
PIPELINE_RTOL = 5e-2
# DINO grid and depth maps, ViT kernel vs plain attention (bf16 backbones,
# same weights): as for PIPELINE_RTOL, the two round differently inside each
# of the 12 attentions of a backbone and the differences pass through the
# layers after it; relative to the output's range.
FEATURES_RTOL = 5e-2
# Streamed (40-frame chunks) vs whole-video features: the same kernels on the
# same 8-frame groups, so the backbones see identical batches; only the
# resizes and the normalisation run on 40- instead of 150-frame batches,
# whose f32 products cuBLAS may split otherwise (rounding-level changes
# before the bf16 backbone). Relative to the output's range.
STREAM_RTOL = 1e-2

# int8 kernel vs its plain version: the same quantised values (the same f32
# amax, scale product, true division and round half to even) and exact
# integer sums on both sides, then the same two f32 products: bit for bit.
QUANT_ATOL = 0.0
# Fused block vs its plain version (same bf16 operands and rounding points):
# the kernel sums its products in another order and uses the card's rsqrtf,
# expf and tanhf, so a bf16 rounding of ln1, q, k, v, P, att, ln2 or the GELU
# output can land one bf16 step (2^-8 relative) away; one such step moves an
# O(1) output by about 2^-8 times a weight row's norm (< 0.1 here), so the
# outputs stay within 2e-2, the attention kernels' tolerance.
BLOCK_ATOL = 2e-2
# The bilinear kernel does the plain gather's f32 products and sums in its
# order without contraction (--fmad=false): bit for bit.
BILINEAR_ATOL = 0.0
BILINEAR_LIBRARY = ("torch.nn.functional.grid_sample(grid.permute(0,3,1,2), g, bilinear, "
                    "border, align_corners=True), g normalised outside the call")
# Quantised pipeline vs the bf16 one (same weights and split): int8 rounding
# of every projection's input and weight (<= 1/254 of a row's or column's
# max) through 15 layers; held as JAX holds its quantised forward against
# the unquantised one (tests/unit/test_quant.py): relative L2 on the tracks
# below 5 % and visibility decisions agreeing on more than 97 % of points.
QUANT_TRACKS_REL_L2, QUANT_VIS_AGREE = 5e-2, 0.97
# Fused-block pipeline vs the bf16 one: the block rounds its input and every
# operand to bf16 and takes other rounding points than the unfused layers in
# 8 of the 15 layers; relative to the output's range, as PIPELINE_RTOL (JAX
# holds its block stack to 5e-2 abs of O(1) outputs, tests/unit/
# test_block_kernel.py).
FUSED_BLOCK_RTOL = 5e-2

NUM_FRAMES, HEIGHT, WIDTH, GRID = 150, 512, 512, 64
DINO_GRID = (36, 36, 768)  # the extractor's grid of a 512x512 frame (resized to 504 = 36 x 14)
RUNS = 3
FORWARD_LAUNCHES = 3 + 4 + 4 + 4 + 4  # encoder, latent self, latent cross, decompress, readout
# One row norm a _Norm: 4 a layer (6 with cross-attention) + each stack's final one.
FORWARD_NORM_LAUNCHES = (3 * 4 + 1) + (4 * 6 + 1) + (4 * 4 + 1) + (4 * 4 + 1)  # 72
TAIL_BILINEAR_LAUNCHES = 3  # DINO features, the 2D->3D lift and the depth features
# The int8 products of the quantised forward (batch 1, 2048 support tracks
# of 150 frames + the readout token, 128 latents, 512 queries of 128 latents
# + the query token): (name, M, K, N, launches per forward, x dtype).
QUANT_SHAPES = [
    ("input_qkv", 2048 * 151, 384, 768, 3 * 3, torch.float32),
    ("input_out", 2048 * 151, 768, 384, 3, torch.float32),
    ("input_mlp_in", 2048 * 151, 384, 1536, 3, torch.float32),
    ("input_mlp_out", 2048 * 151, 1536, 384, 3, torch.float32),
    ("latents_q_kv", 128, 512, 768, 4 * 4, torch.float32),  # self q, k, v and cross q
    ("latents_cross_kv", 2048, 384, 768, 4 * 2, torch.float32),
    ("latents_out", 128, 768, 512, 4 * 2, torch.float32),  # self and cross
    ("latents_mlp_in", 128, 512, 2048, 4, torch.float32),
    ("latents_mlp_out", 128, 2048, 512, 4, torch.float32),
    ("decompress_qkv", 128, 1152, 768, 4 * 3, torch.float32),
    ("decompress_out", 128, 768, 1152, 4, torch.float32),
    ("decompress_mlp_in", 128, 1152, 2048, 4, torch.float32),
    ("decompress_mlp_out", 128, 2048, 1152, 4, torch.float32),
    ("readout_qkv", 512 * 129, 1280, 768, 4 * 3, torch.float32),
    ("readout_out", 512 * 129, 768, 1280, 4, torch.float32),
    ("readout_mlp_in", 512 * 129, 1280, 1536, 4, torch.float32),
    ("readout_mlp_out", 512 * 129, 1536, 1280, 4, torch.float32),
    ("readout_qkv_bf16_x", 512 * 129, 1280, 768, 0, torch.bfloat16),  # residual_dtype=bf16
    ("ragged_m", 1111, 1152, 2048, 0, torch.bfloat16),
]
QUANT_LAUNCHES = sum(shape[4] for shape in QUANT_SHAPES)  # 106
# The fused block's layers (name, items, S, C, MLP, launches per forward);
# 8 heads of 96. The other 11 attentions stay on the attention kernel.
BLOCK_HEADS, BLOCK_QKV = 8, 768
BLOCK_SHAPES = [("readout", 512, 129, 1280, 1536, 4), ("decompress", 1, 128, 1152, 2048, 4)]
BLOCK_LAUNCHES = sum(shape[5] for shape in BLOCK_SHAPES)  # 8
FUSED_BLOCK_ATTENTION_LAUNCHES = 3 + 4 + 4  # encoder, latent self, latent cross

# (name, B, S, K, H, D, key-masked, launches per forward)
MAIN_PATH_SHAPES = [
    ("encoder_self", 2048, 151, 151, 8, 96, True, 3),
    ("latents_self", 1, 128, 128, 8, 96, False, 4),
    ("latents_cross", 1, 128, 2048, 8, 96, False, 4),
    ("decompress_self", 1, 128, 128, 8, 96, False, 4),
    ("readout_self", 512, 129, 129, 8, 96, False, 4),
]
EDGE_SHAPES = [
    ("fully_masked_rows", 4, 151, 151, 8, 96, "rows", 0),
    ("ragged_k", 3, 77, 1000, 8, 96, True, 0),
    ("d64_vit_frame", 2, 1297, 1297, 12, 64, False, 0),
    ("b1_masked", 1, 151, 151, 8, 96, True, 0),
]

# The ViT backbones (DINOv2 and the depth network's, both ViT-B: 12 layers of
# 12 heads of 64) run 8-frame groups: 19 per 150-frame video, whole or in the
# pipeline's chunks of 40, 40, 40 and 30 frames (5 + 5 + 5 + 4 groups).
VIT_LAUNCHES = 19 * 12  # per backbone per video
# ``vit_residual_norm`` launches per backbone per video: three a block and the
# final norm, per 8-frame group; their MLPs launch no ``swiglu_gate``.
VIT_NORM_LAUNCHES = 19 * (3 * 12 + 1)
# (name, B, S, K, H, launches per video): DINO frames are 36x36 patches + CLS,
# the depth backbone's 37x37 + CLS; K not a multiple of the 64-key tile.
VIT_SHAPES = [
    ("dino_frames", 8, 1297, 1297, 12, VIT_LAUNCHES),
    ("vda_frames", 8, 1370, 1370, 12, VIT_LAUNCHES),
    ("ragged_k", 2, 77, 1000, 12, 0),
]

# The tracking scenes: the pipeline's width (150 frames of 512x512, a 64x64
# grid of 4096 points) with exact ground truth; the noisy one degrades the
# pixels only, so that the 'auto' policy engages the matcher.
SCENE = dict(num_frames=NUM_FRAMES, height=HEIGHT, width=WIDTH, grid_size=GRID, num_sprites=4,
             sprite_size=96)
SCENES = {"clean": dict(seed=0), "noisy": dict(seed=1, noise_sigma=16.0)}
TRACKER = dict(grid_size=GRID, fb_threshold=-1.0, iterations=3, matcher="auto")  # the pipeline's
# The JAX tracker's quality on the same two scenes:
# tdspa.features.tracks.PyramidalLKTracker(grid_size=64, fb_threshold=-1.0, iterations=3,
# matcher="auto", device="cpu") (the tdspa/ops/lk.py path, whose border arithmetic the port's
# kernel follows), measured with JAX on a host CPU. The clean scene engaged no tier, the
# noisy one the matcher alone. The port may fall short by QUALITY_SLACK.
JAX_QUALITY = {
    "clean": {"pts_within_2": 0.813, "visibility_accuracy": 0.833},
    "noisy": {"pts_within_2": 0.812, "visibility_accuracy": 0.750},
    # TIER_SCENES below, measured the same way (make_tracking_scene at SCENE's
    # size with these arguments, the JAX tracker through __call__, scored by
    # tdspa.eval.tracking_quality); the JAX tracker ran the tiers of
    # TIER_EXPECTED with the LK calls of TIER_LAUNCHES.
    "pan": {"pts_within_2": 0.8547, "visibility_accuracy": 0.8835},
    "roll": {"pts_within_2": 0.7676, "visibility_accuracy": 0.8205},
    "denoise": {"pts_within_2": 0.2240, "visibility_accuracy": 0.7078},
}
QUALITY_SLACK = 0.02
EXPECTED_TIERS = {
    "clean": {"stabilize": None, "rescue": None, "denoise": None, "matcher": None},
    "noisy": {"stabilize": None, "rescue": None, "denoise": None, "matcher": True},
}
# The 'auto' tiers at full width: a fast pan collapses LK and the cost-volume
# rescue is kept; 0.4 degrees of roll per frame (60 over the video) gates the
# stabilised re-track; heavy noise over natural texture collapses LK, the
# rescue is discarded and the re-track on blurred luma is kept.
TIER_SCENES = {
    "pan": dict(seed=3, pan=(8, 0)),
    "roll": dict(seed=2, rot_rate=float(np.deg2rad(0.4))),
    "denoise": dict(seed=0, noise_sigma=10.0, contrast=0.7, texture="natural"),
}
TIER_EXPECTED = {
    "pan": {"stabilize": None, "rescue": True, "denoise": None, "matcher": None},
    "roll": {"stabilize": True, "rescue": None, "denoise": None, "matcher": None},
    "denoise": {"stabilize": None, "rescue": False, "denoise": True, "matcher": None},
}
# LK launches per tracker call (all, and those with the cost volume) and
# matcher launches: pan = first pass + rescue; roll = first pass + the
# stabilised re-track; denoise = first pass + rescue + the blurred re-track.
TIER_LAUNCHES = {
    "pan": {"lk": 2, "lk_cost_volume": 1, "matcher": 0},
    "roll": {"lk": 2, "lk_cost_volume": 0, "matcher": 0},
    "denoise": {"lk": 3, "lk_cost_volume": 1, "matcher": 0},
}
TIER_RUNS = 2
MATCHER_LAUNCHES = 8  # (2 at M=1 + 2 at M=4) per refinement, and once more for the rescue round
CHUNK_FRAMES = 40  # InferencePipeline's upload_chunk_frames
CHUNK_LAUNCHES = -(-NUM_FRAMES // CHUNK_FRAMES)  # one LK launch per upload chunk
LK_CONFIGS = {
    "pipeline": dict(fb_threshold=-1.0, iterations=3),
    "tracker_defaults": dict(fb_threshold=2.0, iterations=4),
    "corr_rescue": dict(fb_threshold=2.0, iterations=4, corr_radius=4, corr_rescue_level=2),
    "half_res": dict(fb_threshold=2.0, iterations=4, input_scale=0.5),
}
# LK kernel vs plain version: both compute the same f32 arithmetic (the
# kernel is built without FMA contraction), but sums are taken in another
# order, and thresholded decisions (NCC, min_eig, the cost volume's argmax)
# can flip on the last bit; a flipped point follows another trajectory.
# The TPU kernel is held to its oracle at the same 0.05 px.
LK_TOL_PX, LK_MIN_SHARE = 0.05, 0.99
# Cost patches, kernel vs plain: f32 with the same corner clamps; the kernel
# forms the bilinear weights and the 16-term dot product in another order.
MATCHER_ATOL = 1e-4
# Chunked vs unchunked tracking on the card: the same kernel on the same
# frames with the positions, velocity and template carried across chunks.
CHUNK_TOL_PX = 1e-4

# The TAPVid-3D harness at full width: 16 synthetic videos, track counts drawn
# from 100-1000 with SEED (3, 3, 6 and 4 videos in the 256, 512, 768 and 1024
# buckets: forwards of 4, 4, 8 and 4 videos), 512x512 camera with given
# intrinsics, both depth scalings.
HARNESS_VIDEOS, HARNESS_BATCH, HARNESS_BUCKET = 16, 8, 256
HARNESS_TRACKS = (100, 1000)
HARNESS_INTRINSICS = (400.0, 400.0, 256.0, 256.0)
HARNESS_SCALINGS = ("median", "per_trajectory")
# Aggregated metrics, kernel vs plain attention and batched vs per video: both
# pairs' forwards differ (bf16 roundings inside the 19 attentions; the
# bottleneck dither drawn for the whole [B 128 96] latents, so a video's
# latents move by up to 1/128 with its batch), so thresholded flags flip on a
# few (point, frame) pairs; held at JAX's own batched-vs-per-video limit
# (tests/integration/test_eval_harness.py), a mean over 16 videos.
HARNESS_METRIC_ATOL = 0.02
# The realism scorer, kernel vs plain attention on one batch: the forward is
# held to PIPELINE_RTOL of the tracks' range in each coordinate; a point's
# error, a 3-D distance, moves by at most its predicted point's change, so each
# point_error and mean_error stay within sqrt(3) times that bound, and each
# score exp(-10 error) within 10 * max(score) times the error's bound.
# realism_score, relative to its own value: 1e-2, five times the 2.0e-3 of
# the first reading (2.1e-6 on 1.05e-3, NVIDIA H100 80GB HBM3, 700 W).
REALISM_SCORE_RTOL = 1e-2
# Training (phases trajan2d .. train_cli). The default 2D TRAJAN: 68,333,080
# parameters (counted from the flax init); 21 attention launches per
# unchunked forward (2 encoder + 6 x (self + cross) + 3 decompress + 4 readout).
TRAJAN_PARAMS, SPA3D_PARAMS = 68_333_080, 109_138_296
TRAJAN_FORWARD_LAUNCHES = 2 + 6 * 2 + 3 + 4
TRAIN_TRACKS, TRAIN_SUPPORT, TRAIN_QUERIES, TRAIN_BATCH = 4096, 2048, 2048, 2
TRAIN_CHUNK, TRAIN_STEPS, TRAIN_LR = 256, 3, 1e-4
# Loss of one accumulated step (2 microbatches) vs the full step: the same
# sums regrouped, but each microbatch draws the bottleneck's fixed dither for
# its own shape, as in JAX, whose test holds the two to 1e-4 relative
# (tests/unit/test_train.py).
ACCUM_LOSS_RTOL = 1e-4
# Their parameters after the update: elementwise within one bf16 step (2^-8
# relative) plus twice the step's learning rate (Adam normalises each
# gradient, so an element whose gradient is noise can move by up to the
# rate either way); and their updates (new - old parameters) within 5e-2
# relative L2 over all parameters.
ACCUM_PARAM_RTOL, ACCUM_UPDATE_REL_L2 = 2.0 ** -8, 5e-2
# First step, kernel vs plain attention (same bf16 model and batch): the
# kernel scales f32 logits by 1/sqrt(D), the plain path divides bf16 q by a
# bf16 sqrt(D) (0.15 % apart at D = 96), and both round P differently, in
# every attention of the forward and its recompute. Loss within 1e-2
# relative; gradients within 5e-2 relative L2, over all parameters and per
# parameter. bf16 compute alone moves a parameter's gradient by per cents
# from the same model's f32 gradient, so each parameter's kernel-path
# gradient is also held to the f32 one: no further from it than the plain
# bf16 path's, plus 5e-2.
PLAIN_LOSS_RTOL, PLAIN_GRAD_REL_L2 = 1e-2, 5e-2
# Resume from the step-2 checkpoint vs the uninterrupted step 3: the same
# computation on the same card, which can differ only in the order of the
# atomic adds of the backward's scatters (the time-feature gather); the two
# step-3 updates within 1e-2 relative L2.
RESUME_UPDATE_REL_L2 = 1e-2
# The train CLI's eval loss at step 2 vs the same 10 validation batches
# through its saved checkpoint here: the same f32 model and inputs on the
# same card; cuBLAS may pick another algorithm in another process.
CLI_EVAL_RTOL = 1e-4
# Attention backward kernel vs its plain version (attention_backward_reference)
# on the same inputs, per gradient: within 2e-2 of that gradient's largest
# value. The kernel rounds g and dS to bf16 as tensor-core operands, where
# the plain version keeps them f32, and sums in another order; each output
# is then rounded to bf16 (dq twice: before and after the division by
# bf16(sqrt(D))), so one or two bf16 steps (2^-8 relative each) of the
# largest element.
BACKWARD_REL_ATOL = 2e-2
# (name, B, S, K, H, D, masked) at B = 1 of the model: the 3D encoder, the
# latents' cross-attention, the readout and the 2D encoder.
BACKWARD_SHAPES = [("encoder_3d", 2048, 151, 151, 8, 96, "rows"),
                   ("latents_cross", 1, 128, 2048, 8, 96, False),
                   ("readout", 2048, 129, 129, 8, 96, False),
                   ("encoder_2d", 2048, 150, 150, 8, 64, "rows")]
# The batch rebuilt from the pipeline's tracks, features and split against
# the pipeline's own tail: the same model and kernels on the same inputs
# (bit-equal in the first reading).
REBUILT_BATCH_RTOL = 1e-6
# The matcher's training (phase matcher_train): the shipped round-4 recipe's
# widths and scenes (tdspa/features/matcher.py's __main__ with
# --natural_frac=0: cells-only scenes, the distribution the shipped asset was
# trained on; the CLI's default 0.5 is the unshipped v2 recipe), cut from its
# 4000 steps to the 1500 of JAX's train_matcher default; one scene per step,
# cycled. (On an H100, 300 steps left the last logged loss at 0.69 x the first.)
MATCHER_RECIPE = dict(dim=16, radius=4, hidden=128, stride=2, fhidden=32, bank=3)
MATCHER_ITERATIONS, MATCHER_OCCLUSION_WEIGHT, MATCHER_LR = 2, 8.0, 2e-3
MATCHER_SCENES = dict(num_frames=24, height=128, width=192, grid_size=10,
                      rot_rate_max=float(np.deg2rad(2.5)), deform_amp_max=5.0, natural_frac=0.0)
MATCHER_NUM_SCENES, MATCHER_STEPS, MATCHER_RECIPE_STEPS, MATCHER_LOG_EVERY = 48, 1500, 4000, 100
# The card against the port on the CPU: the first MATCHER_CPU_STEPS steps
# from one initialisation with the same perturbations. The losses are f32
# sums over the same values in another order on each device: 1e-4 relative.
# The parameters: Adam moves an element whose gradient is rounding noise by
# up to the step's rate either way, so within twice the sum of the steps'
# rates (0 at step 0, under the warmup).
MATCHER_CPU_STEPS, MATCHER_CPU_LOSS_RTOL = 3, 1e-4
# JAX's own check of the training (tests/unit/test_matcher.py::
# test_training_descends): the last logged loss below 0.6 x the first.
MATCHER_DESCENT = 0.6
# The exported tails (phase export): the default, quantised and fused-block
# configurations of the pipeline phase's model, split and inputs; launches
# per call, as the eager tail makes them.
EXPORT_CONFIGS = {
    "default": {"attention": FORWARD_LAUNCHES, "bilinear": TAIL_BILINEAR_LAUNCHES,
                "quant_matmul": 0, "block": 0},
    "quantize": {"attention": FORWARD_LAUNCHES, "bilinear": TAIL_BILINEAR_LAUNCHES,
                 "quant_matmul": QUANT_LAUNCHES, "block": 0},
    "fused_block": {"attention": FUSED_BLOCK_ATTENTION_LAUNCHES,
                    "bilinear": TAIL_BILINEAR_LAUNCHES, "quant_matmul": 0,
                    "block": BLOCK_LAUNCHES},
}
# An exported program against the eager tail (or forward) on the same
# parameters and inputs: the same ops and kernels in the same order, so
# bit-equal is expected; held to 1e-5 of each output's range.
EXPORT_RTOL = 1e-5
# The sharded train step on a one-rank group against the single-device step:
# the same shapes and kernels (bit-equal expected), held to JAX's sharded-step
# tolerances (tests/dist/test_sharding.py: loss rtol 1e-5, parameters 1e-5).
MESH_STEP_TOL = dict(loss_rtol=1e-5, param_atol=1e-5)
# The visualizer's projection on the card against the CPU's: the same f32
# elementwise ops in one order (bit-equal expected); 1e-4 px.
VIZ_PROJECTION_ATOL = 1e-4


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls replayed from one CUDA
    graph, so host overhead between small launches does not count."""
    fn()  # warm: builds, allocator, library handles
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> dict:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's GPU path cannot run here",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    global SMS
    SMS = torch.cuda.get_device_properties(0).multi_processor_count
    info = {
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
    }
    emit("device", **info)
    return info


def ptxas_report(log: str) -> list[dict]:
    """Each kernel of one library as ``nvcc -Xptxas -v`` reports it: registers
    per thread, static shared memory (dynamic shared memory is set at launch)
    and spills."""
    rows, current = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = {"kernel": line.split("'")[1]}
            rows.append(current)
        elif current is not None and "spill stores" in line:
            for value, what in re.findall(r"(\d+) bytes (stack frame|spill stores|spill loads)",
                                          line):
                current[what.replace(" ", "_") + "_bytes"] = int(value)
        elif current is not None and re.search(r"Used \d+ registers", line):
            current["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            current["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    names = [row["kernel"] for row in rows]
    try:  # readable names where the toolchain's demangler is present
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True,
                             timeout=60, check=True).stdout.splitlines()
        if len(out) == len(names):
            for row, name in zip(rows, out):
                row["kernel"] = name.removeprefix("void ").replace(
                    "(anonymous namespace)::", "").split("(")[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return rows


def phase_build() -> None:
    t0 = time.perf_counter()
    seconds = build.build_all()
    emit("build", wall_s=time.perf_counter() - t0, per_source_s=seconds)
    for name in build.KERNELS:
        log = (build.BUILD_DIR / f"{name}.log").read_text()
        # ptxas's "Potential Performance Loss" notes (e.g. C7515, C7518: wgmma
        # serialised) and the compiler's warnings, by code.
        notes = re.findall(r"\((C\d+)\) Potential Performance Loss", log)
        emit("build_report", library=name, kernels=ptxas_report(log),
             performance_notes={code: notes.count(code) for code in sorted(set(notes))},
             warnings=[line.strip()[:200] for line in log.splitlines()
                       if "warning" in line.lower()][:8])


def attention_inputs(gen, batch, seq, kv_len, heads, depth, masked):
    dev = "cuda"
    q, k, v = (
        torch.randn((batch, n, heads, depth), generator=gen, device=dev).to(torch.bfloat16)
        for n in (seq, kv_len, kv_len)
    )
    mask = None
    if masked:
        mask = torch.rand((batch, kv_len), generator=gen, device=dev) < 0.8
        mask[:, 0] = True  # the readout key
        if masked == "rows":
            mask[0] = False  # item 0: every key masked -> mean of its values
            mask[2, : kv_len // 2] = False
    return q, k, v, mask


def attention_bound(batch, seq, kv_len, heads, depth, masked, out_bytes):
    """Least time for the function: bytes (inputs once, output once) vs flops."""
    nbytes = 2 * heads * depth * batch * (seq + 2 * kv_len) + out_bytes * batch * seq * heads * depth
    if masked:
        nbytes += batch * kv_len  # bool mask
    flops = 4.0 * batch * heads * seq * kv_len * depth
    return nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3


def compare_attention(phase, kernel, fields, q, k, v, mask, library_ms) -> dict:
    """One attention kernel against ``attention_reference`` on the same bf16
    inputs, in both output dtypes: error against the tolerance, kernel,
    plain and bound times. Emits a row per dtype, raises on disagreement;
    returns {out_dtype: (row, bytes_ms, flops_ms)}."""
    batch, seq, heads, depth = q.shape
    kv_len = k.shape[1]
    rows = {}
    for out_dtype in (torch.float32, torch.bfloat16):
        got = kernel(q, k, v, mask, out_dtype=out_dtype)
        torch.cuda.synchronize()
        want = attention_reference(q, k, v, mask, out_dtype=out_dtype)
        err = (got.float() - want.float()).abs()
        rtol = KERNEL_RTOL_BF16_OUT if out_dtype == torch.bfloat16 else 0.0
        excess = (err - KERNEL_ATOL - rtol * want.float().abs()).max().item()
        finite = bool(torch.isfinite(got).all().item())
        out_bytes = 4 if out_dtype == torch.float32 else 2
        bytes_ms, flops_ms = attention_bound(batch, seq, kv_len, heads, depth, mask is not None,
                                             out_bytes)
        bound_ms = max(bytes_ms, flops_ms)
        ms = cuda_ms(lambda: kernel(q, k, v, mask, out_dtype=out_dtype), iters=20)
        plain_ms = cuda_ms(lambda: attention_reference(q, k, v, mask, out_dtype=out_dtype), iters=5)
        row = dict(
            **fields, B=batch, S=seq, K=kv_len, H=heads, D=depth,
            out_dtype=str(out_dtype).removeprefix("torch."),
            max_abs_err=err.max().item(), atol=KERNEL_ATOL, rtol=rtol, finite=finite,
            ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound_ms, bound_by="bytes" if bytes_ms >= flops_ms else "operations",
            roofline_share=bound_ms / ms,
        )
        emit(phase, **row)
        if not finite or excess > 0:
            raise AssertionError(f"{phase}: kernel disagrees with its plain version: {row}")
        rows[out_dtype] = (row, bytes_ms, flops_ms)
        del got, want, err
    return rows


def add_per_run(totals: dict, rows: dict, count: int, out_dtype=torch.float32) -> None:
    """Add ``count`` launches' worth of a shape's row (f32 output unless
    ``out_dtype`` says otherwise) to ``totals``."""
    row, bytes_ms, flops_ms = rows[out_dtype]
    totals["max_abs_err"] = max(totals["max_abs_err"], row["max_abs_err"])
    for key, value in (("ms", row["ms"]), ("plain_ms", row["plain_ms"]),
                       ("library_ms", row["library_ms"]), ("bytes_ms", bytes_ms),
                       ("flops_ms", flops_ms)):
        totals[key] += count * value


def new_totals() -> dict:
    return {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
            "bytes_ms": 0.0, "flops_ms": 0.0}


def phase_kernel() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    totals, bf16_totals = new_totals(), new_totals()
    for name, batch, seq, kv_len, heads, depth, masked, per_forward in MAIN_PATH_SHAPES + EDGE_SHAPES:
        q, k, v, mask = attention_inputs(gen, batch, seq, kv_len, heads, depth, masked)
        # SDPA's layout is [B, H, S, D]; an additive mask keeps fully masked
        # rows uniform as in the kernel.
        add_mask = None
        if mask is not None:
            add_mask = torch.zeros(mask.shape, device="cuda", dtype=torch.bfloat16)
            add_mask.masked_fill_(~mask, torch.finfo(torch.bfloat16).min)
            add_mask = add_mask[:, None, None, :]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        # Which shape a fault belongs to: the line comes before the library's
        # timing, and each kernel comparison ends in a synchronise, so a fault
        # of csrc/attention.cu is reported at its own shape.
        emit("kernel", shape=name)
        library_ms = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=add_mask),
            iters=10,
        )
        plan = work_plan(batch, seq, kv_len, heads, SMS)
        rows = compare_attention("kernel", fused_masked_attention,
                                 dict(shape=name, masked=bool(masked), work_items=plan["work"],
                                      grid=plan["grid"], key_chunks=plan["chunks"],
                                      cuda_kernels_per_call=plan["cuda_kernels"]),
                                 q, k, v, mask, library_ms)
        torch.cuda.synchronize()
        totals.setdefault("shape_ms", {})[name] = {
            str(dt).removeprefix("torch."): rows[dt][0]["ms"] for dt in rows}
        if per_forward:
            # One forward's attention work (the pipeline's residual stream is f32;
            # the bf16-output total is the like-for-like comparison with SDPA).
            add_per_run(totals, rows, per_forward)
            add_per_run(bf16_totals, rows, per_forward, torch.bfloat16)
        if name == "fully_masked_rows":
            # Item 0 attends to nothing: the kernel returns the mean of its values.
            mean_v = v[0].float().mean(dim=0)  # [H, D]
            got = fused_masked_attention(q, k, v, mask)[0]
            torch.cuda.synchronize()
            dev = (got - mean_v[None]).abs().max().item()
            emit("kernel_fully_masked_mean", max_abs_dev=dev, atol=KERNEL_ATOL)
            if dev > KERNEL_ATOL:
                raise AssertionError(f"fully masked rows are not the mean of V: {dev}")
        del q, k, v, mask, add_mask, qt, kt, vt
        torch.cuda.empty_cache()
    emit("kernel_totals", per="one forward: the 19 launches at their main-path shapes",
         f32_out_ms=totals["ms"], bf16_out_ms=bf16_totals["ms"], sdpa_ms=totals["library_ms"],
         f32_out_bound_ms=max(totals["bytes_ms"], totals["flops_ms"]),
         bf16_out_bound_ms=max(bf16_totals["bytes_ms"], bf16_totals["flops_ms"]),
         max_abs_err=max(totals["max_abs_err"], bf16_totals["max_abs_err"]))
    totals["bf16_out_ms"] = bf16_totals["ms"]
    return totals


def phase_vit_kernel() -> dict:
    """The maskless ViT kernel (``csrc/vit_attention.cu``) against
    ``attention_reference`` at the DINO and depth backbones' frame shapes and
    a ragged one; SDPA timed on the same inputs as a yardstick."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    totals = new_totals()
    for name, batch, seq, kv_len, heads, per_video in VIT_SHAPES:
        q, k, v, _ = attention_inputs(gen, batch, seq, kv_len, heads, VIT_HEAD, False)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        emit("vit_attention_kernel", shape=name)  # as in phase_kernel
        library_ms = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt), iters=10)
        rows = compare_attention(
            "vit_attention_kernel", lambda q, k, v, mask, out_dtype: vit_attention(q, k, v, out_dtype),
            dict(shape=name, per_video=per_video), q, k, v, None, library_ms)
        torch.cuda.synchronize()
        if per_video:
            add_per_run(totals, rows, per_video)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return totals


class SeededProviders:
    """Front ends made from a seed on the card: moving tracks on a 64x64 grid,
    a DINO patch grid and positive depth maps."""

    def __init__(self, seed: int):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        dev = "cuda"
        step = HEIGHT / GRID
        coords = (torch.arange(GRID, device=dev, dtype=torch.float32) + 0.5) * step
        gy, gx = torch.meshgrid(coords, coords, indexing="ij")
        start = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)  # [N 2]
        n = start.shape[0]
        t = torch.arange(NUM_FRAMES, device=dev, dtype=torch.float32)[None, :, None]
        velocity = torch.randn((n, 1, 2), generator=gen, device=dev) * 0.5
        wobble = torch.rand((n, 1, 2), generator=gen, device=dev) * 2 * math.pi
        tracks = start[:, None, :] + velocity * t + 3.0 * torch.sin(t / 10.0 + wobble)
        self.tracks = tracks.clamp(0, WIDTH - 1)
        self.visible = (torch.rand((n, NUM_FRAMES, 1), generator=gen, device=dev) < 0.9).float()
        self.dino = torch.randn((NUM_FRAMES,) + DINO_GRID, generator=gen, device=dev)
        self.depth = 1.0 + 4.0 * torch.rand((NUM_FRAMES, HEIGHT, WIDTH, 1), generator=gen, device=dev)

    def track(self, video):
        return {"tracks": self.tracks, "visible": self.visible}

    def dino_grid(self, video):
        return self.dino

    def depth_maps(self, video, fps: float = 30.0):
        return self.depth


def phase_pipeline() -> dict:
    providers = SeededProviders(SEED)
    video = np.random.default_rng(SEED).integers(
        0, 256, (NUM_FRAMES, HEIGHT, WIDTH, 3), dtype=np.uint8
    )

    def pipeline(model=None):
        return InferencePipeline(
            num_output_frames=NUM_FRAMES, use_dino=True, use_depth=True,
            track_provider=providers.track, dino_extractor=providers.dino_grid,
            depth_provider=providers.depth_maps, model=model, seed=SEED, device="cuda",
        )

    pipe = pipeline()
    params = sum(p.numel() for p in pipe.model.parameters())
    fused_masked_attention.launches = 0
    bilinear_kernel.launches = 0
    norm_lib.row_norm.launches = 0
    tails, results = [], None
    for _ in range(RUNS):
        results = pipe.run_on_frames(video)
        tails.append(results["timings"]["fused_tail"] * 1e3)
    launches = fused_masked_attention.launches
    bilinear_launches = bilinear_kernel.launches
    norm_launches = norm_lib.row_norm.launches
    preds = results["predictions"]
    shapes = {
        "tracks": list(preds.tracks.shape),
        "visible_logits": list(preds.visible_logits.shape),
        "tracks_3d": list(results["tracks_3d"].shape),
        "support_tracks": list(results["support_tracks"].shape),
        "query_tracks": list(results["query_tracks"].shape),
    }
    finite = bool(torch.isfinite(preds.tracks).all() and torch.isfinite(preds.visible_logits).all())
    emit("pipeline", params=params, runs=RUNS, launches=launches,
         launches_per_forward=launches / RUNS, bilinear_launches=bilinear_launches,
         norm_launches=norm_launches, shapes=shapes, finite=finite,
         fused_tail_ms=tails, fused_tail_median_ms=statistics.median(tails[1:]),
         timings_ms={k: v * 1e3 for k, v in results["timings"].items()},
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    expected = {
        "tracks": [1, 512, NUM_FRAMES, 3], "visible_logits": [1, 512, NUM_FRAMES, 1],
        "tracks_3d": [GRID * GRID, NUM_FRAMES, 3], "support_tracks": [2048, NUM_FRAMES, 3],
        "query_tracks": [512, NUM_FRAMES, 3],
    }
    if shapes != expected or not finite:
        raise AssertionError(f"pipeline output wrong: {shapes} finite={finite}")
    if launches != FORWARD_LAUNCHES * RUNS or bilinear_launches != TAIL_BILINEAR_LAUNCHES * RUNS \
            or norm_launches != FORWARD_NORM_LAUNCHES * RUNS:
        raise AssertionError(
            f"attention kernel launched {launches} times, bilinear kernel "
            f"{bilinear_launches} times and row-norm kernel {norm_launches} times in {RUNS} "
            f"forwards, expected {FORWARD_LAUNCHES * RUNS}, {TAIL_BILINEAR_LAUNCHES * RUNS} and "
            f"{FORWARD_NORM_LAUNCHES * RUNS}"
        )

    # Same weights, same split, plain attention (the kernel is off).
    plain_model = TrackAutoEncoder3D(num_output_frames=NUM_FRAMES, dtype=torch.bfloat16,
                                     fused_attention=False, device="cuda")
    plain_model.load_state_dict(pipe.model.state_dict())
    before = fused_masked_attention.launches
    plain_pipe = pipeline(plain_model)
    plain_tails = []
    for _ in range(2):  # the first run warms up, as in the kernel pipeline's runs
        plain = plain_pipe.run_on_frames(video)
        plain_tails.append(plain["timings"]["fused_tail"] * 1e3)
    if fused_masked_attention.launches != before:
        raise AssertionError("the plain pipeline launched the fused kernel")
    agreement = {}
    for name in ("tracks", "visible_logits"):
        a = getattr(preds, name).float()
        b = getattr(plain["predictions"], name).float()
        scale = b.abs().max().item()
        agreement[name] = {
            "max_abs_err": (a - b).abs().max().item(),
            "mean_abs_err": (a - b).abs().mean().item(),
            "ref_max_abs": scale,
            "rel_err": (a - b).abs().max().item() / scale,
            "rtol": PIPELINE_RTOL,
        }
    emit("pipeline_vs_plain", plain_fused_tail_ms=plain_tails, agreement=agreement)
    bad = {k: v for k, v in agreement.items() if not v["rel_err"] <= PIPELINE_RTOL}
    if bad:
        raise AssertionError(f"kernel and plain pipelines disagree: {bad}")
    return {"launches": launches, "bilinear_launches": bilinear_launches,
            "norm_launches": norm_launches, "pipeline": pipe,
            "video": video, "providers": providers, "predictions": preds,
            "fused_tail_median_ms": statistics.median(tails[1:])}


def timed_once(fn):
    """(result, device ms) of one call of ``fn`` between two CUDA events: for
    a plain version that takes seconds and allocates as it goes."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def make_scenes() -> dict:
    t0 = time.perf_counter()
    scenes = {}
    for name, kw in SCENES.items():
        video, gt_tracks, gt_visible = make_tracking_scene(**SCENE, **kw)
        scenes[name] = {"video": video, "gt_tracks": gt_tracks, "gt_visible": gt_visible}
    emit("scenes", seconds=time.perf_counter() - t0, shape=list(scenes["clean"]["video"].shape),
         points=int(scenes["clean"]["gt_tracks"].shape[0]),
         true_occluded_share={k: float(1 - v["gt_visible"][:, 1:].mean()) for k, v in scenes.items()})
    return scenes


def lk_bound(prep, num_points: int) -> tuple[float, float]:
    """(bytes ms, operations ms) of one LK launch: the pyramid, template
    frames and per-point inputs read once, tracks/visibility/velocity written
    once; the f32 operations the configuration does per point and frame pair
    (S = 15 per bilinear sample: 4 weights, 8 products, 3 sums)."""
    k = prep.window * prep.window
    pairs = prep.pyramid[0].shape[0] - 1
    levels = len(prep.pyramid)
    nbytes = 4 * (sum(p.numel() for p in prep.pyramid) + prep.template.numel()
                  + (prep.template_rescue.numel() if prep.rescue_level else 0)
                  + num_points * (6 + pairs * 3 + 3 + 2))
    s = 15
    prepare = k * (5 * s + 2 + 6) + 20  # patch + two central differences, normal matrix, solve
    step = k * (s + 1 + 4) + 10  # sample, residual, two products and sums, update
    ncc = 15 * k + 5  # weighted means, centred products, the quotient
    pair = levels * prepare + levels * prep.iterations * step
    per_pair = pair
    if prep.fb_threshold > -1:
        per_pair += pair
    if prep.ncc_threshold > -1 or prep.template_ncc_threshold > -1:
        per_pair += s * k  # the tracked window
    if prep.ncc_threshold > -1:
        per_pair += s * k + ncc
    if prep.template_ncc_threshold > -1:
        per_pair += ncc
    if prep.corr_radius:
        cands = (2 * prep.corr_radius + 1) ** 2
        volumes = 2 if prep.rescue_level else 1
        per_pair += volumes * (cands * k * (2 * s + 8) + prep.corr_iterations * step)
        per_pair += (1 + volumes) * (s * k + ncc)  # template scores of the estimate and candidates
    flops = num_points * pairs * per_pair + num_points * k * s * (1 + (prep.rescue_level > 0))
    return nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3


def lk_chunk_launches(video, queries, cfg) -> tuple[list, torch.Tensor]:
    """The LK launches ``PyramidalLKTracker.track_chunks`` makes on one video
    in the pipeline's upload chunks (frames 0-39, 39-79, 79-119, 119-149):
    each chunk after the first starts at the previous one's last frame, with
    the positions, the velocity prior and the frame-0 template carried
    across. Returns each launch's inputs and the chained tracks [N T 2]."""
    template = to_gray(video[:1])[0]
    pos, vel = queries, torch.zeros_like(queries)
    launches, tracks = [], []
    for start in range(0, video.shape[0], CHUNK_FRAMES):
        first = max(start - 1, 0)
        prep = lk_kernel.prepare_launch(video[first:start + CHUNK_FRAMES], pos,
                                        template_frame=template, template_pos=queries,
                                        init_velocity=vel, **cfg)
        chunk_tracks, _, vel = lk_kernel.launch(prep)
        tracks.append(chunk_tracks[:, start - first:])
        pos = chunk_tracks[:, -1]
        launches.append(prep)
    return launches, torch.cat(tracks, dim=1)


def phase_lk_kernel(scene) -> dict:
    """The LK kernel against its plain version in the four configurations,
    one 150-frame launch each; in the pipeline's configuration also the
    video as the streamed pipeline tracks it, in four chunk launches."""
    video = torch.from_numpy(scene["video"]).cuda()
    queries = torch.as_tensor(make_query_grid(HEIGHT, WIDTH, GRID), device="cuda")
    rows = {}
    for name, cfg in LK_CONFIGS.items():
        prep = lk_kernel.prepare_launch(video, queries, **cfg)
        tracks, vis, _ = lk_kernel.launch(prep)
        got_tracks, got_vis = lk_kernel.plain.finish_outputs(
            tracks, vis, torch.zeros_like(prep.queries), cfg.get("input_scale", 1.0), False)
        (want_tracks, want_vis), plain_ms = timed_once(lambda: track_video_lk(video, queries, **cfg))
        err = (got_tracks - want_tracks).abs().amax(-1)
        within = (err <= LK_TOL_PX).float().mean().item()
        vis_agree = (got_vis == want_vis).float().mean().item()
        ms = cuda_ms(lambda: lk_kernel.launch(prep), iters=3)
        bytes_ms, flops_ms = lk_bound(prep, queries.shape[0])
        row = dict(config=name, **{k: v for k, v in cfg.items()}, max_abs_err=err.max().item(),
                   share_within_tol=within, tol_px=LK_TOL_PX, visibility_agreement=vis_agree,
                   visible_share=got_vis.mean().item(), levels=len(prep.pyramid),
                   ms=ms, plain_ms=plain_ms,
                   bound_ms=max(bytes_ms, flops_ms),
                   bound_by="bytes" if bytes_ms >= flops_ms else "operations",
                   bytes_ms=bytes_ms, flops_ms=flops_ms, library_ms=None,
                   library="no single PyTorch call computes it")
        row["bound_share"] = row["bound_ms"] / ms
        if name == "pipeline":
            chunks, chained = lk_chunk_launches(video, queries, cfg)
            chunk_err = (chained - tracks).abs().max().item()
            bounds = [lk_bound(c, queries.shape[0]) for c in chunks]
            video_bytes_ms = sum(b[0] for b in bounds)
            video_flops_ms = sum(b[1] for b in bounds)
            video_ms = cuda_ms(lambda: [lk_kernel.launch(c) for c in chunks], iters=3)
            row.update(video_ms=video_ms, video_launches=len(chunks),
                       chunk_frames=[c.pyramid[0].shape[0] for c in chunks],
                       video_bound_ms=max(video_bytes_ms, video_flops_ms),
                       video_bound_by="bytes" if video_bytes_ms >= video_flops_ms else "operations",
                       chunked_vs_whole_max_px=chunk_err, chunk_tol_px=CHUNK_TOL_PX)
            row["video_bound_share"] = row["video_bound_ms"] / video_ms
            rows["tracks"] = got_tracks
            del chunks, chained
        emit("lk_kernel", **row)
        if within < LK_MIN_SHARE or vis_agree < LK_MIN_SHARE:
            raise AssertionError(f"LK kernel disagrees with its plain version: {row}")
        if name == "pipeline" and not (row["chunked_vs_whole_max_px"] <= CHUNK_TOL_PX
                                       and row["video_launches"] == CHUNK_LAUNCHES):
            raise AssertionError(f"LK chunk launches differ from one 150-frame launch: {row}")
        rows[name] = row
        del prep, tracks, vis
    torch.cuda.empty_cache()
    return rows


def matcher_bound(feats, num_points: int, templates: int, radius: int) -> tuple[float, float]:
    """(bytes ms, operations ms): the feature map, templates and positions
    read once and the costs written once; per cost entry the D-channel
    bilinear blend (8 D) and the M dot products (2 D M)."""
    t, hf, wf, dim = feats.shape
    k2 = (2 * radius + 1) ** 2
    nbytes = 4 * (feats.numel() + num_points * templates * dim + num_points * t * 2
                  + num_points * t * templates * k2)
    flops = num_points * t * k2 * (8 * dim + 2 * dim * templates)
    return nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3


def phase_matcher_kernel(scene, lk_tracks) -> dict:
    """The matcher's cost patches at the pipeline's shapes: the shipped
    matcher's feature map of the scene, positions from the LK tracks, the
    frame-0 template (M=1) and a bank of four (M=4: frames 0, 50, 100, 149)."""
    video = torch.from_numpy(scene["video"]).cuda()
    matcher = matcher_lib.matcher_params_from_flax(matcher_lib.load_matcher("default"), "cuda")
    with torch.inference_mode():
        feats = matcher_lib.compute_features(matcher, video)  # [T Hf Wf D]
        fpos = matcher_lib.img_to_feat(lk_tracks, matcher.stride)
        sampled = bilinear_sample(feats, fpos)  # [N T D]
        bank = sampled[:, [0, NUM_FRAMES // 3, 2 * NUM_FRAMES // 3, NUM_FRAMES - 1]].contiguous()
    rows = {}
    for m, tvecs in ((1, bank[:, :1].contiguous()), (4, bank)):
        got = cost_patches_multi(feats, tvecs, fpos, matcher.radius)
        want, plain_ms = timed_once(
            lambda: cost_patches_reference(feats, tvecs, fpos, matcher.radius))
        err = (got - want).abs().max().item()
        finite = bool(torch.isfinite(got).all().item())
        del want
        ms = cuda_ms(lambda: cost_patches_multi(feats, tvecs, fpos, matcher.radius), iters=5)
        bytes_ms, flops_ms = matcher_bound(feats, fpos.shape[0], m, matcher.radius)
        row = dict(templates=m, feats=list(feats.shape), points=fpos.shape[0],
                   out=list(got.shape), max_abs_err=err, atol=MATCHER_ATOL, finite=finite,
                   ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, flops_ms),
                   bound_by="bytes" if bytes_ms >= flops_ms else "operations",
                   bytes_ms=bytes_ms, flops_ms=flops_ms, library_ms=None,
                   library="no single PyTorch call computes it")
        row["bound_share"] = row["bound_ms"] / ms
        emit("matcher_kernel", **row)
        if not finite or err > MATCHER_ATOL:
            raise AssertionError(f"cost-patch kernel disagrees with its plain version: {row}")
        rows[m] = row
        del got
    del feats, sampled, bank
    torch.cuda.empty_cache()
    return rows


def _quality(out, scene) -> dict:
    q = tracking_quality({"tracks": out["tracks"].cpu().numpy(),
                          "visible": out["visible"].cpu().numpy()},
                         scene["gt_tracks"], scene["gt_visible"])
    return {k: q[k] for k in ("pts_within_2", "visibility_accuracy", "occlusion_recall",
                              "epe_both_visible")}


def _check_quality(name: str, quality: dict, what: str) -> None:
    for key, ref in JAX_QUALITY[name].items():
        if not quality[key] >= ref - QUALITY_SLACK:
            raise AssertionError(f"{what}: {key} {quality[key]:.4f} below the JAX tracker's "
                                 f"{ref} - {QUALITY_SLACK} on the {name} scene")


def phase_tracking(scenes) -> None:
    """The pipeline's default tracker through __call__ on both scenes."""
    for name in ("clean", "noisy"):
        scene = scenes[name]
        video = torch.from_numpy(scene["video"]).cuda()
        tracker = PyramidalLKTracker(**TRACKER)
        lk_kernel.track_video_lk_kernel.launches = 0
        cost_patches_multi.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tracker(video)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"lk": lk_kernel.track_video_lk_kernel.launches,
                    "matcher": cost_patches_multi.launches}
        quality = _quality(out, scene)
        row = dict(scene=name, tiers=tracker.tiers, launches=launches, seconds=seconds,
                   quality=quality, jax_quality=JAX_QUALITY[name],
                   degradation=matcher_lib.estimate_degradation(video))
        if name == "noisy":
            plain = PyramidalLKTracker(**dict(TRACKER, matcher=None))(video)
            row["quality_without_matcher"] = _quality(plain, scene)
        emit("tracking", **row)
        want_launches = {"lk": 1, "matcher": MATCHER_LAUNCHES if name == "noisy" else 0}
        if tracker.tiers != EXPECTED_TIERS[name] or launches != want_launches:
            raise AssertionError(f"tracker on the {name} scene: tiers {tracker.tiers}, launches "
                                 f"{launches}; expected {EXPECTED_TIERS[name]}, {want_launches}")
        _check_quality(name, quality, "tracker")


def phase_pipeline_tracked(scenes) -> dict:
    """run_on_frames with the default tracker: streamed, YUV 4:2:0, chunked."""
    providers = SeededProviders(SEED)
    pipe = InferencePipeline(
        num_output_frames=NUM_FRAMES, tracking_grid_size=GRID, dino_extractor=providers.dino_grid,
        depth_provider=providers.depth_maps, seed=SEED, device="cuda",
    )
    tracker = pipe.track_provider
    captured = {}
    track_chunks = tracker.track_chunks

    def recording(chunks):  # keeps the chunked output and the video it tracked
        out = track_chunks(chunks)
        captured.update(out, video=torch.cat(chunks, dim=0))
        return out

    tracker.track_chunks = recording
    clean = scenes["clean"]
    t0 = time.perf_counter()
    rgb_to_yuv420(clean["video"])
    yuv_encode_s = time.perf_counter() - t0
    lk_kernel.track_video_lk_kernel.launches = 0
    cost_patches_multi.launches = 0
    timings = []
    for _ in range(RUNS):
        results = pipe.run_on_frames(clean["video"])
        timings.append({k: v * 1e3 for k, v in results["timings"].items()})
    launches = {"lk": lk_kernel.track_video_lk_kernel.launches,
                "matcher": cost_patches_multi.launches}
    clean_tiers = dict(tracker.tiers)
    preds = results["predictions"]
    finite = bool(torch.isfinite(preds.tracks).all() and torch.isfinite(preds.visible_logits).all())
    single = PyramidalLKTracker(**TRACKER)(captured["video"])
    chunk_err = (captured["tracks"] - single["tracks"]).abs().max().item()
    chunk_vis_equal = bool(torch.equal(captured["visible"], single["visible"]))
    quality = _quality(captured, clean)
    streamed = "upload_tracking_features" in results["timings"]
    emit("pipeline_tracked", scene="clean", runs=RUNS, launches=launches, tiers=clean_tiers,
         streamed=streamed, timings_ms=timings,
         upload_tracking_features_median_ms=statistics.median(
             t["upload_tracking_features"] for t in timings[1:]),
         fused_tail_median_ms=statistics.median(t["fused_tail"] for t in timings[1:]),
         yuv_encode_host_ms=yuv_encode_s * 1e3, chunked_vs_unchunked_max_px=chunk_err,
         chunked_visible_equal=chunk_vis_equal, tol_px=CHUNK_TOL_PX, quality=quality,
         jax_quality=JAX_QUALITY["clean"], predictions=list(preds.tracks.shape), finite=finite)
    if not streamed or launches != {"lk": CHUNK_LAUNCHES * RUNS, "matcher": 0}:
        raise AssertionError(f"tracked pipeline: streamed={streamed}, launches {launches}; "
                             f"expected {CHUNK_LAUNCHES * RUNS} LK launches and no matcher")
    if clean_tiers != EXPECTED_TIERS["clean"] or not finite:
        raise AssertionError(f"tracked pipeline: tiers {clean_tiers}, finite={finite}")
    if not chunk_err <= CHUNK_TOL_PX or not chunk_vis_equal:
        raise AssertionError(f"chunked tracks differ from one call by {chunk_err} px "
                             f"(visibility equal: {chunk_vis_equal})")
    _check_quality("clean", quality, "tracked pipeline")

    noisy = scenes["noisy"]
    lk_kernel.track_video_lk_kernel.launches = 0
    cost_patches_multi.launches = 0
    noisy_results = pipe.run_on_frames(noisy["video"])
    noisy_launches = {"lk": lk_kernel.track_video_lk_kernel.launches,
                      "matcher": cost_patches_multi.launches}
    noisy_quality = _quality(captured, noisy)
    emit("pipeline_tracked", scene="noisy", launches=noisy_launches, tiers=dict(tracker.tiers),
         timings_ms={k: v * 1e3 for k, v in noisy_results["timings"].items()},
         quality=noisy_quality, jax_quality=JAX_QUALITY["noisy"])
    if noisy_launches != {"lk": CHUNK_LAUNCHES, "matcher": MATCHER_LAUNCHES} or \
            tracker.tiers != EXPECTED_TIERS["noisy"]:
        raise AssertionError(f"tracked pipeline on the noisy scene: launches {noisy_launches}, "
                             f"tiers {tracker.tiers}")
    _check_quality("noisy", noisy_quality, "tracked pipeline")
    return {"pipeline": pipe, "video": clean["video"], "lk_launches": noisy_launches["lk"],
            "matcher_launches": noisy_launches["matcher"], "runs": RUNS}


def _rel_err(got, want) -> dict:
    diff = (got.float() - want.float()).abs()
    scale = want.float().abs().max().item()
    return {"max_abs_err": diff.max().item(), "mean_abs_err": diff.mean().item(),
            "ref_max_abs": scale, "rel_err": diff.max().item() / scale}


def _timed_call(fn, *args):
    """(result, wall ms) of one call, synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_features(scene) -> dict:
    """DINOv2 features and video depth at full width (ViT-B, seeded weights)
    on the clean scene's whole video: the ViT attention kernel's and the ViT
    row kernel's launches, output shapes, depth finite and >= 0, and
    agreement with the same extractor on plain attention; stage times (the
    second of two calls). The plain extractors run the same row kernels
    (``vit_residual_norm``: the norms, bias adds, layer scales and residual
    sums), so that comparison checks the attention alone; phase
    vit_block_kernel holds the row kernel to its plain version at both
    backbones' shapes."""
    video = torch.from_numpy(scene["video"]).cuda()
    dino = DinoFeatureExtractor(device="cuda", seed=SEED)
    dino_plain = DinoFeatureExtractor(device="cuda", seed=SEED, fused_attention=False)
    dino_plain.model.load_state_dict(dino.model.state_dict())
    depth = VideoDepthEstimator(device="cuda", seed=SEED)
    depth.init_params()
    depth_plain = VideoDepthEstimator(device="cuda", params=depth.params, fused_attention=False)
    expected = {"dino": [NUM_FRAMES, *DINO_GRID], "depth": [NUM_FRAMES, HEIGHT, WIDTH, 1]}
    rows = {}
    for name, kernel, plain in (("dino", dino, dino_plain), ("depth", depth, depth_plain)):
        _timed_call(kernel, video)  # warm: library handles and algorithm choices
        vit_attention.launches = 0
        vit_block.vit_residual_norm.launches = vit_block.swiglu_gate.launches = 0
        out, ms = _timed_call(kernel, video)
        launches = vit_attention.launches
        block_launches = {"vit_residual_norm": vit_block.vit_residual_norm.launches,
                          "swiglu_gate": vit_block.swiglu_gate.launches}
        _timed_call(plain, video)
        want, plain_ms = _timed_call(plain, video)
        if vit_attention.launches != launches:
            raise AssertionError(f"the plain {name} extractor launched the ViT kernel")
        finite = bool(torch.isfinite(out).all().item())
        row = dict(stage=name, shape=list(out.shape), dtype=str(out.dtype).removeprefix("torch."),
                   launches=launches, block_launches=block_launches, ms=ms, plain_ms=plain_ms,
                   finite=finite, min=out.min().item(), max=out.max().item(),
                   vs_plain=dict(_rel_err(out, want), rtol=FEATURES_RTOL))
        emit("features", **row)
        if row["shape"] != expected[name] or not finite or launches != VIT_LAUNCHES \
                or block_launches != {"vit_residual_norm": VIT_NORM_LAUNCHES, "swiglu_gate": 0}:
            raise AssertionError(f"{name} features wrong: {row}")
        if name == "depth" and row["min"] < 0:
            raise AssertionError(f"negative depth: {row}")
        if not row["vs_plain"]["rel_err"] <= FEATURES_RTOL:
            raise AssertionError(f"{name}: kernel and plain attention disagree: {row}")
        rows[name] = row
        del out, want
    del dino, dino_plain, depth, depth_plain, video
    torch.cuda.empty_cache()
    return rows


def phase_pipeline_full(scene) -> dict:
    """``InferencePipeline()`` with no front end passed in: tracking, DINO and
    depth built by the pipeline and streamed per 40-frame chunk, then the
    tail. Launches per run, streamed features against one whole-video call of
    the same extractors, tracking quality, timings."""
    pipe = InferencePipeline(num_output_frames=NUM_FRAMES, tracking_grid_size=GRID, seed=SEED,
                             device="cuda")
    tracker = pipe.track_provider
    captured = {}
    track_chunks = tracker.track_chunks

    def recording(chunks):  # keeps the tracks and the video the stages saw
        out = track_chunks(chunks)
        captured.update(out, video=torch.cat(chunks, dim=0))
        return out

    tracker.track_chunks = recording
    counters = _pipeline_counters()
    for fn in counters.values():
        fn.launches = 0
    timings = []
    for _ in range(RUNS):
        results = pipe.run_on_frames(scene["video"])
        timings.append({k: v * 1e3 for k, v in results["timings"].items()})
    launches = {name: fn.launches for name, fn in counters.items()}
    per_run = {"vit_attention": 2 * VIT_LAUNCHES, "vit_residual_norm": 2 * VIT_NORM_LAUNCHES,
               "swiglu_gate": 0, "attention": FORWARD_LAUNCHES,
               "bilinear": TAIL_BILINEAR_LAUNCHES, "lk": CHUNK_LAUNCHES, "matcher": 0}
    preds = results["predictions"]
    shapes = {"dino_grid": list(results["dino_grid"].shape), "depth": list(results["depth"].shape),
              "tracks": list(preds.tracks.shape), "visible_logits": list(preds.visible_logits.shape)}
    finite = bool(torch.isfinite(preds.tracks).all() and torch.isfinite(preds.visible_logits).all()
                  and torch.isfinite(results["dino_grid"]).all()
                  and torch.isfinite(results["depth"]).all())
    depth_min = results["depth"].min().item()
    with torch.inference_mode():
        whole = {"dino_grid": pipe.dino_extractor(captured["video"]),
                 "depth": pipe.depth_provider(captured["video"])}
    stream = {k: dict(_rel_err(results[k], whole[k]), rtol=STREAM_RTOL) for k in whole}
    quality = _quality(captured, scene)
    with tempfile.TemporaryDirectory() as out_dir:  # the reference's output files
        save_results(results, out_dir)
        with np.load(os.path.join(out_dir, "predictions.npz")) as saved:
            saved_shapes = {k: list(saved[k].shape) for k in saved.files}
    emit("pipeline_full", scene="clean", runs=RUNS, launches=launches,
         launches_per_run={k: v / RUNS for k, v in launches.items()}, tiers=dict(tracker.tiers),
         shapes=shapes, finite=finite, depth_min=depth_min, streamed_vs_whole=stream,
         quality=quality, jax_quality=JAX_QUALITY["clean"], saved=saved_shapes, timings_ms=timings,
         upload_tracking_features_median_ms=statistics.median(
             t["upload_tracking_features"] for t in timings[1:]),
         fused_tail_median_ms=statistics.median(t["fused_tail"] for t in timings[1:]),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    expected_shapes = {"dino_grid": [NUM_FRAMES, *DINO_GRID], "depth": [NUM_FRAMES, HEIGHT, WIDTH, 1],
                       "tracks": [1, 512, NUM_FRAMES, 3], "visible_logits": [1, 512, NUM_FRAMES, 1]}
    expected_saved = {"tracks_3d": [512, NUM_FRAMES, 3], "visible_logits": [512, NUM_FRAMES, 1],
                      "query_tracks": [512, NUM_FRAMES, 3], "support_tracks": [2048, NUM_FRAMES, 3]}
    if shapes != expected_shapes or saved_shapes != expected_saved or not finite or depth_min < 0:
        raise AssertionError(f"full pipeline output wrong: {shapes}, saved {saved_shapes}, "
                             f"finite={finite}, depth min {depth_min}")
    if launches != {k: v * RUNS for k, v in per_run.items()}:
        raise AssertionError(f"full pipeline launches {launches} in {RUNS} runs; expected "
                             f"{per_run} per run")
    bad = {k: v for k, v in stream.items() if not v["rel_err"] <= STREAM_RTOL}
    if bad:
        raise AssertionError(f"streamed features differ from the whole-video call: {bad}")
    _check_quality("clean", quality, "full pipeline")
    tracker.track_chunks = track_chunks
    # What the last run's tail took in, for the realism phase.
    tail_inputs = {"tracks": captured["tracks"], "visible": captured["visible"],
                   "dino_grid": results["dino_grid"], "depth": results["depth"],
                   "predictions": preds}
    del whole, results, captured
    return {"pipeline": pipe, "launches": launches, "timings": timings, "tail_inputs": tail_inputs,
            "video": scene["video"]}


def _lk_counts() -> dict:
    lk = lk_kernel.track_video_lk_kernel
    return {"lk": lk.launches, "lk_cost_volume": lk.cost_volume_launches,
            "matcher": cost_patches_multi.launches}


def phase_tracking_tiers() -> dict:
    """The pipeline's default tracker on the scenes that engage the rescue,
    roll-stabilise and denoise tiers at full width: tiers, LK launches by
    configuration, matcher launches, seconds per call, quality against the
    ground truth and the JAX tracker's."""
    rows = {}
    for name, kw in TIER_SCENES.items():
        t0 = time.perf_counter()
        video_np, gt_tracks, gt_visible = make_tracking_scene(**SCENE, **kw)
        scene_s = time.perf_counter() - t0
        video = torch.from_numpy(video_np).cuda()
        tracker = PyramidalLKTracker(**TRACKER)
        lk_kernel.track_video_lk_kernel.launches = 0
        lk_kernel.track_video_lk_kernel.cost_volume_launches = 0
        cost_patches_multi.launches = 0
        seconds, tiers = [], []
        for _ in range(TIER_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = tracker(video)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            tiers.append(dict(tracker.tiers))
        launches = _lk_counts()
        quality = _quality(out, {"gt_tracks": gt_tracks, "gt_visible": gt_visible})
        want_launches = {k: v * TIER_RUNS for k, v in TIER_LAUNCHES[name].items()}
        row = dict(scene=name, scene_args=kw, scene_seconds=scene_s, tiers=tiers[-1],
                   expected_tiers=TIER_EXPECTED[name], runs=TIER_RUNS, launches=launches,
                   expected_launches=want_launches, seconds=seconds, quality=quality,
                   jax_quality=JAX_QUALITY[name], true_occluded_share=float(1 - gt_visible[:, 1:].mean()),
                   noise_sigma=matcher_lib.estimate_degradation(video)["noise_sigma"])
        emit("tracking_tiers", **row)
        if any(t != TIER_EXPECTED[name] for t in tiers) or launches != want_launches:
            raise AssertionError(f"tracker on the {name} scene: tiers {tiers}, launches {launches}; "
                                 f"expected {TIER_EXPECTED[name]}, {want_launches}")
        _check_quality(name, quality, "tracker")
        rows[name] = row
        del video, out
    torch.cuda.empty_cache()
    return rows


def phase_realism(full, viz_dir: str) -> dict:
    """``score_tracks`` on the batch the full pipeline's tail gave its model
    (rebuilt from the pipeline's tracks, features and split), with the fused
    kernel and with plain attention; ``save_visualization_npz``'s contract."""
    pipe, inputs = full["pipeline"], full["tail_inputs"]
    num_tracks = inputs["tracks"].shape[0]
    num_support, num_queries = pipe.num_support_tracks, pipe.num_query_points
    perm, ts = pipe.split_indices(num_tracks, num_queries, NUM_FRAMES)
    with torch.inference_mode():
        preds, batch, _ = fused_tail(
            pipe.model, inputs["tracks"], inputs["visible"], inputs["dino_grid"], inputs["depth"],
            perm, ts, num_support, num_queries, (HEIGHT, WIDTH))
    same_as_pipeline = _rel_err(preds.tracks, inputs["predictions"].tracks)
    if not same_as_pipeline["rel_err"] <= REBUILT_BATCH_RTOL:
        raise AssertionError(f"realism: the rebuilt batch is not the pipeline's tail batch: "
                             f"{same_as_pipeline} > {REBUILT_BATCH_RTOL}")
    plain_model = TrackAutoEncoder3D(num_output_frames=NUM_FRAMES, dtype=torch.bfloat16,
                                     fused_attention=False, device="cuda")
    plain_model.load_state_dict(pipe.model.state_dict())
    score_tracks(pipe.model, None, batch)  # warm
    fused_masked_attention.launches = 0
    got, ms = _timed_call(score_tracks, pipe.model, None, batch)
    launches = fused_masked_attention.launches
    want, plain_ms = _timed_call(score_tracks, plain_model, None, batch)
    if fused_masked_attention.launches != launches:
        raise AssertionError("the plain scorer launched the fused kernel")
    with torch.inference_mode():
        plain_preds = plain_model(batch)
    forward_vs_plain = {name: _rel_err(getattr(preds, name), getattr(plain_preds, name))
                        for name in ("tracks", "visible_logits")}
    error_bound = math.sqrt(3.0) * PIPELINE_RTOL * plain_preds.tracks.abs().max().item()
    score_gap = np.abs(got["coords_score"] - want["coords_score"])
    score_limit = 10.0 * np.maximum(got["coords_score"], want["coords_score"]) * error_bound
    diffs = {"realism_score": abs(got["realism_score"] - want["realism_score"]),
             "mean_error": abs(got["mean_error"] - want["mean_error"]),
             "point_error": float(np.abs(got["point_error"] - want["point_error"]).max()),
             "coords_score_outside_limit": int((score_gap > score_limit).sum())}
    limits = {"realism_score": REALISM_SCORE_RTOL * abs(want["realism_score"]),
              "mean_error": error_bound, "point_error": error_bound, "coords_score_outside_limit": 0}
    path = os.path.join(viz_dir, "viz.npz")  # phase visualize's input
    coords = preds.tracks[0].transpose(0, 1)  # [T Q 3]
    save_visualization_npz(path, coords, got["coords_score"], full["video"],
                           visibs=batch["query_tracks_visible"][0, ..., 0].transpose(0, 1))
    with np.load(path) as saved:
        saved_shapes = {k: list(saved[k].shape) for k in saved.files}
        saved_dtypes = sorted({str(saved[k].dtype) for k in saved.files})
    expected_saved = {"coords": [NUM_FRAMES, num_queries, 3],
                      "coords_score": [NUM_FRAMES, num_queries],
                      "video": [NUM_FRAMES, 3, HEIGHT, WIDTH], "intrinsics": [3, 3],
                      "extrinsics": [4, 4], "visibs": [NUM_FRAMES, num_queries]}
    shapes = {k: list(np.shape(got[k])) for k in ("coords_score", "point_error")}
    emit("realism", launches=launches, ms=ms, plain_ms=plain_ms, batch_tracks_vs_pipeline=same_as_pipeline,
         forward_vs_plain=forward_vs_plain,
         kernel={k: got[k] for k in ("realism_score", "mean_error", "visible_agreement")},
         plain={k: want[k] for k in ("realism_score", "mean_error", "visible_agreement")},
         diffs=diffs, limits=limits, shapes=shapes, saved=saved_shapes, saved_dtypes=saved_dtypes)
    if launches != FORWARD_LAUNCHES or shapes != {"coords_score": [NUM_FRAMES, num_queries],
                                                  "point_error": [num_queries, NUM_FRAMES]}:
        raise AssertionError(f"realism: {launches} attention launches, shapes {shapes}")
    if not all(np.isfinite(got[k]) for k in ("realism_score", "mean_error")):
        raise AssertionError(f"realism: non-finite scores {got['realism_score'], got['mean_error']}")
    bad = {k: v for k, v in forward_vs_plain.items() if not v["rel_err"] <= PIPELINE_RTOL}
    if bad:
        raise AssertionError(f"realism forward, kernel vs plain attention: {bad} > {PIPELINE_RTOL}")
    if any(not diffs[k] <= limits[k] for k in diffs):
        raise AssertionError(f"realism: kernel and plain scorers disagree: {diffs} > {limits}")
    if saved_shapes != expected_saved or saved_dtypes != ["float32"]:
        raise AssertionError(f"visualization file: {saved_shapes} {saved_dtypes}")
    del plain_model, plain_preds, batch, preds
    torch.cuda.empty_cache()
    return {"launches": launches, "ms": ms, "plain_ms": plain_ms, "viz_path": path}


def phase_visualize(viz_path: str) -> dict:
    """The port's visualize CLI on phase realism's visualization npz: the
    mp4's frame count and size; the card's projection of the tracks against
    the CPU's (VIZ_PROJECTION_ATOL)."""
    from tdspa_torch.cli import visualize as visualize_cli
    from tdspa_torch.ops.geometry import project_all_tracks
    from tdspa_torch.viz.paint import load_visualization_data
    import cv2

    out, cli_ms = _timed_call(visualize_cli.main, [f"--npz_path={viz_path}", "--device=cuda"])
    cap = cv2.VideoCapture(str(out))
    frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    size = [int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)), int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))]
    cap.release()
    data = load_visualization_data(viz_path)
    _, _, height, width = data["video"].shape
    projected = {}
    for device in ("cuda", "cpu"):
        coords = torch.as_tensor(data["coords"], device=device)
        projected[device], ms = _timed_call(lambda: project_all_tracks(
            coords, data["intrinsics"], data["extrinsics"], original_height=height,
            original_width=width))
        projected[f"{device}_ms"] = ms
    err = (projected["cuda"].cpu() - projected["cpu"]).abs().max().item()
    row = dict(cli_ms=cli_ms, mp4_frames=frames, mp4_size=size, points=data["coords"].shape[1],
               projection_max_abs_px=err, atol_px=VIZ_PROJECTION_ATOL,
               projection_cuda_ms=projected["cuda_ms"], projection_cpu_ms=projected["cpu_ms"],
               finite=bool(torch.isfinite(projected["cuda"]).all()))
    emit("visualize", **row)
    if frames != NUM_FRAMES or size != [WIDTH, HEIGHT] or not err <= VIZ_PROJECTION_ATOL \
            or not row["finite"]:
        raise AssertionError(f"visualize: {row}")
    return row


def phase_debug_nans(path) -> dict:
    """The full-width default tail (phase pipeline's model, split and inputs)
    under the NaN check: clean, it raises nothing; with a NaN in one DINO
    feature it raises FloatingPointError naming the operator; with the check
    off it equals phase pipeline's outputs."""
    from tdspa_torch.utils.profiling import debug_nans

    providers, pipe = path["providers"], path["pipeline"]
    perm, ts = pipe.split_indices(GRID * GRID, 512, NUM_FRAMES)
    inputs = [providers.tracks, providers.visible, providers.dino, providers.depth]
    split = (perm, ts, 2048, 512, (HEIGHT, WIDTH))
    rows = {}
    with torch.inference_mode():
        (off, _, _), rows["off_ms"] = _timed_call(fused_tail, pipe.model, *inputs, *split)
        with debug_nans():
            (on, _, _), rows["on_clean_ms"] = _timed_call(fused_tail, pipe.model, *inputs,
                                                         *split)
        # One DINO feature: channel 0 of the patch cell under track 0's first
        # position.
        x, y = (providers.tracks[0, 0] * torch.tensor(
            [DINO_GRID[1] / WIDTH, DINO_GRID[0] / HEIGHT], device="cuda")).floor().long().tolist()
        inputs[2] = providers.dino.clone()
        inputs[2][0, y, x, 0] = float("nan")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with debug_nans():
                fused_tail(pipe.model, *inputs, *split)
            raised = "nothing raised"
        except FloatingPointError as err:
            raised = str(err)
        rows["on_nan_ms_to_raise"] = (time.perf_counter() - t0) * 1e3
    want = path["predictions"]
    rows["off_vs_pipeline"] = {k: _rel_err(getattr(off, k), getattr(want, k))
                               for k in ("tracks", "visible_logits")}
    rows["on_vs_off_max_abs"] = max((getattr(on, k) - getattr(off, k)).abs().max().item()
                                    for k in ("tracks", "visible_logits"))
    rows["raised"] = raised
    emit("debug_nans", rtol=EXPORT_RTOL, **rows)
    if "tdspa.bilinear_sample" not in raised or rows["on_vs_off_max_abs"] != 0.0 \
            or any(v["rel_err"] > EXPORT_RTOL for v in rows["off_vs_pipeline"].values()):
        raise AssertionError(f"debug_nans: {rows}")
    return rows


def phase_mesh(batch_3d) -> dict:
    """The multi-GPU paths on a one-rank NCCL group (a FileStore in a
    temporary directory): one sharded 3DSPA train step at phase train_3d's
    batch against the single-device step; make_mesh_tail in the three
    serving configurations against fused_tail with their launches per call;
    the mesh export round trip against the live mesh tail. The group is
    destroyed at the end, also on failure."""
    import torch.distributed as dist

    from tdspa_torch.parallel.mesh import make_mesh, replicate
    from tdspa_torch.parallel.shardings import shard_batch
    from tdspa_torch.infer.pipeline import make_mesh_tail

    emit("mesh", note="one GPU: a one-rank group; multi-GPU speed is not measured")
    counters = {"attention": fused_masked_attention, "bilinear": bilinear_kernel,
                "quant_matmul": qmm.quant_matmul, "block": fused_transformer_block}
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            mesh = make_mesh()
            # The train step: single-device, then sharded, from one start.
            overrides = dict(dtype=torch.bfloat16, fused_attention=True,
                             encoder_scan_chunk_size=TRAIN_CHUNK,
                             decoder_scan_chunk_size=TRAIN_CHUNK)
            state, model, optimizer, schedule = create_model_state(
                SEED, model_type="3dspa", learning_rate=TRAIN_LR, warmup_steps=1,
                total_steps=100 * TRAIN_STEPS, num_output_frames=NUM_FRAMES, device="cuda",
                **overrides)
            start = _clone(state.params)
            (single, single_metrics), single_ms = _timed_call(
                make_train_step(model, optimizer, schedule), state, batch_3d)
            single_params = _clone(single.params)
            state, model, optimizer, schedule = create_model_state(
                SEED, model_type="3dspa", learning_rate=TRAIN_LR, warmup_steps=1,
                total_steps=100 * TRAIN_STEPS, num_output_frames=NUM_FRAMES, device="cuda",
                **overrides)
            replicate(list(state.params.values()), mesh)
            same_start = all(torch.equal(state.params[k], v) for k, v in start.items())
            local = shard_batch(mesh, batch_3d)
            fused_masked_attention.launches = attention_backward.launches = 0
            (sharded, sharded_metrics), sharded_ms = _timed_call(
                make_train_step(model, optimizer, schedule, mesh=mesh), state, local)
            step_launches = fused_masked_attention.launches
            rows["train_step"] = dict(
                single_ms=single_ms, sharded_ms=sharded_ms, same_start=same_start,
                launches=step_launches, backward_launches=attention_backward.launches,
                single_loss=single_metrics["train/loss"].item(),
                sharded_loss=sharded_metrics["train/loss"].item(),
                param_max_abs_diff=max((sharded.params[k] - v).abs().max().item()
                                       for k, v in single_params.items()))
            del state, model, optimizer, single, sharded, single_params, start, local
            torch.cuda.empty_cache()

            # The serving tails on phase pipeline's seeded inputs and model.
            providers = SeededProviders(SEED)
            pipe = InferencePipeline(num_output_frames=NUM_FRAMES, seed=SEED, device="cuda")
            base = pipe.model
            perm, ts = pipe.split_indices(GRID * GRID, 512, NUM_FRAMES)
            inputs = (providers.tracks, providers.visible, providers.dino, providers.depth)
            split = (2048, 512, (HEIGHT, WIDTH))
            live = None
            for knob, expected in EXPORT_CONFIGS.items():
                model = base
                if knob != "default":
                    model = TrackAutoEncoder3D(num_output_frames=NUM_FRAMES,
                                               dtype=torch.bfloat16, fused_attention=True,
                                               device="cuda", **{knob: True})
                    model.load_state_dict(base.state_dict())
                tail = make_mesh_tail(mesh, model, *split)
                row = {}
                with torch.inference_mode():
                    for name, fn in (("fused_tail", lambda: fused_tail(model, *inputs, perm, ts,
                                                                       *split)),
                                     ("mesh_tail", lambda: tail(*inputs, perm, ts))):
                        fn()  # warm
                        for c in counters.values():
                            c.launches = 0
                        out, ms = _timed_call(fn)
                        row[f"{name}_ms"] = ms
                        row[f"{name}_launches"] = {k: c.launches for k, c in counters.items()}
                        row[name] = out
                want, got = row.pop("fused_tail"), row.pop("mesh_tail")
                row["vs_fused_tail"] = {
                    **{k: _rel_err(getattr(got[0], k), getattr(want[0], k))
                       for k in ("tracks", "visible_logits")},
                    "tracks_3d": _rel_err(got[2], want[2])}
                row["bit_equal"] = all(torch.equal(getattr(got[0], k), getattr(want[0], k))
                                       for k in ("tracks", "visible_logits")) \
                    and torch.equal(got[2], want[2])
                row["expected_launches"] = expected
                rows[f"tail_{knob}"] = row
                if knob == "default":
                    live = {"tracks": got[0].tracks, "visible_logits": got[0].visible_logits,
                            "tracks_3d": got[2]}
                del model, tail, want, got
                torch.cuda.empty_cache()

            # The mesh export round trip (default configuration).
            t0 = time.perf_counter()
            program = export_lib.export_mesh_tail(mesh, base, *split, num_tracks=GRID * GRID,
                                                  num_frames=NUM_FRAMES)
            export_s = time.perf_counter() - t0
            file = os.path.join(tmp, "mesh_tail.pt2")
            manifest = export_lib.save_exported(program, file)
            loaded = export_lib.load_exported_mesh(file)
            params = export_lib.serving_params(base)
            with torch.inference_mode():
                export_lib.call_exported_mesh(loaded, mesh, params, perm, ts, *inputs)  # warm
                for c in counters.values():
                    c.launches = 0
                out, call_ms = _timed_call(export_lib.call_exported_mesh, loaded, mesh, params,
                                           perm, ts, *inputs)
            rows["export"] = dict(
                export_s=export_s, graph_nodes=len(program.graph.nodes),
                artifact_bytes=manifest["bytes"], nr_devices=manifest["nr_devices"],
                call_ms=call_ms, launches={k: c.launches for k, c in counters.items()},
                bit_equal={k: torch.equal(out[k], v) for k, v in live.items()})
            del program, loaded, out, live, base, pipe, providers
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    emit("mesh", **rows)
    problems = []
    step = rows["train_step"]
    if not step["same_start"] or not math.isclose(step["sharded_loss"], step["single_loss"],
                                                  rel_tol=MESH_STEP_TOL["loss_rtol"]) \
            or not step["param_max_abs_diff"] <= MESH_STEP_TOL["param_atol"]:
        problems.append(f"train step {step}")
    for knob, expected in EXPORT_CONFIGS.items():
        row = rows[f"tail_{knob}"]
        if row["mesh_tail_launches"] != expected or row["fused_tail_launches"] != expected \
                or any(v["rel_err"] > EXPORT_RTOL for v in row["vs_fused_tail"].values()):
            problems.append(f"tail {knob}: {row}")
    if rows["export"]["launches"] != EXPORT_CONFIGS["default"] \
            or not all(rows["export"]["bit_equal"].values()) or rows["export"]["nr_devices"] != 1:
        problems.append(f"export {rows['export']}")
    if problems:
        raise AssertionError(f"mesh: {problems}")
    return {"train_step_launches": step["launches"],
            "train_step_backward_launches": step["backward_launches"],
            **{f"tail_{k}": rows[f"tail_{k}"]["mesh_tail_launches"] for k in EXPORT_CONFIGS},
            "export": rows["export"]["launches"]}


def _pipeline_counters() -> dict:
    return {"vit_attention": vit_attention, "vit_residual_norm": vit_block.vit_residual_norm,
            "swiglu_gate": vit_block.swiglu_gate, "attention": fused_masked_attention,
            "bilinear": bilinear_kernel, "lk": lk_kernel.track_video_lk_kernel,
            "matcher": cost_patches_multi}


def phase_video_entry(scene, full) -> dict:
    """The clean scene as an mp4 file through ``run_inference`` and the infer
    CLI, on the card, with their launches and the reference's output files."""
    counters = _pipeline_counters()
    per_run = {"vit_attention": 2 * VIT_LAUNCHES, "vit_residual_norm": 2 * VIT_NORM_LAUNCHES,
               "swiglu_gate": 0, "attention": FORWARD_LAUNCHES,
               "bilinear": TAIL_BILINEAR_LAUNCHES, "lk": CHUNK_LAUNCHES}
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "clean.mp4")
        t0 = time.perf_counter()
        save_video(scene["video"], path)
        save_s = time.perf_counter() - t0
        ckpt = os.path.join(tmp, "seeded_3dspa.npz")  # the flat a/b/c layout
        np.savez(ckpt, **{k.replace(".", "/"): v.float().cpu().numpy()
                          for k, v in full["pipeline"].model.state_dict().items()})
        out_dir = os.path.join(tmp, "out")
        runs = {
            "run_inference": lambda: run_inference(
                path, None, num_output_frames=NUM_FRAMES, tracking_grid_size=GRID, seed=SEED,
                device="cuda"),
            "cli": lambda: infer_cli.main([
                f"--video_path={path}", f"--checkpoint_path={ckpt}", f"--output_dir={out_dir}",
                f"--num_output_frames={NUM_FRAMES}", f"--tracking_grid_size={GRID}",
                f"--seed={SEED}", "--device=cuda"]),
        }
        for name, run in runs.items():
            for fn in counters.values():
                fn.launches = 0
            results, wall_ms = _timed_call(run)
            launches = {k: fn.launches for k, fn in counters.items()}
            preds = results["predictions"]
            finite = bool(torch.isfinite(preds.tracks).all() and torch.isfinite(preds.visible_logits).all())
            row = dict(entry=name, file_bytes=os.path.getsize(path), save_video_s=save_s,
                       frames=list(results["video"].shape), fps=results["fps"], wall_ms=wall_ms,
                       launches=launches, expected_launches=per_run, finite=finite,
                       shape=list(preds.tracks.shape),
                       timings_ms={k: v * 1e3 for k, v in results["timings"].items()})
            if name == "cli":
                with np.load(os.path.join(out_dir, "predictions.npz")) as saved:
                    row["saved"] = {k: list(saved[k].shape) for k in saved.files}
                with open(os.path.join(out_dir, "video_info.txt")) as f:
                    row["video_info"] = f.read().splitlines()
            emit("video_entry", **row)
            if {k: launches[k] for k in per_run} != per_run or not finite:
                raise AssertionError(f"video entry {name}: launches {launches}, expected {per_run} "
                                     f"per run; finite={finite}")
            if row["frames"] != [NUM_FRAMES, HEIGHT, WIDTH, 3] or row["shape"] != [1, 512, NUM_FRAMES, 3]:
                raise AssertionError(f"video entry {name}: frames {row['frames']}, output {row['shape']}")
            if name == "cli" and (row["saved"] != {
                    "tracks_3d": [512, NUM_FRAMES, 3], "visible_logits": [512, NUM_FRAMES, 1],
                    "query_tracks": [512, NUM_FRAMES, 3], "support_tracks": [2048, NUM_FRAMES, 3]}
                    or row["video_info"][1:] != [f"Frames: {NUM_FRAMES}", "Query points: 512"]):
                raise AssertionError(f"infer CLI output files wrong: {row}")
            rows[name] = launches
            del results, preds
            torch.cuda.empty_cache()
    return rows


def _harness_examples(directory) -> list:
    """HARNESS_VIDEOS synthetic videos in the TAPVid-3D npz layout, written
    to ``directory`` and read back through ``NpzDirectoryProvider``: smooth
    3D tracks in front of the camera, occlusion spans, (x, y, t) queries
    projected through the given intrinsics."""
    rng = np.random.default_rng(SEED)
    counts = rng.integers(HARNESS_TRACKS[0], HARNESS_TRACKS[1] + 1, HARNESS_VIDEOS)
    fx, fy, cx, cy = HARNESS_INTRINSICS
    t = np.arange(NUM_FRAMES, dtype=np.float64)[None, :, None] / NUM_FRAMES
    for i, n in enumerate(counts):
        start = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), rng.uniform(3, 8, n)], -1)
        drift = rng.normal(0, 0.5, (n, 1, 3))
        wobble = 0.2 * np.sin(2 * np.pi * (t * rng.uniform(1, 3, (n, 1, 3))
                                           + rng.uniform(0, 1, (n, 1, 3))))
        xyz = start[:, None] + drift * t + wobble
        xyz[..., 2] = np.maximum(xyz[..., 2], 1.0)
        visible = np.ones((n, NUM_FRAMES), bool)
        gaps = rng.integers(0, NUM_FRAMES, (n, 2))
        for j in range(n):  # one occlusion span per track
            lo, hi = sorted(gaps[j])
            visible[j, lo:hi] = rng.uniform() < 0.5
        qt = rng.integers(0, NUM_FRAMES, n)
        at_q = xyz[np.arange(n), qt]
        visible[np.arange(n), qt] = True
        queries = np.stack([fx * at_q[:, 0] / at_q[:, 2] + cx, fy * at_q[:, 1] / at_q[:, 2] + cy,
                            qt.astype(np.float64)], -1)
        np.savez(os.path.join(directory, f"video_{i:02d}.npz"),
                 tracks_XYZ=xyz.astype(np.float32), visibility=visible.astype(np.float32),
                 queries_xyt=queries.astype(np.float32),
                 fx_fy_cx_cy=np.array(HARNESS_INTRINSICS, np.float32))
    return list(NpzDirectoryProvider(directory)), counts


def _harness_forwards(counts) -> list[tuple[int, int]]:
    """(batch, bucket) of every forward ``evaluate_model`` makes: full groups
    of HARNESS_BATCH, the rest padded to the next power of two."""
    buckets = -(-np.asarray(counts) // HARNESS_BUCKET) * HARNESS_BUCKET
    forwards = []
    for bucket in sorted(set(buckets.tolist())):
        videos = int((buckets == bucket).sum())
        forwards += [(HARNESS_BATCH, bucket)] * (videos // HARNESS_BATCH)
        if videos % HARNESS_BATCH:
            forwards.append((min(1 << (videos % HARNESS_BATCH - 1).bit_length(), HARNESS_BATCH),
                             bucket))
    return forwards


def _metric_diffs(a: dict, b: dict) -> dict:
    """Largest absolute difference of the mean metrics, per scaling."""
    return {s: max(abs(a[s][k] - b[s][k]) for k in a[s] if not k.endswith("_std")) for s in a}


class _WarningRecords(logging.Handler):
    """The messages of every warning a logger gives while attached."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def phase_eval_harness() -> dict:
    """``evaluate_model`` at full width with the pipeline's model (bf16, the
    fused kernel) passed through ``model=`` and with plain attention,
    ``evaluate_video`` per video, and ``evaluate_model`` with the harness's
    default model (JAX's: f32, plain attention; it launches no kernel)."""
    model = TrackAutoEncoder3D(num_output_frames=NUM_FRAMES, use_dino=True, use_depth=True,
                               dtype=torch.bfloat16, fused_attention=True, device="cuda")
    plain = TrackAutoEncoder3D(num_output_frames=NUM_FRAMES, use_dino=True, use_depth=True,
                               dtype=torch.bfloat16, fused_attention=False, device="cuda")
    plain.load_state_dict(model.state_dict())
    run = dict(num_output_frames=NUM_FRAMES, depth_scalings=HARNESS_SCALINGS,
               track_bucket=HARNESS_BUCKET, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        examples, counts = _harness_examples(tmp)
    forwards = _harness_forwards(counts)
    buckets = sorted({b for _, b in forwards})
    warnings = _WarningRecords()
    logging.getLogger(harness.__name__).addHandler(warnings)
    fused_masked_attention.launches = 0
    batched, wall_ms = _timed_call(lambda: harness.evaluate_model(
        None, examples, batch_size=HARNESS_BATCH, model=model, **run))
    launches = fused_masked_attention.launches
    per_video, per_video_ms = _timed_call(lambda: harness.aggregate_metrics(
        [harness.evaluate_video(None, ex, model=model, **run) for ex in examples],
        HARNESS_SCALINGS))
    per_video_launches = fused_masked_attention.launches - launches
    plain_batched, plain_ms = _timed_call(lambda: harness.evaluate_model(
        None, examples, batch_size=HARNESS_BATCH, model=plain, **run))
    default_batched, default_ms = _timed_call(lambda: harness.evaluate_model(
        None, examples, batch_size=HARNESS_BATCH, **run))
    if fused_masked_attention.launches != launches + per_video_launches:
        raise AssertionError("the plain or default harness launched the fused kernel")
    # Every batched forward's shape, kernel against plain attention.
    forward_vs_plain = []
    for b, n in forwards:
        group = [ex for ex in examples
                 if -(-ex["tracks_3d"].shape[0] // HARNESS_BUCKET) * HARNESS_BUCKET == n][:b]
        parts = [harness.build_eval_batch(ex, NUM_FRAMES, HARNESS_BUCKET)[0] for ex in group]
        stacked = {k: torch.cat([p[k] for p in parts] + [parts[-1][k]] * (b - len(parts)), dim=0)
                   for k in parts[0]}
        _, got = harness.evaluate_batch(None, stacked, NUM_FRAMES, model=model, device="cuda")
        _, want = harness.evaluate_batch(None, stacked, NUM_FRAMES, model=plain, device="cuda")
        forward_vs_plain.append(dict(batch=b, bucket=n, rtol=PIPELINE_RTOL, **{
            name: _rel_err(getattr(got, name), getattr(want, name))
            for name in ("tracks", "visible_logits")}))
        del got, want, stacked
    logging.getLogger(harness.__name__).removeHandler(warnings)
    plans = []
    for b, n in sorted(set(forwards)):
        for name, items, seq, kv_len, masked, per_forward in (
                ("encoder_self", b * n, 151, 151, True, 3), ("latents_self", b, 128, 128, False, 4),
                ("latents_cross", b, 128, n, False, 4), ("decompress_self", b, 128, 128, False, 4),
                ("readout_self", b * n, 129, 129, False, 4)):
            plan = work_plan(items, seq, kv_len, 8, SMS)
            plans.append(dict(batch=b, bucket=n, shape=name, B=items, S=seq, K=kv_len,
                              masked=masked, per_forward=per_forward, work_items=plan["work"],
                              grid=plan["grid"], key_chunks=plan["chunks"],
                              cuda_kernels_per_call=plan["cuda_kernels"]))
    kernel_vs_plain = _metric_diffs(batched, plain_batched)
    batched_vs_per_video = _metric_diffs(batched, per_video)
    runs = {"kernel": batched, "per_video": per_video, "plain": plain_batched,
            "default": default_batched}
    occlusion_accuracy = {name: {s: m[s]["occlusion_accuracy"] for s in m} for name, m in runs.items()}
    row = dict(videos=HARNESS_VIDEOS, track_counts=counts.tolist(), buckets=buckets,
               forwards=[{"batch": b, "bucket": n} for b, n in forwards], launches=launches,
               expected_launches=FORWARD_LAUNCHES * len(forwards),
               launches_per_forward=launches / len(forwards),
               per_video_launches=per_video_launches, wall_ms=wall_ms,
               wall_ms_per_video=wall_ms / HARNESS_VIDEOS, per_video_wall_ms=per_video_ms,
               plain_wall_ms=plain_ms, default_model_wall_ms=default_ms, metrics=batched,
               plain_metrics=plain_batched, per_video_metrics=per_video,
               default_model_metrics=default_batched, kernel_vs_plain_max_diff=kernel_vs_plain,
               batched_vs_per_video_max_diff=batched_vs_per_video, metric_atol=HARNESS_METRIC_ATOL,
               # A reading of bf16 against f32 numerics, not a check.
               default_vs_kernel_max_diff=_metric_diffs(default_batched, batched),
               occlusion_accuracy=occlusion_accuracy, harness_warnings=warnings.messages,
               forward_vs_plain=forward_vs_plain, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit("eval_harness", **row)
    for plan in plans:
        emit("eval_harness_work_plan", **plan)
    if buckets != [256, 512, 768, 1024] or HARNESS_BATCH not in {b for b, _ in forwards}:
        raise AssertionError(f"harness data gives buckets {buckets}, forwards {forwards}")
    if launches != FORWARD_LAUNCHES * len(forwards) or per_video_launches != FORWARD_LAUNCHES * HARNESS_VIDEOS:
        raise AssertionError(f"harness: {launches} attention launches over {len(forwards)} forwards "
                             f"and {per_video_launches} per video")
    finite = all(np.isfinite(v) for m in runs.values() for s in m.values() for v in s.values())
    if not finite or any(set(m) != set(HARNESS_SCALINGS) for m in runs.values()):
        raise AssertionError(f"harness metrics: {runs}")
    # The zero-metrics fallback logs a warning and gives occlusion_accuracy 0.
    if warnings.messages or not all(v > 0 for m in occlusion_accuracy.values() for v in m.values()):
        raise AssertionError(f"harness metrics fell back: {warnings.messages}, {occlusion_accuracy}")
    bad = [row for row in forward_vs_plain
           if not all(row[name]["rel_err"] <= PIPELINE_RTOL for name in ("tracks", "visible_logits"))]
    if bad:
        raise AssertionError(f"harness forward, kernel vs plain attention: {bad}")
    for what, diffs in (("kernel vs plain", kernel_vs_plain), ("batched vs per video", batched_vs_per_video)):
        if any(not d <= HARNESS_METRIC_ATOL for d in diffs.values()):
            raise AssertionError(f"harness metrics, {what}: {diffs} > {HARNESS_METRIC_ATOL}")
    del model, plain
    torch.cuda.empty_cache()
    return {"launches": launches, "forwards": len(forwards), "wall_ms": wall_ms}


def phase_quant_kernel() -> dict:
    """The int8 kernels against ``quant_matmul_reference`` at the quantised
    forward's shapes: the product (quantise pass + GEMM), each pass alone and
    the wrapper with its cached weights timed; returns one forward's
    totals."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    totals = new_totals()
    for name, m, k, n, per_forward, x_dtype in QUANT_SHAPES:
        x = torch.randn((m, k), generator=gen, device="cuda").to(x_dtype)
        w = torch.randn((k, n), generator=gen, device="cuda") * (1.0 / math.sqrt(k))
        got = qmm.quant_matmul(x, w)
        torch.cuda.synchronize()
        want = qmm.quant_matmul_reference(x, w)
        err = (got - want).abs().max().item()
        finite = bool(torch.isfinite(got).all().item())
        del got, want
        wq, ws = qmm.quantize_weight(w)
        ms = cuda_ms(lambda: qmm.launch(x, wq, ws), iters=10)
        quantize_ms = cuda_ms(lambda: qmm.quantize_rows(x), iters=10)
        xq_k, sx_k = qmm.quantize_rows(x)
        gemm_ms = cuda_ms(lambda: qmm.int8_gemm(xq_k, sx_k, wq, ws), iters=10)
        del xq_k, sx_k
        wrapper_ms = cuda_ms(lambda: qmm.quant_matmul(x, w), iters=10)  # weights cached
        plain_ms = cuda_ms(lambda: qmm.quant_matmul_reference(x, w), iters=3)
        torch.cuda.synchronize()  # a fault of the kernels is reported before the library's timing
        emit("quant_matmul_kernel", shape=name, library="torch._int_mm")
        xq, _ = qmm.dynamic_int8(x.float(), -1)
        int_mm_ms = cuda_ms(lambda: torch._int_mm(xq, wq.t()), iters=10)
        wb, xb = w.to(torch.bfloat16), x.to(torch.bfloat16)
        bf16_ms = cuda_ms(lambda: xb @ wb, iters=10)
        x_bytes = x.element_size()
        bytes_ms = (m * k * x_bytes + k * n * 4 + m * n * 4) / PEAK_BYTES_PER_S * 1e3
        flops_ms = 2.0 * m * n * k / PEAK_INT8_OPS * 1e3
        bound_ms = max(bytes_ms, flops_ms)
        row = dict(shape=name, M=m, K=k, N=n, x_dtype=str(x_dtype).removeprefix("torch."),
                   per_forward=per_forward, max_abs_err=err, atol=QUANT_ATOL, finite=finite,
                   ms=ms, quantize_ms=quantize_ms, gemm_ms=gemm_ms, wrapper_ms=wrapper_ms,
                   bn=qmm._launch_shape(m, n, SMS)[0], plain_ms=plain_ms, library_ms=int_mm_ms,
                   library="torch._int_mm on the pre-quantised operands",
                   bf16_matmul_ms=bf16_ms, bound_ms=bound_ms,
                   bound_by="bytes" if bytes_ms >= flops_ms else "operations",
                   roofline_share=bound_ms / ms)
        emit("quant_matmul_kernel", **row)
        if not finite or err > QUANT_ATOL:
            raise AssertionError(f"int8 kernel disagrees with its plain version: {row}")
        if per_forward:
            totals["max_abs_err"] = max(totals["max_abs_err"], err)
            for key, value in (("ms", ms), ("quantize_ms", quantize_ms), ("gemm_ms", gemm_ms),
                               ("wrapper_ms", wrapper_ms), ("plain_ms", plain_ms),
                               ("library_ms", int_mm_ms), ("bytes_ms", bytes_ms),
                               ("flops_ms", flops_ms)):
                totals[key] = totals.get(key, 0.0) + per_forward * value
        del x, w, wq, ws, xq, wb, xb
        torch.cuda.empty_cache()
    return totals


def block_bound(items, seq, width, mlp, heads, head_dim, nbytes) -> tuple[float, float]:
    """(bytes ms, operations ms) of one block layer: x in and out once (f32)
    and the bf16 operands once; the bf16 products (Q/K/V, Q.K^T, P.V, the
    out-projection and the two MLP products)."""
    rows, hd = items * seq, heads * head_dim
    flops = (2.0 * rows * width * 3 * hd + 4.0 * items * heads * seq * seq * head_dim
             + 2.0 * rows * hd * width + 4.0 * rows * width * mlp)
    return (2 * rows * width * 4 + nbytes) / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3


def block_stage_bounds(items, seq, width, mlp, heads, head_dim, x_bytes) -> dict:
    """Each stage's least time, {stage: (ms, "bytes" or "operations")}, with
    ``block_bound``'s constants: its inputs read once and outputs written once
    (bf16 intermediates, f32 y and out), its bf16 products at the bf16 peak."""
    rows, hd = items * seq, heads * head_dim
    act = rows * width
    parts = {  # (bytes, operations)
        "ln1": (act * x_bytes + act * 2 * (2 if x_bytes == 4 else 1) + width * 2, 0.0),
        "qkv": (act * 2 + 3 * hd * width * 2 + rows * 3 * hd * 2 + 2 * head_dim * 2,
                2.0 * act * 3 * hd),
        "attention": (rows * 3 * hd * 2 + rows * hd * 2, 4.0 * items * heads * seq * seq * head_dim),
        "out_proj": (rows * hd * 2 + act * 2 + act * 4 + width * hd * 2 + width * 2,
                     2.0 * rows * hd * width),
        "ln2": (act * 4 + act * 2 + width * 2, 0.0),
        "mlp_in": (act * 2 + mlp * width * 2 + rows * mlp * 2 + mlp * 2, 2.0 * act * mlp),
        "mlp_out": (rows * mlp * 2 + act * 4 + act * 4 + width * mlp * 2 + width * 2,
                    2.0 * rows * mlp * width),
    }
    out = {}
    for stage, (nbytes, flops) in parts.items():
        bytes_ms, flops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
        out[stage] = (max(bytes_ms, flops_ms), "bytes" if bytes_ms >= flops_ms else "operations")
    return out


def phase_block_kernel(attention_shape_ms: dict) -> dict:
    """The fused block against ``block_reference`` at the readout and
    decompress layers (seeded weights, norm scales and biases perturbed so
    that none is trivial); the unfused layer timed beside it; each of the
    seven CUDA kernels timed alone against its own bound; at the readout
    layer, the attention stage beside ``csrc/attention.cu`` at the same shape
    (``readout_self`` of phase ``kernel``, bf16 out, timed in this run)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    totals = new_totals()
    totals["unfused_ms"] = 0.0
    for name, items, seq, width, mlp, per_forward in BLOCK_SHAPES:
        block = ParallelTransformerBlock(width, mlp, BLOCK_HEADS, BLOCK_QKV, dtype=torch.bfloat16,
                                         use_fused=True, fused_block=True, device="cuda")
        reset_parameters(block, gen)
        with torch.no_grad():
            for pname, param in block.named_parameters():
                if param.dim() == 1:
                    param.add_(0.1 * torch.randn(param.shape, generator=gen, device="cuda"))
        x = torch.randn((items, seq, width), generator=gen, device="cuda")
        with torch.inference_mode():
            ops = _operands(block)
            got = fused_transformer_block(x, block, BLOCK_HEADS)
            torch.cuda.synchronize()
            want = block_reference(x, ops, BLOCK_HEADS)
            diff = (got - want).abs()
            err, mean_err = diff.max().item(), diff.mean().item()
            finite = bool(torch.isfinite(got).all().item())
            scale = want.abs().max().item()
            del got, want, diff
            ms = cuda_ms(lambda: fused_transformer_block(x, block, BLOCK_HEADS), iters=5)
            # Each of the seven CUDA kernels alone, on the scratch of a whole call.
            _, bufs = block_launch_stages(x, ops, BLOCK_HEADS, torch.float32)
            stage_ms = {stage: cuda_ms(lambda i=i: block_launch_stages(
                x, ops, BLOCK_HEADS, torch.float32, 1 << i, bufs), iters=5)
                for i, stage in enumerate(BLOCK_STAGES)}
            del bufs
            plain_ms = cuda_ms(lambda: block_reference(x, ops, BLOCK_HEADS), iters=2)
            block.fused_block = False
            unfused_ms = cuda_ms(lambda: block(x), iters=5)
            block.fused_block = True
        nbytes = sum(t.numel() * t.element_size() for t in ops.values())
        bytes_ms, flops_ms = block_bound(items, seq, width, mlp, BLOCK_HEADS,
                                         BLOCK_QKV // BLOCK_HEADS, nbytes)
        bound_ms = max(bytes_ms, flops_ms)
        stage_bounds = block_stage_bounds(items, seq, width, mlp, BLOCK_HEADS,
                                          BLOCK_QKV // BLOCK_HEADS, x.element_size())
        stage_bound_ms = {stage: stage_bounds[stage][0] for stage in BLOCK_STAGES}
        # The A and B tiles the GEMMs read from L2 (128-row tiles; Q/K/V's N
        # tile 192 wide at heads of 96), and the rate at which each stage read them.
        rows, hd = items * seq, BLOCK_QKV
        tile_gb = {stage: -(-rows // 128) * -(-n // bn) * (128 + bn) * k * 2 / 1e9
                   for stage, n, k, bn in (("qkv", 3 * hd, width, 192), ("out_proj", width, hd, 128),
                                           ("mlp_in", mlp, width, 128), ("mlp_out", width, mlp, 128))}
        row = dict(shape=name, x=[items, seq, width], mlp=mlp, heads=BLOCK_HEADS,
                   head_dim=BLOCK_QKV // BLOCK_HEADS, per_forward=per_forward,
                   cuda_kernels_per_call=KERNELS_PER_CALL, max_abs_err=err, mean_abs_err=mean_err,
                   ref_max_abs=scale, atol=BLOCK_ATOL, finite=finite, ms=ms, stage_ms=stage_ms,
                   stage_bound_ms=stage_bound_ms,
                   stage_bound_by={stage: stage_bounds[stage][1] for stage in BLOCK_STAGES},
                   stage_share={stage: stage_bound_ms[stage] / stage_ms[stage]
                                for stage in BLOCK_STAGES},
                   gemm_tile_operand_gb=tile_gb,
                   gemm_tile_operand_tb_s={k: v / stage_ms[k] for k, v in tile_gb.items()},
                   plain_ms=plain_ms,
                   unfused_ms=unfused_ms, library_ms=None,
                   library="no single PyTorch call computes a whole block",
                   bound_ms=bound_ms, bound_by="bytes" if bytes_ms >= flops_ms else "operations",
                   roofline_share=bound_ms / ms)
        emit("block_kernel", **row)
        if not finite or err > BLOCK_ATOL:
            raise AssertionError(f"block kernel disagrees with its plain version: {row}")
        if name == "readout":
            # The same attention (512, 129, 129, 8, 96, unmasked, bf16 out)
            # through the block's stage and through csrc/attention.cu.
            emit("block_kernel", shape=name, stage="attention", ms=stage_ms["attention"],
                 bound_ms=stage_bound_ms["attention"],
                 stage_share=stage_bound_ms["attention"] / stage_ms["attention"],
                 attention_cu_ms=attention_shape_ms["readout_self"]["bfloat16"],
                 attention_cu_shape="readout_self",
                 plan=attention_plan(items, seq, BLOCK_HEADS, BLOCK_QKV // BLOCK_HEADS, SMS))
        totals["max_abs_err"] = max(totals["max_abs_err"], err)
        for key, value in (("ms", ms), ("plain_ms", plain_ms), ("unfused_ms", unfused_ms),
                           ("bytes_ms", bytes_ms), ("flops_ms", flops_ms)):
            totals[key] += per_forward * value
        for stage, value in stage_ms.items():
            totals.setdefault("stage_ms", {}).setdefault(stage, 0.0)
            totals["stage_ms"][stage] += per_forward * value
            totals.setdefault("stage_bound_ms", {}).setdefault(stage, 0.0)
            totals["stage_bound_ms"][stage] += per_forward * stage_bound_ms[stage]
        del block, x, ops
        torch.cuda.empty_cache()
    totals["library_ms"] = None
    return totals


def phase_bilinear_kernel(providers) -> dict:
    """The bilinear kernel against the plain gather on the tail's DINO grid
    and depth maps at the seeded tracks; returns one tail's totals (one DINO
    and two depth samplings)."""
    tracks = providers.tracks.contiguous()
    dino_coords = (tracks * torch.tensor([DINO_GRID[1] / WIDTH, DINO_GRID[0] / HEIGHT],
                                         device="cuda")).contiguous()
    cases = [("dino", providers.dino, dino_coords, 1), ("depth", providers.depth, tracks, 2),
             ("dino_bf16_grid", providers.dino.to(torch.bfloat16), dino_coords, 0)]
    totals = new_totals()
    out_dtype = torch.float32  # the tail keeps the XLA tail's f32 products
    for name, grid, coords, per_tail in cases:
        got = bilinear_kernel(grid, coords, out_dtype)
        torch.cuda.synchronize()
        want = bilinear_sample_reference(grid, coords, out_dtype)
        err = (got - want).abs().max().item()
        finite = bool(torch.isfinite(got).all().item())
        del got, want
        ms = cuda_ms(lambda: bilinear_kernel(grid, coords, out_dtype), iters=10)
        plain_ms = cuda_ms(lambda: bilinear_sample_reference(grid, coords, out_dtype), iters=3)
        torch.cuda.synchronize()  # a fault of the kernel is reported before the library's timing
        emit("bilinear_kernel", case=name, library="grid_sample")
        frames, height, width, channels = grid.shape
        # The yardstick: grid_sample with border padding and align_corners
        # computes the reference's corner rule (tests/test_torch_bilinear.py);
        # its normalised [T, 1, N, 2] grid is made outside the timed call.
        g = torch.stack([coords[..., 0] * (2.0 / (width - 1)) - 1.0,
                         coords[..., 1] * (2.0 / (height - 1)) - 1.0], dim=-1)
        g = g.permute(1, 0, 2)[:, None].contiguous().to(grid.dtype)
        library_ms = cuda_ms(lambda: torch.nn.functional.grid_sample(
            grid.permute(0, 3, 1, 2), g, mode="bilinear", padding_mode="border",
            align_corners=True), iters=10)
        del g
        n = coords.shape[0]
        # The grid cells this run's points touch (four corners, clamped).
        x0f, y0f = coords[..., 0].floor().long(), coords[..., 1].floor().long()
        t_idx = torch.arange(frames, device="cuda")[None, :]
        cells = torch.cat([
            ((t_idx * height + yy.clamp(0, height - 1)) * width
             + xx.clamp(0, width - 1)).reshape(-1)
            for yy in (y0f, y0f + 1) for xx in (x0f, x0f + 1)
        ]).unique().numel()
        nbytes = (cells * channels * grid.element_size() + coords.numel() * 4
                  + n * frames * channels * 4)
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        flops_ms = 11.0 * n * frames * channels / PEAK_F32_FLOPS * 1e3
        bound_ms = max(bytes_ms, flops_ms)
        row = dict(case=name, grid=list(grid.shape),
                   grid_dtype=str(grid.dtype).removeprefix("torch."),
                   points=n, per_tail=per_tail, cells_touched=cells, max_abs_err=err,
                   atol=BILINEAR_ATOL, finite=finite, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, library=BILINEAR_LIBRARY,
                   bound_ms=bound_ms, bound_by="bytes" if bytes_ms >= flops_ms else "operations",
                   roofline_share=bound_ms / ms)
        emit("bilinear_kernel", **row)
        if not finite or err > BILINEAR_ATOL:
            raise AssertionError(f"bilinear kernel disagrees with the plain gather: {row}")
        if per_tail:
            totals["max_abs_err"] = max(totals["max_abs_err"], err)
            for key, value in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                               ("bytes_ms", bytes_ms), ("flops_ms", flops_ms)):
                totals[key] += per_tail * value
    return totals


# The row norms timed alone: (name, rows, width, x dtype, out dtype, centered,
# backward). The tail's encoder (2048 x 151 tokens; 8 heads of 96) and
# readout (512 x 129 tokens), TRAJAN's training decoder (4 x 2048 x 129
# tokens, f32 out under autograd) and encoder heads (4 x 2048 x 151 x 8, 64).
NORM_SHAPES = [
    ("tail_encoder_ln", 309248, 384, torch.float32, torch.bfloat16, True, False),
    ("tail_encoder_qk", 2473984, 96, torch.bfloat16, torch.bfloat16, False, False),
    ("tail_readout_ln", 66048, 1280, torch.float32, torch.bfloat16, True, False),
    ("train_decoder_ln", 1056768, 1024, torch.float32, torch.float32, True, True),
    ("train_encoder_qk", 9895936, 64, torch.bfloat16, torch.bfloat16, False, True),
]
NORM_REL_ATOL = 1e-5  # of each row's largest value: f32 rounding in another order
# The summing backward of a training block's query norm: f32 x and its three
# readers' bf16 cotangents (query, key, value), centered, at 3DSPA's training
# readout (4 x 2048 x 129 tokens, 1280 wide) and track encoder (4 x 2048 x 151,
# 384): (name, rows, width). Its target: 80 % of the byte bound.
NORM_SUM_SHAPES = [("train3d_readout_ln", 1056768, 1280), ("train3d_encoder_ln", 1236992, 384)]
NORM_SUM_COTANGENTS, NORM_SUM_TARGET = 3, 0.8
NORM_LIBRARY = ("torch.nn.functional.layer_norm(x, (W,), scale, None, 1e-6) (centered) or "
                "rms_norm(x, (W,), scale, 1e-6) (RMS, scale in x's dtype), then .to(out); "
                "backward: autograd.grad of that for x and scale")


def _library_norm(x, scale, centered, out_dtype):
    """The library's norm and cast, for timing beside the kernel (two-pass
    variance where centered: not the port's arithmetic)."""
    width = x.shape[-1]
    if centered:
        return torch.nn.functional.layer_norm(x, (width,), scale, None, 1e-6).to(out_dtype)
    return torch.nn.functional.rms_norm(x, (width,), scale.to(x.dtype), 1e-6).to(out_dtype)


def _row_rel_err(got, want) -> float:
    """The largest error of a row over that row's largest value."""
    got, want = got.float(), want.float()
    return ((got - want).abs().amax(-1) / want.abs().amax(-1).clamp_min(1e-30)).max().item()


def phase_norm_kernel() -> dict:
    """``csrc/norm.cu`` forward (and backward where training runs it) at the
    main paths' shapes against the plain chain, timed alone."""
    rows_out = {}
    for name, rows, width, x_dtype, out_dtype, centered, backward in NORM_SHAPES:
        emit("norm_kernel", shape=name)
        gen = torch.Generator(device="cuda").manual_seed(rows)
        x = (torch.randn((rows, width), generator=gen, device="cuda") * 2 + 0.5).to(x_dtype)
        scale = torch.rand(width, generator=gen, device="cuda") + 0.5
        with torch.inference_mode():
            got = norm_lib.row_norm(x, scale, centered, out_dtype)
            want = norm_lib.row_norm_reference(x, scale, centered, out_dtype)
            torch.cuda.synchronize()
            # A bf16 output may round the other way: one ulp, 2**-7 of the value.
            slack = 2.0 ** -7 if out_dtype == torch.bfloat16 else 0.0
            err = _row_rel_err(got, want)
            tol = NORM_REL_ATOL + slack
            del got, want
            ms = cuda_ms(lambda: norm_lib.row_norm(x, scale, centered, out_dtype), iters=20)
            plain_ms = cuda_ms(
                lambda: norm_lib.row_norm_reference(x, scale, centered, out_dtype), iters=3)
            library_ms = cuda_ms(lambda: _library_norm(x, scale, centered, out_dtype), iters=20)
        nbytes = rows * width * (x.element_size() + out_dtype.itemsize) + width * 4
        row = dict(shape=[rows, width], x_dtype=str(x_dtype).removeprefix("torch."),
                   out_dtype=str(out_dtype).removeprefix("torch."), centered=centered,
                   plan=norm_lib.plan(width, x.element_size()), max_row_rel_err=err, tol=tol,
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3)
        row["roofline_share"] = row["bound_ms"] / ms
        if backward:
            dy = torch.randn(x.shape, generator=gen, device="cuda").to(out_dtype)
            dx, dscale = norm_lib.row_norm_backward(x, scale, dy, centered)
            want_dx, want_dscale = norm_lib.row_norm_backward_reference(x, scale, dy, centered)
            torch.cuda.synchronize()
            dx_slack = 2.0 ** -7 if x_dtype == torch.bfloat16 else 0.0
            row["backward_dx_row_rel_err"] = _row_rel_err(dx, want_dx)
            row["backward_dscale_rel_err"] = ((dscale - want_dscale).abs().max()
                                              / want_dscale.abs().max()).item()
            row["backward_tol"] = NORM_REL_ATOL + dx_slack
            del dx, dscale, want_dx, want_dscale
            row["backward_ms"] = cuda_ms(
                lambda: norm_lib.row_norm_backward(x, scale, dy, centered), iters=10)
            row["backward_plain_ms"] = cuda_ms(
                lambda: norm_lib.row_norm_backward_reference(x, scale, dy, centered), iters=2)
            xg, sg = x.detach().requires_grad_(), scale.detach().requires_grad_()
            out = _library_norm(xg, sg, centered, out_dtype)
            row["backward_library_ms"] = event_ms(  # autograd: no graph capture
                lambda: torch.autograd.grad(out, (xg, sg), dy, retain_graph=True), iters=10)
            del xg, sg, out
            back_bytes = rows * width * (2 * x.element_size() + dy.element_size()) + 2 * width * 4
            row["backward_bound_ms"] = back_bytes / PEAK_BYTES_PER_S * 1e3
            row["backward_roofline_share"] = row["backward_bound_ms"] / row["backward_ms"]
            del dy
        emit("norm_kernel", **row)
        bad = err > tol or (backward and (row["backward_dx_row_rel_err"] > row["backward_tol"]
                                          or row["backward_dscale_rel_err"] > 1e-4))
        if bad:
            raise AssertionError(f"row-norm kernel disagrees with the plain chain: {name} {row}")
        rows_out[name] = row
        del x, scale
        torch.cuda.empty_cache()
    for name, rows, width in NORM_SUM_SHAPES:
        rows_out[name] = _norm_sum_backward(name, rows, width)
    return rows_out


def _norm_sum_backward(name: str, rows: int, width: int) -> dict:
    """The backward kernel summing ``NORM_SUM_COTANGENTS`` bf16 cotangents of
    an f32 [rows, width] LayerNorm in registers, against the plain backward
    of their f32 sum; timed beside its byte bound (x, each cotangent, dx) and
    the chain it replaced (the casts and f32 adds, then the backward of one
    f32 cotangent)."""
    emit("norm_kernel", shape=name)
    gen = torch.Generator(device="cuda").manual_seed(rows)
    x = torch.randn((rows, width), generator=gen, device="cuda") * 2 + 0.5
    scale = torch.rand(width, generator=gen, device="cuda") + 0.5
    dys = [torch.randn(x.shape, generator=gen, device="cuda").to(torch.bfloat16)
           for _ in range(NORM_SUM_COTANGENTS)]
    before = norm_lib.row_norm_backward.launches
    dx, dscale = norm_lib.row_norm_backward(x, scale, dys, True)
    launched = norm_lib.row_norm_backward.launches - before
    want_dx, want_dscale = norm_lib.row_norm_backward_reference(
        x, scale, norm_lib.cotangent_sum(dys), True)
    torch.cuda.synchronize()
    row = dict(shape=[rows, width], x_dtype="float32", dy_dtype="bfloat16",
               cotangents=NORM_SUM_COTANGENTS, centered=True, launches=launched,
               plan=norm_lib.backward_plan(width, x.element_size(), dys[0].element_size()),
               backward_dx_row_rel_err=_row_rel_err(dx, want_dx),
               backward_dscale_rel_err=((dscale - want_dscale).abs().max()
                                        / want_dscale.abs().max()).item(),
               backward_tol=NORM_REL_ATOL)
    del dx, dscale, want_dx, want_dscale
    torch.cuda.empty_cache()
    row["backward_ms"] = cuda_ms(lambda: norm_lib.row_norm_backward(x, scale, dys, True), iters=10)
    row["backward_chain_ms"] = cuda_ms(lambda: norm_lib.row_norm_backward(
        x, scale, norm_lib.cotangent_sum(dys), True), iters=5)
    nbytes = rows * width * (2 * x.element_size() + NORM_SUM_COTANGENTS * 2) + 2 * width * 4
    row["backward_bound_ms"] = nbytes / PEAK_BYTES_PER_S * 1e3
    row["backward_roofline_share"] = row["backward_bound_ms"] / row["backward_ms"]
    row["backward_target"] = NORM_SUM_TARGET
    emit("norm_kernel", **row)
    if (launched != 1 or row["backward_dx_row_rel_err"] > NORM_REL_ATOL
            or row["backward_dscale_rel_err"] > 1e-4):
        raise AssertionError(f"the summing row-norm backward disagrees with the plain "
                             f"backward of the f32 sum: {name} {row}")
    del x, scale, dys
    torch.cuda.empty_cache()
    return row


# ViT-g/14 on the extractor's 8-frame groups: 8 x 1297 tokens, width 1536,
# SwiGLU 2 x 4096; a request (150 frames in 19 groups) makes 760 block calls.
VIT_BLOCK_ROWS, VIT_BLOCK_WIDTH, VIT_BLOCK_HIDDEN = 8 * 1297, 1536, 4096
VIT_BLOCK_CALLS_PER_REQUEST = 19 * 40
# The row kernel's shapes: (name, rows, width). The giant's, then ViT-B/14's
# on the pipeline's 8-frame groups: DINO (36 x 36 patches + CLS) and the
# depth backbone (37 x 37 + CLS).
VIT_ROW_SHAPES = [("vitg", VIT_BLOCK_ROWS, VIT_BLOCK_WIDTH), ("vitb_dino", 8 * 1297, 768),
                  ("vitb_depth", 8 * 1370, 768)]
# The row kernel's launches: (name, residual, norm dtype, launches a block
# call, projections that cast the eager norm's f32 output to bf16).
VIT_ROW_LAUNCHES = [("norm1", False, torch.bfloat16, 1, 3),
                    ("attention_residual_norm2", True, torch.bfloat16, 1, 1),
                    ("ffn_residual", True, None, 1, 0),
                    ("final_norm", False, torch.float32, 0, 0)]
# One 8-frame ViT-g/14 forward: three row launches a block and the final
# norm, one gate and one attention a block.
VITG_FORWARD_LAUNCHES = {"vit_residual_norm": 3 * 40 + 1, "swiglu_gate": 40,
                         "vit_attention": 40}


def _vit_eager_rows(x, h, bias, layer_scale, ln, residual, casts):
    """The eager chain one row launch replaces: the projection's bias add
    (bf16), the f32 layer scale and residual sum, ``core/layers.py``'s
    LayerNorm in f32 and each projection's cast of it to bf16."""
    if residual:
        x = x + (h + bias.to(torch.bfloat16)) * layer_scale
    if ln is None:
        return x
    out = ln(x)
    return x, [out.to(torch.bfloat16) for _ in range(casts)] or out


def _vit_row_launches(tag: str, rows: int, width: int, gen) -> dict:
    """The row kernel's four launches over an f32 [rows, width] stream with
    bf16 projections: each against ``vit_residual_norm_reference`` (the
    stream bit for bit, the norm within f32 rounding of the row plus a bf16
    ulp), timed beside its bound and the eager chain."""
    from tdspa_torch.core.layers import LayerNorm

    x = torch.randn((rows, width), generator=gen, device="cuda") * 3 + 0.5
    h = torch.randn((rows, width), generator=gen, device="cuda").to(torch.bfloat16)
    bias, layer_scale, scale, norm_bias = (
        torch.randn(width, generator=gen, device="cuda") * 0.5 + 0.5 for _ in range(4))
    norm = (scale, norm_bias, 1e-6)
    ln = LayerNorm(width, 1e-6, torch.float32, "cuda")
    with torch.no_grad():
        ln.scale.copy_(scale)
        ln.bias.copy_(norm_bias)
    out_rows = {}
    for name, residual, out_dtype, per_block, casts in VIT_ROW_LAUNCHES:
        emit("vit_block_kernel", backbone=tag, shape=name)
        res = (h, bias, layer_scale) if residual else None
        nrm = norm if out_dtype is not None else None
        out_dtype = out_dtype or torch.float32
        with torch.inference_mode():
            got = vit_block.vit_residual_norm(x, res, nrm, out_dtype)
            want = vit_block.vit_residual_norm_reference(x, res, nrm, out_dtype)
            torch.cuda.synchronize()
            got, want = (t if isinstance(t, tuple) else (t,) for t in (got, want))
            stream_equal = (not residual) or torch.equal(got[0], want[0])
            err = _row_rel_err(got[-1], want[-1]) if nrm is not None else 0.0
            tol = NORM_REL_ATOL + (2.0 ** -7 if out_dtype == torch.bfloat16 else 0.0)
            del got, want
            ms = cuda_ms(lambda: vit_block.vit_residual_norm(x, res, nrm, out_dtype), iters=20)
            eager_ms = cuda_ms(lambda: _vit_eager_rows(x, h, bias, layer_scale,
                                                       ln if nrm else None, residual, casts),
                               iters=5)
        elements = rows * width
        nbytes = elements * (4 + (2 + 4 if residual else 0)
                             + (out_dtype.itemsize if nrm is not None else 0)) + 4 * width * 4
        row = dict(backbone=tag, shape=[rows, width], residual=residual,
                   norm_dtype=str(out_dtype).removeprefix("torch.") if nrm else None,
                   plan=vit_block.plan(width), stream_equal=stream_equal, max_row_rel_err=err,
                   tol=tol, ms=ms, eager_ms=eager_ms, bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
                   launches_per_block_call=per_block)
        row["roofline_share"] = row["bound_ms"] / ms
        emit("vit_block_kernel", **row)
        if not stream_equal or err > tol:
            raise AssertionError(f"ViT row kernel disagrees with its plain version: {tag} "
                                 f"{name} {row}")
        out_rows[name] = row
    del x, h
    torch.cuda.empty_cache()
    return out_rows


def _vitg_forward_launches() -> dict:
    """One 8-frame ViT-g/14 forward (504 x 504 frames, seeded weights, bf16
    compute over an f32 stream) with its launches counted; a finite f32
    output."""
    from tdspa_torch.core.layers import init_parameters
    from tdspa_torch.features.vit import Dinov2, ViTConfig

    model = Dinov2(ViTConfig.preset("vitg"), dtype=torch.bfloat16, residual_dtype=torch.float32,
                   device="cuda")
    init_parameters(model, SEED, "cuda")
    pixels = torch.rand((8, 504, 504, 3), generator=torch.Generator(device="cuda").manual_seed(SEED),
                        device="cuda")
    counters = {"vit_residual_norm": vit_block.vit_residual_norm,
                "swiglu_gate": vit_block.swiglu_gate, "vit_attention": vit_attention}
    with torch.inference_mode():
        model(pixels)  # warm: library handles and algorithm choices
        for fn in counters.values():
            fn.launches = 0
        out, ms = _timed_call(model, pixels)
    launches = {k: fn.launches for k, fn in counters.items()}
    row = dict(frames=8, launches=launches, expected=VITG_FORWARD_LAUNCHES, ms=ms,
               dtype=str(out.dtype).removeprefix("torch."),
               finite=bool(torch.isfinite(out).all().item()))
    emit("vit_block_kernel", forward="vitg", **row)
    if launches != VITG_FORWARD_LAUNCHES or not row["finite"] or out.dtype != torch.float32:
        raise AssertionError(f"ViT-g/14 forward: {row}")
    del model, pixels, out
    torch.cuda.empty_cache()
    return row


def phase_vit_block_kernel() -> dict:
    """``csrc/vit_block.cu`` at ViT-g/14's and ViT-B/14's shapes against the
    plain versions, timed beside the bounds and the eager chain they replace;
    one ViT-g/14 forward's launches."""
    rows, hidden = VIT_BLOCK_ROWS, VIT_BLOCK_HIDDEN
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    by_backbone = {tag: _vit_row_launches(tag, n, width, gen) for tag, n, width in VIT_ROW_SHAPES}
    out_rows = dict(by_backbone["vitg"])
    block = {k: sum(r["launches_per_block_call"] * r[k] for r in out_rows.values())
             for k in ("ms", "eager_ms", "bound_ms")}

    emit("vit_block_kernel", shape="swiglu_gate")
    y = (torch.randn((rows, 2 * hidden), generator=gen, device="cuda") * 2).to(torch.bfloat16)
    gate_bias = torch.randn(2 * hidden, generator=gen, device="cuda") * 0.5
    with torch.inference_mode():
        got = vit_block.swiglu_gate(y, gate_bias)
        want = vit_block.swiglu_gate_reference(y, gate_bias)
        torch.cuda.synchronize()
        off = (got.float() - want.float()).abs()
        # One bf16 ulp: 2**-7 of the value at most (exp may round apart).
        ulp_ok = bool((off <= want.float().abs() * 2.0 ** -7).all())
        del got, want, off
        ms = cuda_ms(lambda: vit_block.swiglu_gate(y, gate_bias), iters=20)
        eager_ms = cuda_ms(lambda: vit_block.swiglu_gate_reference(y, gate_bias), iters=5)
    nbytes = rows * hidden * (2 * 2 + 2) + 2 * hidden * 4
    row = dict(shape=[rows, 2 * hidden], within_an_ulp=ulp_ok, ms=ms, eager_ms=eager_ms,
               bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3, launches_per_block_call=1)
    row["roofline_share"] = row["bound_ms"] / ms
    emit("vit_block_kernel", **row)
    if not ulp_ok:
        raise AssertionError(f"SwiGLU gate kernel disagrees with its plain version: {row}")
    out_rows["swiglu_gate"] = row
    for k in block:
        block[k] += row[k]
    del y
    torch.cuda.empty_cache()
    final = out_rows["final_norm"]
    per_request = {k: VIT_BLOCK_CALLS_PER_REQUEST * v + 19 * final[k] for k, v in block.items()}
    totals = dict(block_call=block, request=per_request,
                  block_roofline_share=block["bound_ms"] / block["ms"],
                  calls_per_request=VIT_BLOCK_CALLS_PER_REQUEST)
    emit("vit_block_kernel", **totals)
    forward = _vitg_forward_launches()
    return {"rows": out_rows, "vitb": {k: by_backbone[k] for k in ("vitb_dino", "vitb_depth")},
            "vitg_forward": forward, **totals}


def phase_serving(path, knob: str) -> dict:
    """``InferencePipeline(**{knob: True})`` with phase ``pipeline``'s seeded
    providers, video, seed and weights: launches per forward, output, and
    agreement with that phase's bf16 pipeline."""
    providers = path["providers"]
    pipe = InferencePipeline(
        num_output_frames=NUM_FRAMES, use_dino=True, use_depth=True,
        track_provider=providers.track, dino_extractor=providers.dino_grid,
        depth_provider=providers.depth_maps, seed=SEED, device="cuda", **{knob: True},
    )
    pipe.model.load_state_dict(path["pipeline"].model.state_dict())
    counters = {"attention": fused_masked_attention, "quant_matmul": qmm.quant_matmul,
                "block": fused_transformer_block, "bilinear": bilinear_kernel}
    for fn in counters.values():
        fn.launches = 0
    tails = []
    for _ in range(RUNS):
        results = pipe.run_on_frames(path["video"])
        tails.append(results["timings"]["fused_tail"] * 1e3)
    launches = {name: fn.launches for name, fn in counters.items()}
    per_forward = {
        "quantize": {"attention": FORWARD_LAUNCHES, "quant_matmul": QUANT_LAUNCHES, "block": 0,
                     "bilinear": TAIL_BILINEAR_LAUNCHES},
        "fused_block": {"attention": FUSED_BLOCK_ATTENTION_LAUNCHES, "quant_matmul": 0,
                        "block": BLOCK_LAUNCHES, "bilinear": TAIL_BILINEAR_LAUNCHES},
    }[knob]
    preds, ref = results["predictions"], path["predictions"]
    finite = bool(torch.isfinite(preds.tracks).all() and torch.isfinite(preds.visible_logits).all())
    agreement = {name: _rel_err(getattr(preds, name), getattr(ref, name))
                 for name in ("tracks", "visible_logits")}
    a, b = preds.tracks.float(), ref.tracks.float()
    tracks_rel_l2 = ((a - b).norm() / b.norm()).item()
    vis_agree = ((preds.visible_logits > 0) == (ref.visible_logits > 0)).float().mean().item()
    phase = f"pipeline_{'quantized' if knob == 'quantize' else knob}"
    emit(phase, runs=RUNS, launches=launches,
         launches_per_forward={k: v / RUNS for k, v in launches.items()},
         expected_per_forward=per_forward, shape=list(preds.tracks.shape), finite=finite,
         fused_tail_ms=tails, fused_tail_median_ms=statistics.median(tails[1:]),
         bf16_fused_tail_median_ms=path["fused_tail_median_ms"], vs_bf16_pipeline=agreement,
         tracks_rel_l2=tracks_rel_l2, visibility_agreement=vis_agree,
         limits=({"tracks_rel_l2": QUANT_TRACKS_REL_L2, "visibility_agreement": QUANT_VIS_AGREE}
                 if knob == "quantize" else {"rel_err": FUSED_BLOCK_RTOL}),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if launches != {k: v * RUNS for k, v in per_forward.items()}:
        raise AssertionError(f"{phase}: launches {launches} in {RUNS} runs; expected "
                             f"{per_forward} per forward")
    if list(preds.tracks.shape) != [1, 512, NUM_FRAMES, 3] or not finite:
        raise AssertionError(f"{phase}: output {list(preds.tracks.shape)}, finite={finite}")
    if knob == "quantize":
        ok = tracks_rel_l2 < QUANT_TRACKS_REL_L2 and vis_agree > QUANT_VIS_AGREE
    else:
        ok = all(v["rel_err"] <= FUSED_BLOCK_RTOL for v in agreement.values())
    if not ok:
        raise AssertionError(f"{phase} disagrees with the bf16 pipeline: {agreement}, "
                             f"rel L2 {tracks_rel_l2}, visibility agreement {vis_agree}")
    del pipe, results
    torch.cuda.empty_cache()
    return {"launches": launches, "fused_tail_median_ms": statistics.median(tails[1:])}


def event_ms(fn, iters: int) -> float:
    """Mean time of ``fn`` over ``iters`` calls between two CUDA events (no
    graph: for autograd work, whose host side is part of the cost)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def stack_layers(model_type: str) -> tuple[int, int, int, int]:
    """(encoder, latent, decompress, readout) layers of a default model."""
    return (3, 4, 4, 4) if model_type == "3dspa" else (2, 6, 3, 4)


def step_launches(model_type: str, microbatches: int = 1) -> dict:
    """Attention launches of one training step: each encoder chunk and each
    decoder chunk runs once forward and once more when the backward
    recomputes it (JAX's remats); the latents' stack (self + cross per layer)
    runs once. The backward kernel runs once per attention call the loss
    depends on: as many as the forward's (``backward``)."""
    enc, lat, dec, read = stack_layers(model_type)
    enc_chunks, dec_chunks = TRAIN_SUPPORT // TRAIN_CHUNK, TRAIN_QUERIES // TRAIN_CHUNK
    forward = enc * enc_chunks + 2 * lat + (dec + read) * dec_chunks
    recompute = enc * enc_chunks + (dec + read) * dec_chunks
    return {"forward": microbatches * forward, "recompute": microbatches * recompute,
            "step": microbatches * (forward + recompute), "backward": microbatches * forward}


def step_norm_launches(model_type: str) -> dict:
    """Row-norm launches of one training step. A stack call launches 4 a
    layer (``norm_q``, ``norm_attn``, the query and key RMSNorms), 6 with the
    cross-attention (the latents'), and its final norm. Forward
    (``row_norm``): each encoder and decoder chunk twice (its recompute too,
    as ``step_launches``), the latents once; backward
    (``row_norm_backward``): once a norm the loss depends on. The shared
    query norm (``row_norm_shared``) launches once a ``norm_q`` call, and its
    backward sums 3 cotangents, 4 with the cross-attention
    (``row_norm_shared_cotangents``)."""
    enc, lat, dec, read = stack_layers(model_type)
    enc_chunks, dec_chunks = TRAIN_SUPPORT // TRAIN_CHUNK, TRAIN_QUERIES // TRAIN_CHUNK
    chunked = enc_chunks * (4 * enc + 1) + dec_chunks * (4 * (dec + read) + 2)
    chunked_q = enc_chunks * enc + dec_chunks * (dec + read)
    return {"row_norm": 2 * chunked + 6 * lat + 1, "row_norm_backward": chunked + 6 * lat + 1,
            "row_norm_shared": 2 * chunked_q + lat,
            "row_norm_shared_cotangents": 3 * chunked_q + 4 * lat}


def attention_step_costs(model_type: str) -> dict:
    """Device ms per training step of the attention kernel (forward and
    recompute launches) and of the backward kernel (once per attention call
    the loss depends on), from each training shape timed alone times its
    count per step; beside them the plain recompute the backward kernel
    replaced (autograd through ``xla_reference``), timed the same way.
    At each shape the backward kernel is held to its plain version
    (``BACKWARD_REL_ATOL``)."""
    enc, lat, dec, read = stack_layers(model_type)
    depth = 96 if model_type == "3dspa" else 64
    seq = NUM_FRAMES + (1 if model_type == "3dspa" else 0)
    enc_chunks, dec_chunks = TRAIN_SUPPORT // TRAIN_CHUNK, TRAIN_QUERIES // TRAIN_CHUNK
    items = TRAIN_BATCH * TRAIN_CHUNK
    # (name, B, S, K, masked, forward launches per step, recompute launches
    # per step); each attention call the loss depends on is differentiated
    # once: the recomputed ones, and the latents' (not rematerialised).
    shapes = [("encoder", items, seq, seq, True, enc * enc_chunks, enc * enc_chunks),
              ("latents_self", TRAIN_BATCH, 128, 128, False, lat, 0),
              ("latents_cross", TRAIN_BATCH, 128, TRAIN_SUPPORT, False, lat, 0),
              ("decompress", TRAIN_BATCH, 128, 128, False, dec * dec_chunks, dec * dec_chunks),
              ("readout", items, 129, 129, False, read * dec_chunks, read * dec_chunks)]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, forward_ms, recompute_ms, backward_ms, plain_ms = [], 0.0, 0.0, 0.0, 0.0
    for name, batch, s_len, k_len, masked, launches, recomputes in shapes:
        q, k, v, mask = attention_inputs(gen, batch, s_len, k_len, 8, depth, masked)
        g = torch.randn(q.shape, generator=gen, device="cuda")
        one = cuda_ms(lambda: fused_masked_attention(q, k, v, mask), iters=10)
        got = attention_backward(q, k, v, mask, g)
        want = attention_backward_reference(q, k, v, mask, g)
        rel = max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                  for a, b in zip(got, want))
        if not rel <= BACKWARD_REL_ATOL or not all(bool(torch.isfinite(a).all()) for a in got):
            raise AssertionError(f"backward kernel at the training shape {name}: {rel}")
        del got, want
        bwd = cuda_ms(lambda: attention_backward(q, k, v, mask, g), iters=10)
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        plain = event_ms(lambda: torch.autograd.grad(xla_reference(q, k, v, mask), (q, k, v), g),
                         3)
        rows.append(dict(shape=name, B=batch, S=s_len, K=k_len, kernel_ms=one,
                         forward_launches=launches, recompute_launches=recomputes,
                         backward_kernel_ms=bwd, backward_rel_err=rel,
                         plain_recompute_backward_ms=plain))
        forward_ms += launches * one
        recompute_ms += recomputes * one
        backward_ms += launches * bwd
        plain_ms += launches * plain
        del q, k, v, mask, g
    torch.cuda.empty_cache()
    return {"kernel_forward_ms": forward_ms, "kernel_recompute_ms": recompute_ms,
            "backward_kernel_ms": backward_ms, "plain_recompute_backward_ms": plain_ms,
            "shapes": rows}


def train_batch(model_type: str, batch: int | None = None) -> dict:
    """A prepared batch (of ``TRAIN_BATCH`` unless given) of
    ``SyntheticTrackProvider`` examples at full width (4096 tracks, 2048
    support and 2048 query tracks, 150 frames; 3D with DINO and depth
    features), on the card."""
    t0 = time.perf_counter()
    batch = batch or TRAIN_BATCH
    three_d = model_type == "3dspa"
    provider = SyntheticTrackProvider(num_videos=batch, num_tracks=TRAIN_TRACKS,
                                      num_frames=NUM_FRAMES, num_coords=3 if three_d else 2,
                                      with_features=three_d, seed=SEED)
    parts = []
    for i in range(batch):
        example = provider[i]
        if three_d:
            parts.append(prepare_3d_batch(example, TRAIN_SUPPORT, TRAIN_QUERIES, NUM_FRAMES,
                                          seed=i))
        else:
            parts.append(prepare_2d_batch(example, TRAIN_SUPPORT, TRAIN_QUERIES, NUM_FRAMES,
                                          seed=i))
        del example
    host = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    out = to_device(host, torch.device("cuda"))
    torch.cuda.synchronize()
    emit("train_data", model_type=model_type, seconds=time.perf_counter() - t0,
         shapes={k: list(v.shape) for k, v in out.items()},
         gb=sum(v.numel() * v.element_size() for v in out.values()) / 1e9)
    return out


def phase_trajan2d() -> dict:
    """The default 2D TRAJAN (seeded, bf16 compute, fused attention) at
    T = 150, B = 1, 2048 support and 2048 query tracks: 21 attention launches
    per forward; outputs against the same model on plain attention."""
    torch.cuda.reset_peak_memory_stats()
    batch = train_batch("trajan", batch=1)
    del batch["query_tracks"], batch["query_tracks_visible"]
    model = TrackAutoEncoder(num_output_frames=NUM_FRAMES, dtype=torch.bfloat16,
                             fused_attention=True, device="cuda", seed=SEED)
    params = sum(p.numel() for p in model.parameters())
    fused_masked_attention.launches = 0
    times, out = [], None
    with torch.inference_mode():
        for _ in range(RUNS):
            out, ms = _timed_call(model, batch)
            times.append(ms)
    launches = fused_masked_attention.launches
    plain = TrackAutoEncoder(num_output_frames=NUM_FRAMES, dtype=torch.bfloat16,
                             device="cuda", seed=SEED)
    plain.load_state_dict(model.state_dict())
    with torch.inference_mode():
        want, plain_ms = _timed_call(plain, batch)
    if fused_masked_attention.launches != launches:
        raise AssertionError("the plain 2D model launched the fused kernel")
    shapes = {name: list(getattr(out, name).shape)
              for name in ("tracks", "visible_logits", "certain_logits")}
    finite = all(bool(torch.isfinite(getattr(out, name)).all()) for name in shapes)
    agreement = {name: {**_rel_err(getattr(out, name), getattr(want, name)), "rtol": PIPELINE_RTOL}
                 for name in shapes}
    emit("trajan2d", params=params, launches=launches, launches_per_forward=launches / RUNS,
         forward_ms=times, forward_median_ms=statistics.median(times[1:]), plain_ms=plain_ms,
         shapes=shapes, finite=finite, agreement=agreement,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    expected = {"tracks": [1, TRAIN_QUERIES, NUM_FRAMES, 2],
                "visible_logits": [1, TRAIN_QUERIES, NUM_FRAMES, 1],
                "certain_logits": [1, TRAIN_QUERIES, NUM_FRAMES, 1]}
    if params != TRAJAN_PARAMS or shapes != expected or not finite:
        raise AssertionError(f"2D model wrong: {params} parameters, {shapes}, finite={finite}")
    if launches != TRAJAN_FORWARD_LAUNCHES * RUNS:
        raise AssertionError(f"{launches} attention launches in {RUNS} 2D forwards, expected "
                             f"{TRAJAN_FORWARD_LAUNCHES * RUNS}")
    bad = {k: v for k, v in agreement.items() if not v["rel_err"] <= PIPELINE_RTOL}
    if bad:
        raise AssertionError(f"2D model: kernel and plain attention disagree: {bad}")
    return {"launches": launches, "forward_median_ms": statistics.median(times[1:]),
            "model": model, "batch": batch, "out": out}


def backward_bound(batch, seq, kv_len, heads, depth, masked) -> tuple[float, float]:
    """(bytes ms, flops ms) of the attention backward: q, k, v (bf16), g (f32)
    and the key mask (a byte a key) read once, dq, dk, dv (bf16) written once,
    over 3.35 TB/s; its five products (s, dP, dv, dk, dq: 10 B H S K D flops)
    over 989 TFLOP/s."""
    nbytes = batch * heads * depth * (8 * seq + 8 * kv_len) + (batch * kv_len if masked else 0)
    flops = 10 * batch * heads * seq * kv_len * depth
    return nbytes / 3.35e12 * 1e3, flops / 989e12 * 1e3


def phase_attention_backward() -> dict:
    """``fused_attention_fn`` at the training path's shapes: its forward
    against ``attention_reference``, its backward (the kernel of
    ``csrc/attention_backward.cu``) against ``attention_backward_reference``
    on the same inputs, dq = 0 on the fully masked item; the backward
    kernel's ms beside its bound, the plain version's, the eager recompute
    (autograd through ``xla_reference``), SDPA's backward alone and its
    forward + backward (timed only)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}
    for name, batch, seq, kv_len, heads, depth, masked in BACKWARD_SHAPES:
        torch.cuda.reset_peak_memory_stats()
        q, k, v, mask = attention_inputs(gen, batch, seq, kv_len, heads, depth, masked)
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        qd, kd, vd = (x.detach() for x in (q, k, v))
        g = torch.randn((batch, seq, heads, depth), generator=gen, device="cuda")
        before = (fused_masked_attention.launches, attention_backward.launches)
        out = fused_attention_fn(q, k, v, mask)
        grads = torch.autograd.grad(out, (q, k, v), g)
        torch.cuda.synchronize()
        launched = [fused_masked_attention.launches - before[0],
                    attention_backward.launches - before[1]]
        want_out = attention_reference(qd, kd, vd, mask)
        want = attention_backward_reference(qd, kd, vd, mask, g)
        names = ("dq", "dk", "dv")
        errs = {n: (a.float() - b.float()).abs().max().item() for n, a, b in zip(names, grads, want)}
        scales = {n: b.float().abs().max().item() for n, b in zip(names, want)}
        rel = {n: errs[n] / scales[n] for n in names}
        out_err = (out - want_out).abs().max().item()
        finite = all(bool(torch.isfinite(x).all()) for x in (out, *grads))
        masked_dq = grads[0][0].abs().max().item() if masked == "rows" else None
        peak = torch.cuda.max_memory_allocated() / 1e9
        del out, grads, want_out, want

        def forward():
            with torch.no_grad():
                fused_attention_fn(q, k, v, mask)

        def forward_backward():
            torch.autograd.grad(fused_attention_fn(q, k, v, mask), (q, k, v), g)

        kernel_ms = cuda_ms(lambda: attention_backward(qd, kd, vd, mask, g), 10)
        plain_ms = event_ms(lambda: attention_backward_reference(qd, kd, vd, mask, g), 3)
        recompute_ms = event_ms(
            lambda: torch.autograd.grad(xla_reference(q, k, v, mask), (q, k, v), g), 3)
        forward_ms = event_ms(forward, 10)
        total_ms = event_ms(forward_backward, 5)
        torch.cuda.synchronize()  # a fault of the kernel is reported before the library's timing
        emit("attention_backward", shape=name, library="scaled_dot_product_attention")
        add_mask = None
        if mask is not None:
            add_mask = torch.zeros(mask.shape, device="cuda", dtype=torch.bfloat16)
            add_mask.masked_fill_(~mask, torch.finfo(torch.bfloat16).min)
            add_mask = add_mask[:, None, None, :]
        qt, kt, vt = (x.transpose(1, 2).requires_grad_() for x in (qd, kd, vd))
        gt = g.to(torch.bfloat16).transpose(1, 2)

        def sdpa_forward_backward():
            o = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=add_mask)
            torch.autograd.grad(o, (qt, kt, vt), gt)

        sdpa_total_ms = event_ms(sdpa_forward_backward, 5)
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=add_mask)
        sdpa_backward_ms = event_ms(
            lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), gt, retain_graph=True), 5)
        bytes_ms, flops_ms = backward_bound(batch, seq, kv_len, heads, depth, masked)
        row = dict(shape=name, B=batch, S=seq, K=kv_len, H=heads, D=depth, masked=bool(masked),
                   launches={"forward": launched[0], "backward": launched[1]},
                   max_abs_err=errs, grad_max_abs=scales, rel_err=rel,
                   rel_atol=BACKWARD_REL_ATOL, out_max_abs_err=out_err, out_atol=KERNEL_ATOL,
                   masked_item_dq_max_abs=masked_dq, finite=finite, kernel_ms=kernel_ms,
                   bytes_ms=bytes_ms, flops_ms=flops_ms, bound_ms=max(bytes_ms, flops_ms),
                   bound_by="bytes" if bytes_ms >= flops_ms else "operations",
                   kernel_over_bound=kernel_ms / max(bytes_ms, flops_ms), plain_ms=plain_ms, recompute_backward_ms=recompute_ms,
                   forward_ms=forward_ms, backward_ms=total_ms - forward_ms,
                   forward_backward_ms=total_ms, sdpa_backward_ms=sdpa_backward_ms,
                   sdpa_forward_backward_ms=sdpa_total_ms, peak_mem_gb=peak)
        emit("attention_backward", **row)
        if (not finite or launched != [1, 1] or max(rel.values()) > BACKWARD_REL_ATOL
                or out_err > KERNEL_ATOL or masked_dq not in (None, 0.0)):
            raise AssertionError(f"attention backward wrong: {row}")
        rows[name] = row
        del q, k, v, qd, kd, vd, mask, g, qt, kt, vt, gt, add_mask, sdpa_out
        torch.cuda.empty_cache()
    return rows


def _clone(tensors: dict) -> dict:
    return {k: v.detach().clone() for k, v in tensors.items()}


def _rel_l2(a: dict, b: dict) -> float:
    """||a - b|| / ||b|| over every tensor of two same-keyed dicts (0 where
    both are zero)."""
    num = sum(float((a[k].detach().double() - b[k].detach().double()).square().sum())
              for k in b)
    den = sum(float(b[k].detach().double().square().sum()) for k in b)
    return math.sqrt(num / den) if den else (0.0 if num == 0 else math.inf)


def phase_train(model_type: str) -> dict:
    """``train()`` at full width (bf16 compute, fused attention, encoder and
    decoder chunks of 256, T = 150, 2048 support and 2048 query tracks,
    batch 2, 3 steps) with a checkpoint per step; the resume from step 2;
    then the train step alone: its time and peak memory, one accumulated
    step (2 microbatches) against the full step, and the first step's loss
    and gradients against the same model on plain attention."""
    three_d = model_type == "3dspa"
    overrides = dict(dtype=torch.bfloat16, fused_attention=True,
                     encoder_scan_chunk_size=TRAIN_CHUNK, decoder_scan_chunk_size=TRAIN_CHUNK)
    batch = train_batch(model_type)
    schedule_kw = dict(learning_rate=TRAIN_LR, warmup_steps=1, num_epochs=100)
    expected = step_launches(model_type)
    with tempfile.TemporaryDirectory() as tmp:
        run = dict(model_type=model_type, num_output_frames=NUM_FRAMES, log_freq=1,
                   save_freq=1, checkpoint_dir=tmp, max_steps=TRAIN_STEPS, seed=SEED,
                   device="cuda", **schedule_kw, **overrides)
        log = MetricLogger(use_wandb=False)
        torch.cuda.reset_peak_memory_stats()
        fused_masked_attention.launches = attention_backward.launches = 0
        t0 = time.perf_counter()
        state = train([batch] * TRAIN_STEPS, logger=log, **run)
        train_s = time.perf_counter() - t0
        launches = fused_masked_attention.launches
        backward_launches = attention_backward.launches
        train_peak = torch.cuda.max_memory_allocated() / 1e9
        losses = [r["train/loss"] for r in log.history]
        walls = [r["wall_s"] for r in log.history]
        final = _clone(state.params)
        del state
        torch.cuda.empty_cache()
        # Resume: drop step 3's checkpoint; the loop restarts from step 2.
        ckpt = TrainCheckpointer(tmp)
        saved_steps = sorted(int(d) for d in os.listdir(tmp))
        step2 = ckpt.restore(2, device="cuda")["params"]
        shutil.rmtree(os.path.join(tmp, str(TRAIN_STEPS)))
        resumed = train([batch] * TRAIN_STEPS, logger=MetricLogger(use_wandb=False), **run)
        resume_update = _rel_l2({k: resumed.params[k] - step2[k] for k in step2},
                                {k: final[k] - step2[k] for k in step2})
        resume_max_abs = max((resumed.params[k] - final[k]).abs().max().item() for k in final)
        resumed_step = resumed.step
        del resumed, final, step2
        torch.cuda.empty_cache()

    # The step alone, from the seeded init (train()'s).
    state, model, optimizer, schedule = create_model_state(
        SEED, model_type=model_type, learning_rate=TRAIN_LR, warmup_steps=1,
        total_steps=100 * TRAIN_STEPS, num_output_frames=NUM_FRAMES, device="cuda", **overrides)
    params = sum(p.numel() for p in model.parameters())
    # First step: loss and gradients with the kernel, with plain attention
    # (bf16) and with plain attention in f32 (the yardstick of bf16 noise).
    fused_losses, fused_grads = loss_and_grads(model, state.params, batch)
    fused_grads = dict(zip(state.params, fused_grads))
    plain_grads = {}
    before = (fused_masked_attention.launches, attention_backward.launches)
    for dtype in (torch.bfloat16, torch.float32):
        plain = build_model(model_type, num_output_frames=NUM_FRAMES, device="cuda", seed=SEED,
                            **{**overrides, "fused_attention": False, "dtype": dtype})
        plain.load_state_dict(model.state_dict())
        plain_params = dict(plain.named_parameters())
        losses_, grads_ = loss_and_grads(plain, plain_params, batch)
        plain_grads[dtype] = dict(zip(plain_params, grads_))
        if dtype == torch.bfloat16:
            plain_losses = losses_
        del plain, plain_params, grads_
    if (fused_masked_attention.launches, attention_backward.launches) != before:
        raise AssertionError("the plain-attention model launched the fused kernels")
    g_plain, g_f32 = plain_grads[torch.bfloat16], plain_grads[torch.float32]
    grad_rel = {k: _rel_l2({k: fused_grads[k]}, {k: g_plain[k]}) for k in fused_grads}
    kernel_vs_f32 = {k: _rel_l2({k: fused_grads[k]}, {k: g_f32[k]}) for k in fused_grads}
    plain_vs_f32 = {k: _rel_l2({k: g_plain[k]}, {k: g_f32[k]}) for k in fused_grads}
    grad_excess = {k: kernel_vs_f32[k] - plain_vs_f32[k] for k in fused_grads}
    grad_global = _rel_l2(fused_grads, g_plain)
    loss_rel = abs(fused_losses["total_loss"].item() / plain_losses["total_loss"].item() - 1)
    worst = sorted(grad_rel.items(), key=lambda kv: -kv[1])[:5]
    worst_excess = sorted(grad_excess.items(), key=lambda kv: -kv[1])[:5]
    del plain_grads, g_plain, g_f32, fused_grads
    torch.cuda.empty_cache()

    step = make_train_step(model, optimizer, schedule)
    torch.cuda.reset_peak_memory_stats()
    fused_masked_attention.launches = attention_backward.launches = 0
    step_ms, step_losses = [], []
    for _ in range(TRAIN_STEPS):
        (state, metrics), ms = _timed_call(step, state, batch)
        step_ms.append(ms)
        step_losses.append(metrics["train/loss"].item())
    step_launches_seen = fused_masked_attention.launches / TRAIN_STEPS
    step_backward_seen = attention_backward.launches / TRAIN_STEPS
    step_peak = torch.cuda.max_memory_allocated() / 1e9

    # One accumulated step (2 microbatches) against the full step, same state.
    start = (_clone(state.params), _clone(state.opt_state.mu), _clone(state.opt_state.nu))

    def reset():
        with torch.no_grad():
            for saved, live in zip(start, (state.params, state.opt_state.mu, state.opt_state.nu)):
                for k, v in saved.items():
                    live[k].copy_(v)

    # The same step with its row-norm launches counted.
    counters = {"row_norm": norm_lib.row_norm, "row_norm_backward": norm_lib.row_norm_backward,
                "row_norm_shared": norm_lib.row_norm_shared}

    def norm_counts():
        return {**{k: fn.launches for k, fn in counters.items()},
                "row_norm_shared_cotangents": norm_lib.row_norm_shared.cotangents}

    before = norm_counts()
    full_state, full_metrics = step(state, batch)
    norm_step = {k: v - before[k] for k, v in norm_counts().items()}
    norm_expected = step_norm_launches(model_type)
    full_params = _clone(full_state.params)
    reset()
    accum = make_grad_accum_step(model, optimizer, schedule, num_microbatches=2)
    before = (fused_masked_attention.launches, attention_backward.launches)
    (acc_state, acc_metrics), accum_ms = _timed_call(accum, state, batch)
    accum_launches = fused_masked_attention.launches - before[0]
    accum_backward_launches = attention_backward.launches - before[1]
    acc_loss, full_loss = acc_metrics["train/loss"].item(), full_metrics["train/loss"].item()
    accum_loss_rel = abs(acc_loss / full_loss - 1)
    accum_lr = schedule(state.step)
    param_excess = max(
        ((acc_state.params[k] - full_params[k]).abs() - ACCUM_PARAM_RTOL * full_params[k].abs()
         - 2 * accum_lr).max().item() for k in full_params)
    accum_update = _rel_l2({k: acc_state.params[k] - start[0][k] for k in full_params},
                           {k: full_params[k] - start[0][k] for k in full_params})
    del full_state, full_params, acc_state, start
    torch.cuda.empty_cache()

    # Where a step's time goes: the forward (loss, autograd recording), the
    # optimizer update, the backward as the rest; within them the attention
    # kernel's launches and the backward kernel's, each timed alone (and the
    # plain recompute the backward kernel replaced, for the saving).
    loss_fn = compute_loss_3d if three_d else compute_loss_2d
    forward_ms = event_ms(lambda: loss_fn(model(batch), batch)["total_loss"], 2)
    _, grads = loss_and_grads(model, state.params, batch)
    optimizer_ms = event_ms(lambda: optimizer.update(grads, state.opt_state, state.params), 3)
    del grads
    costs = attention_step_costs(model_type)
    step_median = statistics.median(step_ms[1:])
    backward_ms = step_median - forward_ms - optimizer_ms
    kernel_ms = costs["kernel_forward_ms"] + costs["kernel_recompute_ms"]
    breakdown = {
        "step_ms": step_median, "forward_ms": forward_ms, "optimizer_ms": optimizer_ms,
        "backward_ms": backward_ms, "attention_kernel_ms": kernel_ms,
        "attention_backward_kernel_ms": costs["backward_kernel_ms"],
        "plain_recompute_backward_ms": costs["plain_recompute_backward_ms"],
        "shares": {
            "attention_kernel": kernel_ms / step_median,
            "attention_backward_kernel": costs["backward_kernel_ms"] / step_median,
            "rest_of_forward": (forward_ms - costs["kernel_forward_ms"]) / step_median,
            "rest_of_backward": (backward_ms - costs["kernel_recompute_ms"]
                                 - costs["backward_kernel_ms"]) / step_median,
            "optimizer": optimizer_ms / step_median,
        },
        "attention_shapes": costs["shapes"],
    }
    emit(f"train_{'3d' if three_d else '2d'}_breakdown", **breakdown)
    row = dict(
        model_type=model_type, params=params, batch=TRAIN_BATCH, support=TRAIN_SUPPORT,
        queries=TRAIN_QUERIES, frames=NUM_FRAMES, chunk=TRAIN_CHUNK,
        train_losses=losses, train_wall_s=train_s, train_log_wall_s=walls,
        train_launches=launches, train_backward_launches=backward_launches,
        train_peak_mem_gb=train_peak, saved_steps=saved_steps,
        resumed_step=resumed_step, resume_update_rel_l2=resume_update,
        resume_update_limit=RESUME_UPDATE_REL_L2, resume_max_abs_diff=resume_max_abs,
        step_ms=step_ms, step_median_ms=statistics.median(step_ms[1:]), step_losses=step_losses,
        step_peak_mem_gb=step_peak, launches_per_step=step_launches_seen,
        backward_launches_per_step=step_backward_seen,
        expected_launches=expected, norm_launches_per_step=norm_step,
        norm_launches_expected=norm_expected, accum_ms=accum_ms, accum_launches=accum_launches,
        accum_backward_launches=accum_backward_launches,
        accum_loss_rel=accum_loss_rel, accum_loss_rtol=ACCUM_LOSS_RTOL,
        accum_param_excess=param_excess, accum_param_rtol=ACCUM_PARAM_RTOL,
        accum_lr=accum_lr,
        accum_update_rel_l2=accum_update, accum_update_limit=ACCUM_UPDATE_REL_L2,
        plain_loss_rel=loss_rel, plain_loss_rtol=PLAIN_LOSS_RTOL,
        plain_grad_rel_l2_global=grad_global, plain_grad_rel_l2_limit=PLAIN_GRAD_REL_L2,
        plain_grad_rel_l2_per_param={"max": max(grad_rel.values()),
                                     "median": statistics.median(grad_rel.values()),
                                     "over_limit": sum(v > PLAIN_GRAD_REL_L2
                                                       for v in grad_rel.values()),
                                     "worst": worst},
        f32_rel_l2_per_param={"kernel_max": max(kernel_vs_f32.values()),
                              "kernel_median": statistics.median(kernel_vs_f32.values()),
                              "plain_max": max(plain_vs_f32.values()),
                              "plain_median": statistics.median(plain_vs_f32.values()),
                              "worst_excess": worst_excess},
    )
    emit(f"train_{'3d' if three_d else '2d'}", **row)
    problems = []
    if params != (SPA3D_PARAMS if three_d else TRAJAN_PARAMS):
        problems.append(f"{params} parameters")
    if not all(math.isfinite(x) for x in losses + step_losses) or len(losses) != TRAIN_STEPS:
        problems.append(f"losses {losses} {step_losses}")
    if launches != TRAIN_STEPS * expected["step"] or step_launches_seen != expected["step"]:
        problems.append(f"launches {launches} / {step_launches_seen} per step, expected "
                        f"{expected['step']} per step")
    if (backward_launches != TRAIN_STEPS * expected["backward"]
            or step_backward_seen != expected["backward"]):
        problems.append(f"backward kernel launches {backward_launches} / {step_backward_seen} "
                        f"per step, expected {expected['backward']} per step")
    if norm_step != norm_expected:
        problems.append(f"row-norm launches a step {norm_step}, expected {norm_expected}")
    if (accum_launches != step_launches(model_type, 2)["step"]
            or accum_backward_launches != step_launches(model_type, 2)["backward"]):
        problems.append(f"accumulated step launched {accum_launches} and "
                        f"{accum_backward_launches} backward")
    if saved_steps != list(range(1, TRAIN_STEPS + 1)) or resumed_step != TRAIN_STEPS:
        problems.append(f"checkpoints {saved_steps}, resumed to step {resumed_step}")
    if not resume_update <= RESUME_UPDATE_REL_L2:
        problems.append(f"resumed step-3 update differs by {resume_update}")
    if not accum_loss_rel <= ACCUM_LOSS_RTOL or not param_excess <= 0:
        problems.append(f"accumulation: loss {accum_loss_rel}, params excess {param_excess}")
    if not accum_update <= ACCUM_UPDATE_REL_L2:
        problems.append(f"accumulation: updates differ by {accum_update}")
    if (not loss_rel <= PLAIN_LOSS_RTOL or not grad_global <= PLAIN_GRAD_REL_L2
            or not max(grad_rel.values()) <= PLAIN_GRAD_REL_L2
            or not max(grad_excess.values()) <= PLAIN_GRAD_REL_L2):
        problems.append(f"kernel vs plain attention: loss {loss_rel}, gradients {grad_global}, "
                        f"per parameter {worst}, against f32 {worst_excess}")
    if problems:
        raise AssertionError(f"train_{model_type}: {problems}")
    return {"launches": launches, "launches_per_step": expected["step"],
            "backward_launches": backward_launches,
            "backward_launches_per_step": expected["backward"],
            "step_median_ms": row["step_median_ms"], "peak_mem_gb": step_peak,
            "batch": batch}


def phase_train_cli() -> dict:
    """``python -m tdspa_torch.cli.train`` for each model type on the
    synthetic fallback (64-track videos): 2 steps of batch 2, metrics every
    step, eval and a checkpoint at step 2. The JSONL holds JAX's keys; the
    checkpoint loads through ``load_checkpoint`` into a model whose eval
    loss on the same 10 validation batches is the one the CLI logged."""
    repo = os.path.dirname(os.path.abspath(__file__))
    rows = {}
    train_keys = {"train/loss", "train/position_loss", "train/visible_loss",
                  "train/learning_rate", "step", "wall_s"}
    eval_keys = {"eval/loss", "eval/position_loss", "eval/visible_loss", "step", "wall_s"}
    for model_type in ("3dspa", "trajan"):
        with tempfile.TemporaryDirectory() as tmp:
            cmd = [sys.executable, "-m", "tdspa_torch.cli.train", f"--model_type={model_type}",
                   "--max_steps=2", "--batch_size=2", "--nouse_wandb", "--log_freq=1",
                   "--save_freq=2", "--eval_freq=2", "--warmup_steps=1",
                   f"--checkpoint_dir={tmp}/ckpt", f"--log_jsonl={tmp}/metrics.jsonl"]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=tmp, capture_output=True, text=True, timeout=600,
                                  env={**os.environ, "PYTHONPATH": repo})
            wall_s = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"train CLI ({model_type}) failed:\n{proc.stderr[-4000:]}")
            with open(f"{tmp}/metrics.jsonl") as f:
                records = [json.loads(line) for line in f]
            kinds = [("eval" if "eval/loss" in r else "train", r["step"]) for r in records]
            keys_ok = all(set(r) == (eval_keys if "eval/loss" in r else train_keys)
                          for r in records)
            # The CLI's model starts from train()'s default seed.
            model = build_model(model_type, num_output_frames=NUM_FRAMES, device="cuda",
                                seed=inspect.signature(train).parameters["seed"].default)
            init = _clone(dict(model.named_parameters()))
            model.load_state_dict(load_checkpoint(f"{tmp}/ckpt/2", device="cuda"))
            moved = max((p - init[k]).abs().max().item() for k, p in model.named_parameters())
            loader = load_kubric3d_dataset if model_type == "3dspa" else load_tapvid_dataset
            eval_ds = loader("", split="validation", batch_size=2, shuffle=False,
                             num_frames=NUM_FRAMES)
            eval_step = make_eval_step(model)
            losses = [eval_step(dict(model.named_parameters()),
                                to_device(b, torch.device("cuda")))[0]["eval/loss"].item()
                      for b in eval_ds.take(10)]
            logged = next(r["eval/loss"] for r in records if "eval/loss" in r)
            eval_rel = abs(float(np.mean(losses)) / logged - 1)
        row = dict(model_type=model_type, wall_s=wall_s, records=kinds, keys_ok=keys_ok,
                   losses=[r.get("train/loss", r.get("eval/loss")) for r in records],
                   params_moved_max_abs=moved, logged_eval_loss=logged,
                   reloaded_eval_loss=float(np.mean(losses)), eval_rel=eval_rel,
                   rtol=CLI_EVAL_RTOL)
        emit("train_cli", **row)
        if (kinds != [("train", 1), ("train", 2), ("eval", 2)] or not keys_ok
                or not moved > 0 or not eval_rel <= CLI_EVAL_RTOL
                or not all(math.isfinite(x) for x in row["losses"])):
            raise AssertionError(f"train CLI ({model_type}) wrong: {row}")
        rows[model_type] = row
        del model, init
        torch.cuda.empty_cache()
    return rows


def _forward_only_refusals() -> dict:
    """The bilinear and cost-patch wrappers on CUDA tensors that autograd
    records: each must raise (a kernel's output carries no gradient)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    feats = torch.randn((3, 10, 12, 16), generator=gen, device="cuda").requires_grad_()
    pos = torch.rand((5, 3, 2), generator=gen, device="cuda") * 9
    tvecs = torch.randn((5, 2, 16), generator=gen, device="cuda")
    refused = {}
    for name, call in (("bilinear_sample", lambda: bilinear_kernel(feats, pos)),
                       ("cost_patches_multi", lambda: cost_patches_multi(feats, tvecs, pos))):
        try:
            call()
            refused[name] = False
        except NotImplementedError as err:
            refused[name] = "forward-only" in str(err)
    return refused


def phase_matcher_train(noisy) -> dict:
    """The matcher's training on the card at the shipped recipe's widths and
    scenes: the CPU against the card for the first steps, the feature net's
    gradient, MATCHER_STEPS steps (step ms, peak memory, the logged losses),
    then the trained matcher saved, loaded and run by the tracker on the noisy
    scene through csrc/matcher.cu, beside the shipped matcher."""
    refused = _forward_only_refusals()
    t0 = time.perf_counter()
    videos, tracks, visible = matcher_lib.make_training_scenes(MATCHER_NUM_SCENES,
                                                               **MATCHER_SCENES)
    scenes_s = time.perf_counter() - t0
    videos, tracks = torch.from_numpy(videos), torch.from_numpy(tracks)
    visible = torch.from_numpy(visible.astype(np.float32))
    reach = float(MATCHER_RECIPE["radius"] * MATCHER_RECIPE["stride"])
    step_args = dict(iterations=MATCHER_ITERATIONS, occlusion_weight=MATCHER_OCCLUSION_WEIGHT)

    # The card against the CPU from one initialisation and the same noise.
    init = matcher_lib.init_matcher(**MATCHER_RECIPE, generator=torch.Generator().manual_seed(SEED),
                                    device="cpu")
    gen = torch.Generator().manual_seed(SEED + 1)
    noises = [(torch.rand(tracks[i].shape, generator=gen) * 2.0 - 1.0) * reach
              for i in range(MATCHER_CPU_STEPS)]
    runs = {}
    for device in ("cpu", "cuda"):
        model = copy.deepcopy(init).to(device)
        optimizer = matcher_lib.matcher_optimizer(MATCHER_LR, MATCHER_STEPS)
        state = optimizer.init(dict(model.named_parameters()))
        losses = []
        for i in range(MATCHER_CPU_STEPS):
            state, out = matcher_lib.matcher_train_step(
                model, optimizer, state, videos[i].to(device), tracks[i].to(device),
                visible[i].to(device), noises[i].to(device), **step_args)
            losses.append([float(x) for x in out])
        runs[device] = (model, losses)
    cpu_losses, card_losses = np.asarray(runs["cpu"][1]), np.asarray(runs["cuda"][1])
    loss_rel = float(np.max(np.abs(card_losses - cpu_losses) / np.abs(cpu_losses)))
    cpu_params = dict(runs["cpu"][0].named_parameters())
    param_err = max((p.detach().cpu() - cpu_params[k].detach()).abs().max().item()
                    for k, p in runs["cuda"][0].named_parameters())
    schedule = matcher_lib.matcher_optimizer(MATCHER_LR, MATCHER_STEPS).schedule
    param_limit = 2.0 * sum(schedule(i) for i in range(MATCHER_CPU_STEPS))
    # The feature net's gradient on the card: through the template vector, the
    # cost patches and the bank (the plain route; a kernel would cut it).
    model = runs["cuda"][0]
    loss, _, _ = matcher_lib.matcher_loss(model, videos[0].cuda(), tracks[0].cuda(),
                                          visible[0].cuda(), noises[0].cuda(), **step_args)
    names = [k for k, _ in model.named_parameters() if k.startswith("feature.")]
    grads = torch.autograd.grad(loss, [dict(model.named_parameters())[k] for k in names])
    feature_grad = {k: g.norm().item() for k, g in zip(names, grads)}
    del runs, model, loss, grads

    # MATCHER_STEPS steps on the card, noise from a generator on the card.
    videos, tracks, visible = videos.cuda(), tracks.cuda(), visible.cuda()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = matcher_lib.init_matcher(**MATCHER_RECIPE, generator=gen, device="cuda")
    optimizer = matcher_lib.matcher_optimizer(MATCHER_LR, MATCHER_STEPS)
    state = optimizer.init(dict(model.named_parameters()))
    cost_patches_multi.launches = 0
    bilinear_kernel.launches = 0
    log, step_ms = [], []
    t0 = time.perf_counter()
    for i in range(MATCHER_STEPS):
        s = i % MATCHER_NUM_SCENES
        noise = (torch.rand(tracks[s].shape, generator=gen, device="cuda") * 2.0 - 1.0) * reach
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, out = matcher_lib.matcher_train_step(model, optimizer, state, videos[s], tracks[s],
                                                    visible[s], noise, **step_args)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        if i % MATCHER_LOG_EVERY == 0 or i == MATCHER_STEPS - 1:
            log.append((i, *(float(x) for x in out)))
    train_s = time.perf_counter() - t0
    train_launches = {"cost_patches_multi": cost_patches_multi.launches,
                      "bilinear_sample": bilinear_kernel.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    warm_ms = statistics.median(step_ms[5:])

    # Saved, loaded, and run by the tracker on the noisy scene, beside the
    # shipped matcher: the cost patches through csrc/matcher.cu.
    video = torch.from_numpy(noisy["video"]).cuda()
    refine = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "matcher.npz")
        matcher_lib.save_matcher(path, model)
        loaded = matcher_lib.matcher_params_from_flax(matcher_lib.load_matcher(path), "cuda")
        same = all(torch.equal(a, b) for a, b in zip(loaded.state_dict().values(),
                                                      model.state_dict().values()))
        for name, matcher in (("trained", path), ("shipped", "default")):
            tracker = PyramidalLKTracker(**dict(TRACKER, matcher=matcher))
            lk_kernel.track_video_lk_kernel.launches = 0
            cost_patches_multi.launches = 0
            out, wall_ms = _timed_call(tracker, video)
            refine[name] = {"launches": {"lk": lk_kernel.track_video_lk_kernel.launches,
                                         "matcher": cost_patches_multi.launches},
                            "wall_ms": wall_ms, "quality": _quality(out, noisy)}
    row = dict(recipe=MATCHER_RECIPE, iterations=MATCHER_ITERATIONS,
               occlusion_weight=MATCHER_OCCLUSION_WEIGHT, scenes=MATCHER_NUM_SCENES,
               scene_shape=list(videos.shape[1:]), points=int(tracks.shape[1]),
               scenes_s=scenes_s, forward_only_refused=refused,
               cpu_vs_card={"steps": MATCHER_CPU_STEPS, "cpu_losses": cpu_losses.tolist(),
                            "card_losses": card_losses.tolist(), "loss_rel_err": loss_rel,
                            "loss_rtol": MATCHER_CPU_LOSS_RTOL, "param_max_abs_err": param_err,
                            "param_atol": param_limit},
               feature_grad_norms=feature_grad, steps=MATCHER_STEPS, train_s=train_s,
               step_ms_median=warm_ms, step_ms_first=step_ms[:5], peak_gb=peak_gb,
               log=log, first_loss=log[0][1], last_loss=log[-1][1],
               descent_limit=MATCHER_DESCENT,
               recipe_steps=MATCHER_RECIPE_STEPS,
               recipe_estimate_s=warm_ms * MATCHER_RECIPE_STEPS / 1e3,
               training_launches=train_launches, saved_equals_trained=same, refine=refine)
    emit("matcher_train", **row)
    if not all(refused.values()):
        raise AssertionError(f"forward-only wrappers recorded autograd on CUDA: {refused}")
    if not loss_rel <= MATCHER_CPU_LOSS_RTOL or not param_err <= param_limit:
        raise AssertionError(f"matcher training on the card differs from the CPU: losses "
                             f"{loss_rel} (limit {MATCHER_CPU_LOSS_RTOL}), parameters "
                             f"{param_err} (limit {param_limit})")
    if not all(v > 0 for v in feature_grad.values()):
        raise AssertionError(f"the feature net got no gradient on the card: {feature_grad}")
    if not np.isfinite([r[1:] for r in log]).all() or not log[-1][1] < MATCHER_DESCENT * log[0][1]:
        raise AssertionError(f"matcher training did not descend: {log}")
    if any(train_launches.values()):
        raise AssertionError(f"training launched a kernel (it runs the plain route): "
                             f"{train_launches}")
    if not same or any(r["launches"] != {"lk": 1, "matcher": MATCHER_LAUNCHES}
                       for r in refine.values()):
        raise AssertionError(f"trained matcher's refinement: saved == trained {same}, "
                             f"{refine}")
    del videos, tracks, visible, model, video
    torch.cuda.empty_cache()
    return {"training_launches": train_launches, "refine_launches":
            {k: v["launches"]["matcher"] for k, v in refine.items()},
            "step_ms_median": warm_ms}


def matcher_recipe(out: str, seeds: list[int]) -> None:
    """One-off measurement, not a phase of the default run: the shipped
    matcher's whole round-4 recipe (``python -m tdspa_torch.features.matcher
    out --seed N --natural_frac=0``: 4000 steps, bank 3, 48 cells-only scenes;
    the CLI's default ``--natural_frac`` of 0.5 trains the unshipped v2
    matcher instead) on the card once per seed
    (``out`` gains ``_seed<N>`` before its suffix when there are several),
    then each trained matcher and the shipped one run by the pipeline's
    tracker on the Tracked configuration's noisy scene through
    ``csrc/matcher.cu``, scored against its ground truth and held to each
    other at QUALITY_SLACK; a last line gives the seeds' spread."""
    video, gt_tracks, gt_visible = make_tracking_scene(**SCENE, **SCENES["noisy"])
    scene = {"gt_tracks": gt_tracks, "gt_visible": gt_visible}
    video = torch.from_numpy(video).cuda()

    def score(matcher) -> dict:
        tracker = PyramidalLKTracker(**dict(TRACKER, matcher=matcher))
        cost_patches_multi.launches = 0
        result, wall_ms = _timed_call(tracker, video)
        return {"matcher_launches": cost_patches_multi.launches, "wall_ms": wall_ms,
                "quality": _quality(result, scene)}

    shipped = score("default")
    keys = ("pts_within_2", "visibility_accuracy")
    by_seed = {}
    for seed in seeds:
        stem, suffix = os.path.splitext(out)
        path = out if len(seeds) == 1 else f"{stem}_seed{seed}{suffix}"
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "tdspa_torch.features.matcher", path,
                               f"--seed={seed}", "--natural_frac=0"],
                              capture_output=True, text=True, timeout=1800)
        recipe_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"the matcher recipe (seed {seed}) failed: {proc.stderr[-3000:]}")
        row = score(path)
        gap = {k: row["quality"][k] - shipped["quality"][k] for k in keys}
        emit("matcher_recipe", seed=seed, recipe_s=recipe_s,
             recipe_stdout=proc.stdout.strip()[-400:], rows={"recipe": row, "shipped": shipped},
             recipe_minus_shipped=gap, tolerance=QUALITY_SLACK,
             within_tolerance=all(abs(v) <= QUALITY_SLACK for v in gap.values()))
        by_seed[seed] = {k: row["quality"][k] for k in keys}
    spread = {k: {"min": min(r[k] for r in by_seed.values()),
                  "max": max(r[k] for r in by_seed.values()),
                  "shipped": shipped["quality"][k]} for k in keys}
    emit("matcher_recipe_seeds", seeds=seeds, by_seed=by_seed, spread=spread,
         shipped_within_spread={
             k: v["min"] - QUALITY_SLACK <= v["shipped"] <= v["max"] + QUALITY_SLACK
             for k, v in spread.items()})


EXPORT_CALL = r"""
import json, sys, time
import torch
from tdspa_torch.infer.export import load_exported
from tdspa_torch.kernels import attention, bilinear, block, quant_matmul
tmp, names = sys.argv[1], sys.argv[2].split(",")
data = torch.load(f"{tmp}/inputs.pt", map_location="cuda")
args = (data["params"], data["perm"], data["ts"], *data["inputs"])
counters = {"attention": attention.fused_masked_attention, "bilinear": bilinear.bilinear_sample,
            "quant_matmul": quant_matmul.quant_matmul, "block": block.fused_transformer_block}
rows = {}
for name in names:
    t0 = time.perf_counter()
    program = load_exported(f"{tmp}/tail_{name}.pt2")
    load_s = time.perf_counter() - t0
    with torch.inference_mode():
        program.call(*args)
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            out = program.call(*args)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = {k: c.launches for k, c in counters.items()}
    torch.save({k: v.cpu() for k, v in out.items()}, f"{tmp}/out_{name}.pt")
    rows[name] = {"load_s": load_s, "call_ms": times, "launches_per_call": launches}
    del program, out
model_modules = sorted(m for m in sys.modules
                       if m.startswith(("tdspa_torch.models", "tdspa_torch.infer.pipeline")))
print(json.dumps({"rows": rows, "model_modules": model_modules}))
"""


def phase_export(path, tmp: str) -> dict:
    """The full-width tail exported on the card in each serving
    configuration, saved, loaded and called in a process that imports no
    model module, against the eager ``fused_tail`` on the same parameters,
    split and inputs; then a manifest that disagrees with the pipeline."""
    providers, base = path["providers"], path["pipeline"].model
    num_tracks = GRID * GRID
    perm, ts = path["pipeline"].split_indices(num_tracks, 512, NUM_FRAMES)
    inputs = (providers.tracks, providers.visible, providers.dino, providers.depth)
    shapes = dict(num_tracks=num_tracks, num_frames=NUM_FRAMES, video_hw=(HEIGHT, WIDTH),
                  num_support=2048, num_queries=512, use_dino=True, use_depth=True)
    params = export_lib.serving_params(base)
    torch.save({"params": params, "perm": perm, "ts": ts, "inputs": inputs},
               os.path.join(tmp, "inputs.pt"))
    counters = {"attention": fused_masked_attention, "bilinear": bilinear_kernel,
                "quant_matmul": qmm.quant_matmul, "block": fused_transformer_block}
    rows, eager = {}, {}
    for knob in EXPORT_CONFIGS:
        model = base
        if knob != "default":
            model = TrackAutoEncoder3D(num_output_frames=NUM_FRAMES, dtype=torch.bfloat16,
                                       fused_attention=True, device="cuda", **{knob: True})
            model.load_state_dict(base.state_dict())
        t0 = time.perf_counter()
        program = export_lib.export_serving_tail(model, **shapes)
        export_s = time.perf_counter() - t0
        file = os.path.join(tmp, f"tail_{knob}.pt2")
        t0 = time.perf_counter()
        manifest = export_lib.save_exported(
            program, file, export_lib.tail_config(model, device="cuda", **shapes))
        save_s = time.perf_counter() - t0
        times = []
        with torch.inference_mode():
            for _ in range(RUNS):
                for c in counters.values():
                    c.launches = 0
                (pred, batch, tracks_3d), ms = _timed_call(
                    fused_tail, model, *inputs, perm, ts, 2048, 512, (HEIGHT, WIDTH))
                times.append(ms)
        eager_launches = {k: c.launches for k, c in counters.items()}
        eager[knob] = {"tracks": pred.tracks, "visible_logits": pred.visible_logits,
                       "certain_logits": pred.certain_logits,
                       "query_points": batch["query_points"], "tracks_3d": tracks_3d,
                       "support_tracks": batch["support_tracks"],
                       "query_tracks": batch["query_tracks"]}
        rows[knob] = dict(export_s=export_s, save_s=save_s, artifact_bytes=manifest["bytes"],
                          tdspa_ops=manifest["tdspa_ops"],
                          graph_nodes=len(program.graph.nodes), eager_ms=times,
                          eager_median_ms=statistics.median(times[1:]),
                          eager_launches=eager_launches)
        del program, pred, batch, tracks_3d
        if model is not base:
            del model
        torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, "-c", EXPORT_CALL, tmp, ",".join(EXPORT_CONFIGS)],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"exported tails failed in a fresh process: {proc.stderr[-3000:]}")
    called = json.loads(proc.stdout.strip().splitlines()[-1])
    for knob, row in rows.items():
        out = torch.load(os.path.join(tmp, f"out_{knob}.pt"))
        row.update(called["rows"][knob])
        row["call_median_ms"] = statistics.median(row["call_ms"])
        row["vs_eager"] = {k: _rel_err(out[k], eager[knob][k].cpu()) if k != "certain_logits"
                           else {"max_abs_err": (out[k] - eager[knob][k].cpu()).abs().max().item()}
                           for k in out}
        # certain_logits are zeros by design (3DSPA): held to 0 exactly.
        row["max_rel_err"] = max(v.get("rel_err", v["max_abs_err"])
                                 for v in row["vs_eager"].values())
        row["expected_launches"] = EXPORT_CONFIGS[knob]
        emit("export", config=knob, rtol=EXPORT_RTOL, **row)
    del eager
    # A manifest that disagrees with the pipeline (another quantize) is refused.
    other = os.path.join(tmp, "tail_other.pt2")
    shutil.copyfile(os.path.join(tmp, "tail_default.pt2"), other)
    with open(os.path.join(tmp, "tail_default.pt2.json")) as f:
        manifest = json.load(f)
    with open(other + ".json", "w") as f:
        json.dump({**manifest, "quantize": True}, f)
    pipe = InferencePipeline(num_output_frames=NUM_FRAMES, track_provider=providers.track,
                             dino_extractor=providers.dino_grid,
                             depth_provider=providers.depth_maps, model=base, seed=SEED,
                             tail_artifact=other, device="cuda")
    try:
        pipe.run_on_frames(path["video"])
        mismatch = "ran"
    except ValueError as err:
        mismatch = str(err)[:300]
    emit("export_manifest_check", refused="quantize" in mismatch, message=mismatch)
    if called["model_modules"]:
        raise AssertionError(f"the loading process imported model modules: "
                             f"{called['model_modules']}")
    for knob, row in rows.items():
        if row["eager_launches"] != EXPORT_CONFIGS[knob] \
                or row["launches_per_call"] != EXPORT_CONFIGS[knob]:
            raise AssertionError(f"export {knob}: launches {row['launches_per_call']} per call, "
                                 f"eager {row['eager_launches']}; expected "
                                 f"{EXPORT_CONFIGS[knob]}")
        if not row["max_rel_err"] <= EXPORT_RTOL:
            raise AssertionError(f"export {knob} differs from the eager tail: {row['vs_eager']}")
    if "quantize" not in mismatch:
        raise AssertionError(f"a mismatched manifest was not refused: {mismatch}")
    return {k: {"launches_per_call": v["launches_per_call"], "call_median_ms": v["call_median_ms"],
                "export_s": v["export_s"], "artifact_bytes": v["artifact_bytes"]}
            for k, v in rows.items()}


def phase_export_forward(trajan) -> dict:
    """``export_model_forward`` of the default TRAJAN-2D (phase trajan2d's
    model and batch), called against its eager forward."""
    model, batch, want = trajan["model"], trajan["batch"], trajan["out"]
    params = export_lib.serving_params(model)
    t0 = time.perf_counter()
    program = export_lib.export_model_forward(model, params, batch)
    export_s = time.perf_counter() - t0
    module = program.module()
    fused_masked_attention.launches = 0
    with torch.inference_mode():
        out, call_ms = _timed_call(module, params, batch)
    launches = fused_masked_attention.launches
    agreement = {k: _rel_err(out[k], getattr(want, k)) for k in out}
    emit("export_forward_2d", export_s=export_s, graph_nodes=len(program.graph.nodes),
         call_ms=call_ms, eager_median_ms=trajan["forward_median_ms"], launches=launches,
         vs_eager=agreement, rtol=EXPORT_RTOL)
    if launches != TRAJAN_FORWARD_LAUNCHES or any(v["rel_err"] > EXPORT_RTOL
                                                  for v in agreement.values()):
        raise AssertionError(f"exported 2D forward: {launches} launches, {agreement}")
    return {"launches": launches}


def phase_export_entry(scene, full, tmp: str) -> dict:
    """``InferencePipeline(tail_artifact=...)`` on the clean scene with
    phase pipeline_full's front ends and model, against that phase's
    predictions; then the infer CLI with ``--tail_artifact``."""
    artifact = os.path.join(tmp, "tail_default.pt2")
    eager = full["pipeline"]
    pipe = InferencePipeline(num_output_frames=NUM_FRAMES, tracking_grid_size=GRID, seed=SEED,
                             model=eager.model, track_provider=eager.track_provider,
                             dino_extractor=eager.dino_extractor,
                             depth_provider=eager.depth_provider, tail_artifact=artifact,
                             device="cuda")
    counters = _pipeline_counters()
    rows = {}
    for fn in counters.values():
        fn.launches = 0
    results, wall_ms = _timed_call(pipe.run_on_frames, scene["video"])
    launches = {k: fn.launches for k, fn in counters.items()}
    want = full["tail_inputs"]["predictions"]
    agreement = {k: _rel_err(getattr(results["predictions"], k), getattr(want, k))
                 for k in ("tracks", "visible_logits")}
    rows["pipeline"] = dict(wall_ms=wall_ms, launches=launches, vs_eager_pipeline=agreement,
                            timings_ms={k: v * 1e3 for k, v in results["timings"].items()})
    del results, pipe
    video_path = os.path.join(tmp, "clean.mp4")
    save_video(scene["video"], video_path)
    ckpt = os.path.join(tmp, "seeded_3dspa.npz")
    np.savez(ckpt, **{k.replace(".", "/"): v.float().cpu().numpy()
                      for k, v in eager.model.state_dict().items()})
    for fn in counters.values():
        fn.launches = 0
    results, cli_ms = _timed_call(lambda: infer_cli.main([
        f"--video_path={video_path}", f"--checkpoint_path={ckpt}",
        f"--output_dir={os.path.join(tmp, 'out')}", f"--num_output_frames={NUM_FRAMES}",
        f"--tracking_grid_size={GRID}", f"--seed={SEED}", f"--tail_artifact={artifact}",
        "--device=cuda"]))
    cli_launches = {k: fn.launches for k, fn in counters.items()}
    finite = bool(torch.isfinite(results["predictions"].tracks).all())
    with np.load(os.path.join(tmp, "out", "predictions.npz")) as saved:
        saved_shapes = {k: list(saved[k].shape) for k in saved.files}
    rows["cli"] = dict(wall_ms=cli_ms, launches=cli_launches, finite=finite, saved=saved_shapes)
    emit("export_entry", rtol=EXPORT_RTOL, **rows)
    tail = {"attention": FORWARD_LAUNCHES, "bilinear": TAIL_BILINEAR_LAUNCHES}
    for name, row in rows.items():
        if {k: row["launches"][k] for k in tail} != tail:
            raise AssertionError(f"export entry {name}: launches {row['launches']}")
    if any(v["rel_err"] > EXPORT_RTOL for v in agreement.values()) or not finite \
            or saved_shapes["tracks_3d"] != [512, NUM_FRAMES, 3]:
        raise AssertionError(f"export entry points: {rows}")
    return {k: v["launches"] for k, v in rows.items()}


def _export_launches(counter: str, exported: dict, entry: dict | None = None) -> dict:
    """One kernel's launches per call of each exported tail (and, given the
    entry points' rows, per run of the pipeline and the CLI on the default
    artifact)."""
    rows = {f"export_{k}": v["launches_per_call"][counter] for k, v in exported.items()}
    if entry is not None:
        rows.update({f"export_entry_{k}": v[counter] for k, v in entry.items()})
    return rows


def _mesh_launches(counter: str, mesh: dict) -> dict:
    """One kernel's launches per call of each mesh tail and of the mesh
    artifact on the one-rank group (and, for the attention, per sharded
    train step)."""
    rows = {f"mesh_{k}": v[counter] for k, v in mesh.items() if k.startswith("tail_")}
    rows["mesh_export"] = mesh["export"][counter]
    if counter == "attention":
        rows["mesh_train_step"] = mesh["train_step_launches"]
    return rows


def main() -> int:
    info = phase_device()
    phase_build()
    totals = phase_kernel()
    vit_totals = phase_vit_kernel()
    quant_totals = phase_quant_kernel()
    block_totals = phase_block_kernel(totals["shape_ms"])
    norm_rows = phase_norm_kernel()
    vit_block_rows = phase_vit_block_kernel()
    path = phase_pipeline()
    bilinear_totals = phase_bilinear_kernel(path["providers"])
    quantized = phase_serving(path, "quantize")
    fused_block = phase_serving(path, "fused_block")
    export_dir = tempfile.TemporaryDirectory()
    exported = phase_export(path, export_dir.name)
    phase_debug_nans(path)
    del path["pipeline"], path["providers"]
    torch.cuda.empty_cache()
    scenes = make_scenes()
    lk = phase_lk_kernel(scenes["clean"])
    matcher = phase_matcher_kernel(scenes["clean"], lk.pop("tracks"))
    phase_tracking(scenes)
    matcher_train = phase_matcher_train(scenes["noisy"])
    tracked = phase_pipeline_tracked(scenes)
    del tracked["pipeline"]
    torch.cuda.empty_cache()
    phase_features(scenes["clean"])
    full = phase_pipeline_full(scenes["clean"])
    tier_rows = phase_tracking_tiers()
    realism = phase_realism(full, export_dir.name)
    phase_visualize(realism["viz_path"])
    video_entry = phase_video_entry(scenes["clean"], full)
    export_entry = phase_export_entry(scenes["clean"], full, export_dir.name)
    export_dir.cleanup()
    full_launches = full["launches"]
    del full
    torch.cuda.empty_cache()
    harness_row = phase_eval_harness()
    trajan = phase_trajan2d()
    export_forward = phase_export_forward(trajan)
    del trajan["model"], trajan["batch"], trajan["out"]
    torch.cuda.empty_cache()
    backward = phase_attention_backward()
    train_3d = phase_train("3dspa")
    torch.cuda.empty_cache()
    train_2d = phase_train("trajan")
    torch.cuda.empty_cache()
    phase_train_cli()
    mesh = phase_mesh(train_3d.pop("batch"))
    torch.cuda.empty_cache()
    bound_by = "bytes" if totals["bytes_ms"] >= totals["flops_ms"] else "operations"
    kernels = [{
        "name": "fused_masked_attention",
        "route": "cuda",
        "source": "tdspa_torch/csrc/attention.cu",
        "replaces": "tdspa/kernels/attention.py:382",
        "also_replaces": "tdspa/kernels/attention.py:310",
        "launches": (path["launches"] + trajan["launches"] + train_3d["launches"]
                     + train_2d["launches"]),
        "launches_by_path": {"pipeline": path["launches"], "trajan2d": trajan["launches"],
                             "train_3d": train_3d["launches"],
                             "train_2d": train_2d["launches"]},
        "max_abs_err": totals["max_abs_err"],
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": max(totals["bytes_ms"], totals["flops_ms"]),
        "bound_by": bound_by,
        "library_ms": totals["library_ms"],
        "bf16_out_ms": totals["bf16_out_ms"],
        "per": "one forward: the 19 launches at their main-path shapes, f32 output",
        "training": {
            "launches_per_step": {"3dspa": train_3d["launches_per_step"],
                                  "trajan": train_2d["launches_per_step"]},
            "step_median_ms": {"3dspa": train_3d["step_median_ms"],
                               "trajan": train_2d["step_median_ms"]},
            "backward": {k: {"forward_ms": v["forward_ms"], "backward_ms": v["backward_ms"],
                             "sdpa_forward_backward_ms": v["sdpa_forward_backward_ms"]}
                         for k, v in backward.items()},
            "backward_route": "the attention_backward kernel (csrc/attention_backward.cu)",
        },
        "launches_on_new_paths": {
            "eval_harness": harness_row["launches"],
            "eval_harness_forwards": harness_row["forwards"],
            "realism": realism["launches"],
            "video_entry": {k: v["attention"] for k, v in video_entry.items()},
            **_export_launches("attention", exported, export_entry),
            "export_forward_2d": export_forward["launches"],
            **_mesh_launches("attention", mesh),
        },
    }]
    encoder = backward["encoder_3d"]
    kernels.append({
        "name": "attention_backward",
        "route": "cuda",
        "source": "tdspa_torch/csrc/attention_backward.cu",
        "replaces": "tdspa/kernels/attention.py:576",
        "launches": train_3d["backward_launches"] + train_2d["backward_launches"],
        "launches_by_path": {"train_3d": train_3d["backward_launches"],
                             "train_2d": train_2d["backward_launches"]},
        "launches_per_step": {"3dspa": train_3d["backward_launches_per_step"],
                              "trajan": train_2d["backward_launches_per_step"]},
        "max_abs_err": max(max(r["max_abs_err"].values()) for r in backward.values()),
        "max_rel_err": max(max(r["rel_err"].values()) for r in backward.values()),
        "ms": encoder["kernel_ms"],
        "plain_ms": encoder["plain_ms"],
        "bound_ms": encoder["bound_ms"],
        "bound_by": encoder["bound_by"],
        "library_ms": encoder["sdpa_backward_ms"],
        "by_shape": {name: {key: row[key] for key in ("kernel_ms", "bound_ms", "kernel_over_bound",
                                                     "plain_ms", "sdpa_backward_ms")}
                     for name, row in backward.items()},
        "library": "scaled_dot_product_attention's backward alone (autograd.grad on its saved "
                   "graph, bf16 cotangent, additive bf16 mask)",
        "recompute_backward_ms": encoder["recompute_backward_ms"],
        "shapes": {k: {f: v[f] for f in ("kernel_ms", "bound_ms", "bound_by", "plain_ms",
                                          "recompute_backward_ms", "sdpa_backward_ms",
                                          "forward_backward_ms", "sdpa_forward_backward_ms")}
                   for k, v in backward.items()},
        "per": ("one backward at the 3D encoder shape (2048, 151, 151, 8, 96; key mask with "
                "fully masked rows); launches counted over the train_3d and train_2d phases' "
                f"train() runs ({TRAIN_STEPS} steps each)"),
        "launches_on_new_paths": {"mesh_train_step": mesh["train_step_backward_launches"]},
    })
    main_lk = lk["pipeline"]
    kernels.append({
        "name": "track_video_lk_kernel",
        "route": "cuda",
        "source": "tdspa_torch/csrc/lk.cu",
        "replaces": "tdspa/kernels/lk.py:787",
        "launches": tracked["lk_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in lk.values()),
        "ms": main_lk["video_ms"],
        "plain_ms": main_lk["plain_ms"],
        "bound_ms": main_lk["video_bound_ms"],
        "bound_by": main_lk["video_bound_by"],
        "library_ms": None,
        "launch_150_frames_ms": main_lk["ms"],
        "launch_150_frames_bound_ms": main_lk["bound_ms"],
        "per": (f"one 150-frame video in the pipeline's configuration as the streamed pipeline "
                f"tracks it: {CHUNK_LAUNCHES} chunk launches of {main_lk['chunk_frames']} frames, "
                "149 frame pairs (plain_ms: one 150-frame call of the plain version); launches "
                "counted over the noisy-video pipeline run"),
        "cost_volume_launch_ms": lk["corr_rescue"]["ms"],
        "launches_on_new_paths": {
            "tracking_tiers": {k: {"lk": v["launches"]["lk"],
                                   "lk_cost_volume": v["launches"]["lk_cost_volume"],
                                   "runs": v["runs"]} for k, v in tier_rows.items()},
            "video_entry": {k: v["lk"] for k, v in video_entry.items()},
        },
    })
    kernels.append({
        "name": "cost_patches_multi",
        "route": "cuda",
        "source": "tdspa_torch/csrc/matcher.cu",
        "replaces": "tdspa/kernels/matcher.py:210",
        "also_replaces": "tdspa/kernels/matcher.py:157",
        "launches": tracked["matcher_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in matcher.values()),
        "ms": 4 * matcher[1]["ms"] + 4 * matcher[4]["ms"],
        "plain_ms": 4 * matcher[1]["plain_ms"] + 4 * matcher[4]["plain_ms"],
        "bound_ms": 4 * matcher[1]["bound_ms"] + 4 * matcher[4]["bound_ms"],
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in matcher.values())
        else "operations",
        "library_ms": None,
        "launch_ms": {"templates_1": matcher[1]["ms"], "templates_4": matcher[4]["ms"]},
        "launches_on_new_paths": {"matcher_train": {
            "training": matcher_train["training_launches"]["cost_patches_multi"],
            "refine_trained": matcher_train["refine_launches"]["trained"],
            "refine_shipped": matcher_train["refine_launches"]["shipped"]}},
        "per": ("one matcher pass over a video (4 launches with 1 template and 4 with 4, "
                "4096 points x 150 frames); launches counted over the noisy-video pipeline run"),
    })
    kernels.append({
        "name": "vit_attention",
        "route": "cuda",
        "source": "tdspa_torch/csrc/vit_attention.cu",
        "replaces": "tdspa/kernels/attention.py:214",
        "launches": full_launches["vit_attention"],
        "max_abs_err": vit_totals["max_abs_err"],
        "ms": vit_totals["ms"],
        "plain_ms": vit_totals["plain_ms"],
        "bound_ms": max(vit_totals["bytes_ms"], vit_totals["flops_ms"]),
        "bound_by": "bytes" if vit_totals["bytes_ms"] >= vit_totals["flops_ms"] else "operations",
        "library_ms": vit_totals["library_ms"],
        "per": (f"one 150-frame video: {VIT_LAUNCHES} launches at (8,1297,12,64) for DINO and "
                f"{VIT_LAUNCHES} at (8,1370,12,64) for depth, f32 output; launches counted over "
                f"{RUNS} full-pipeline runs"),
        "launches_on_new_paths": {"video_entry": {k: v["vit_attention"]
                                                  for k, v in video_entry.items()}},
    })
    kernels.append({
        "name": "quant_matmul",
        "route": "cuda",
        "source": "tdspa_torch/csrc/quant_matmul.cu",
        "replaces": "tdspa/kernels/quant_matmul.py:106",
        "launches": quantized["launches"]["quant_matmul"],
        "max_abs_err": quant_totals["max_abs_err"],
        "ms": quant_totals["ms"],
        "plain_ms": quant_totals["plain_ms"],
        "bound_ms": max(quant_totals["bytes_ms"], quant_totals["flops_ms"]),
        "bound_by": "bytes" if quant_totals["bytes_ms"] >= quant_totals["flops_ms"]
        else "operations",
        "library_ms": quant_totals["library_ms"],
        "library": "torch._int_mm on the pre-quantised operands",
        "quantize_ms": quant_totals["quantize_ms"],
        "gemm_ms": quant_totals["gemm_ms"],
        "wrapper_ms": quant_totals["wrapper_ms"],
        "per": (f"one quantised forward: the {QUANT_LAUNCHES} launches at their shapes, f32 x; "
                f"launches counted over {RUNS} pipeline_quantized runs"),
        "launches_on_new_paths": {**_export_launches("quant_matmul", exported),
                                  **_mesh_launches("quant_matmul", mesh)},
    })
    kernels.append({
        "name": "fused_transformer_block",
        "route": "cuda",
        "source": "tdspa_torch/csrc/block.cu",
        "replaces": "tdspa/kernels/block.py:196",
        "launches": fused_block["launches"]["block"],
        "max_abs_err": block_totals["max_abs_err"],
        "ms": block_totals["ms"],
        "plain_ms": block_totals["plain_ms"],
        "bound_ms": max(block_totals["bytes_ms"], block_totals["flops_ms"]),
        "bound_by": "bytes" if block_totals["bytes_ms"] >= block_totals["flops_ms"]
        else "operations",
        "library_ms": None,
        "unfused_ms": block_totals["unfused_ms"],
        "stage_ms": block_totals["stage_ms"],
        "stage_bound_ms": block_totals["stage_bound_ms"],
        "cuda_kernels_per_call": KERNELS_PER_CALL,
        "launches_on_new_paths": {**_export_launches("block", exported),
                                  **_mesh_launches("block", mesh)},
        "per": (f"one fused-block forward: {BLOCK_LAUNCHES} layers (4 readout, 4 decompress), "
                f"f32 residual; launches counted over {RUNS} pipeline_fused_block runs"),
    })
    kernels.append({
        "name": "bilinear_sample",
        "route": "cuda",
        "source": "tdspa_torch/csrc/bilinear.cu",
        "replaces": "tdspa/kernels/bilinear.py:85",
        "launches": path["bilinear_launches"],
        "max_abs_err": bilinear_totals["max_abs_err"],
        "ms": bilinear_totals["ms"],
        "plain_ms": bilinear_totals["plain_ms"],
        "bound_ms": max(bilinear_totals["bytes_ms"], bilinear_totals["flops_ms"]),
        "bound_by": "bytes" if bilinear_totals["bytes_ms"] >= bilinear_totals["flops_ms"]
        else "operations",
        "library_ms": bilinear_totals["library_ms"],
        "library": BILINEAR_LIBRARY,
        "per": (f"one fused_tail: {TAIL_BILINEAR_LAUNCHES} launches (the DINO grid once, the "
                f"depth maps twice), f32 output; launches counted over {RUNS} pipeline runs"),
        "launches_on_new_paths": {
            "video_entry": {k: v["bilinear"] for k, v in video_entry.items()},
            **_export_launches("bilinear", exported, export_entry),
            **_mesh_launches("bilinear", mesh)},
    })
    encoder_ln = norm_rows["tail_encoder_ln"]
    kernels.append({
        "name": "row_norm",
        "route": "cuda",
        "source": "tdspa_torch/csrc/norm.cu",
        "replaces": None,
        "launches": path["norm_launches"],
        "max_row_rel_err": max(r["max_row_rel_err"] for r in norm_rows.values()
                               if "max_row_rel_err" in r),  # the forward rows
        "ms": encoder_ln["ms"],
        "plain_ms": encoder_ln["plain_ms"],
        "bound_ms": encoder_ln["bound_ms"],
        "bound_by": "bytes",
        "library_ms": encoder_ln["library_ms"],
        "library": NORM_LIBRARY,
        "by_shape": {name: {k: r[k] for k in r if k.endswith("ms") or k.endswith("share")}
                     for name, r in norm_rows.items()},
        "per": ("one LayerNorm of the tail's encoder, [309248, 384] f32 -> bf16; launches "
                f"counted over {RUNS} pipeline runs"),
    })
    kernels.append({
        "name": "vit_residual_norm + swiglu_gate",
        "route": "cuda",
        "source": "tdspa_torch/csrc/vit_block.cu",
        "replaces": None,
        "launches": {k: full_launches[k] for k in ("vit_residual_norm", "swiglu_gate")},
        "launches_by_path": {
            "pipeline_full": {k: full_launches[k] for k in ("vit_residual_norm", "swiglu_gate")},
            "vitg_forward": {k: vit_block_rows["vitg_forward"]["launches"][k]
                             for k in ("vit_residual_norm", "swiglu_gate")}},
        "ms": vit_block_rows["block_call"]["ms"],
        "eager_ms": vit_block_rows["block_call"]["eager_ms"],
        "bound_ms": vit_block_rows["block_call"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "by_shape": {name: {k: r[k] for k in r if k.endswith("ms") or k.endswith("share")}
                     for name, r in vit_block_rows["rows"].items()},
        "request": vit_block_rows["request"],
        "vitb_by_shape": {tag: {name: {k: r[k] for k in r if k.endswith("ms") or k.endswith("share")}
                                for name, r in rows.items()}
                          for tag, rows in vit_block_rows["vitb"].items()},
        "per": ("one ViT-g/14 block call on 8 frames (3 row launches and 1 gate); launches "
                f"counted over {RUNS} pipeline runs (ViT-B DINO and depth) and over one 8-frame "
                "ViT-g/14 forward"),
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"],
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if "--matcher_recipe" in sys.argv:  # python3 chip_smoke.py --matcher_recipe OUT.npz [SEED,...]
        phase_device()
        phase_build()
        at = sys.argv.index("--matcher_recipe")
        seeds = sys.argv[at + 2] if len(sys.argv) > at + 2 else "0"
        matcher_recipe(sys.argv[at + 1], [int(x) for x in seeds.split(",")])
        sys.exit(0)
    sys.exit(main())
