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
   (one process per source, in parallel) into ``build/tdspa_torch/``.
3. kernel: the fused attention kernel against its plain PyTorch version
   (``attention_reference``) at the five attention shapes of the 3DSPA
   forward, in both output dtypes, plus edge cases; each with its error
   against the stated tolerance, the kernel's time, the plain version's,
   ``scaled_dot_product_attention``'s (timed only, as a yardstick) and the
   bound (the larger of bytes over 3.35 TB/s and flops over 989 TFLOP/s).
   vit_attention_kernel: the same for the maskless ViT kernel
   (``csrc/vit_attention.cu``) at the DINO and depth backbones' frames,
   (8,1297,12,64) and (8,1370,12,64), and a ragged (2,77|1000,12,64).
4. pipeline: ``InferencePipeline.run_on_frames`` at full width (150 frames
   of 512x512, 4096 tracks, 2048 support, 512 queries, DINO and depth
   features, bf16 model with fused attention, random weights from a seed)
   a few times, counting kernel launches (19 per forward); then the same
   pipeline with the plain attention path, same weights and split, and
   their agreement.
5. lk_kernel: the LK kernel (``tdspa_torch/csrc/lk.cu``) against its plain
   version (``tdspa_torch/ops/lk.py``) on a full-width synthetic scene
   (150 frames of 512x512, 4096 grid points) in four configurations: the
   pipeline's, the tracker's defaults, the cost-volume rescue, and half
   resolution. Tracks within 0.05 px on 99 % of (point, frame) pairs and 99 %
   visibility agreement; kernel, plain and bound times.
6. matcher_kernel: the cost-patch kernel (``csrc/matcher.cu``) against its
   plain version on that scene's real feature map ([150,256,256,16], the
   shipped matcher) at the LK tracks, with 1 and 4 templates, atol 1e-4.
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
   [150,512,512,1] (finite, depth >= 0), 228 ViT kernel launches each, and
   their agreement with the same extractors on plain attention.
10. pipeline_full: ``InferencePipeline()`` with no front end passed in, on
   the clean scene: DINO and depth streamed per upload chunk; per run 456
   ViT, 19 tail attention and 4 LK launches; the streamed features equal
   one whole-video call of the same extractors; tracking quality as in 7;
   ``save_results`` writes the reference's ``predictions.npz``.

With ``--profile``, one more run of each full-width pipeline's stage (and
of each feature extractor) under ``torch.profiler`` reports the device's
busy time and the kernels that take it.

Then one line ``{"kernels": [...]}`` with each kernel's launches on its
main-path run and its totals per forward or video, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a GPU it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from tdspa_torch.eval.tracking_quality import tracking_quality
from tdspa_torch.features import matcher as matcher_lib
from tdspa_torch.features.depth import VideoDepthEstimator
from tdspa_torch.features.dino import DinoFeatureExtractor
from tdspa_torch.features.tracks import PyramidalLKTracker, make_query_grid
from tdspa_torch.infer.pipeline import InferencePipeline, save_results
from tdspa_torch.kernels import build
from tdspa_torch.kernels import lk as lk_kernel
from tdspa_torch.kernels.attention import (
    VIT_HEAD,
    attention_reference,
    fused_masked_attention,
    vit_attention,
)
from tdspa_torch.kernels.matcher import cost_patches_multi, cost_patches_reference
from tdspa_torch.models import TrackAutoEncoder3D
from tdspa_torch.ops.geometry import bilinear_sample
from tdspa_torch.ops.lk import track_video_lk
from tdspa_torch.ops.yuv import rgb_to_yuv420
from tdspa_torch.utils.synthetic_video import make_tracking_scene

SEED = 0
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
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

NUM_FRAMES, HEIGHT, WIDTH, GRID = 150, 512, 512, 64
DINO_GRID = (36, 36, 768)  # the extractor's grid of a 512x512 frame (resized to 504 = 36 x 14)
RUNS = 3
FORWARD_LAUNCHES = 3 + 4 + 4 + 4 + 4  # encoder, latent self, latent cross, decompress, readout

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
}
QUALITY_SLACK = 0.02
EXPECTED_TIERS = {
    "clean": {"stabilize": None, "rescue": None, "denoise": None, "matcher": None},
    "noisy": {"stabilize": None, "rescue": None, "denoise": None, "matcher": True},
}
MATCHER_LAUNCHES = 8  # (2 at M=1 + 2 at M=4) per refinement, and once more for the rescue round
CHUNK_LAUNCHES = -(-NUM_FRAMES // 40)  # the pipeline's 40-frame upload chunks
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


def phase_build() -> None:
    t0 = time.perf_counter()
    seconds = build.build_all()
    ptxas = {
        name: [line.strip() for line in (build.BUILD_DIR / f"{name}.log").read_text().splitlines()
               if "registers" in line or "spill" in line or "entry function" in line][:48]
        for name in build.KERNELS if (build.BUILD_DIR / f"{name}.log").exists()
    }
    emit("build", wall_s=time.perf_counter() - t0, per_source_s=seconds, ptxas=ptxas)


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


def add_per_run(totals: dict, rows: dict, count: int) -> None:
    """Add ``count`` launches' worth of a shape's f32-output row to ``totals``."""
    row, bytes_ms, flops_ms = rows[torch.float32]
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
    totals = new_totals()
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
        library_ms = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=add_mask),
            iters=10,
        )
        rows = compare_attention("kernel", fused_masked_attention,
                                 dict(shape=name, masked=bool(masked)), q, k, v, mask, library_ms)
        if per_forward:
            # One forward's attention work (the pipeline's residual stream is f32).
            add_per_run(totals, rows, per_forward)
        if name == "fully_masked_rows":
            # Item 0 attends to nothing: the kernel returns the mean of its values.
            mean_v = v[0].float().mean(dim=0)  # [H, D]
            got = fused_masked_attention(q, k, v, mask)[0]
            dev = (got - mean_v[None]).abs().max().item()
            emit("kernel_fully_masked_mean", max_abs_dev=dev, atol=KERNEL_ATOL)
            if dev > KERNEL_ATOL:
                raise AssertionError(f"fully masked rows are not the mean of V: {dev}")
        del q, k, v, mask, add_mask, qt, kt, vt
        torch.cuda.empty_cache()
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
        library_ms = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt), iters=10)
        rows = compare_attention(
            "vit_attention_kernel", lambda q, k, v, mask, out_dtype: vit_attention(q, k, v, out_dtype),
            dict(shape=name, per_video=per_video), q, k, v, None, library_ms)
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
    tails, results = [], None
    for _ in range(RUNS):
        results = pipe.run_on_frames(video)
        tails.append(results["timings"]["fused_tail"] * 1e3)
    launches = fused_masked_attention.launches
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
         launches_per_forward=launches / RUNS, shapes=shapes, finite=finite,
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
    if launches != FORWARD_LAUNCHES * RUNS:
        raise AssertionError(
            f"attention kernel launched {launches} times in {RUNS} forwards, "
            f"expected {FORWARD_LAUNCHES * RUNS}"
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
    return {"launches": launches, "pipeline": pipe, "video": video}


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


def phase_lk_kernel(scene) -> dict:
    video = torch.from_numpy(scene["video"]).cuda()
    queries = make_query_grid(HEIGHT, WIDTH, GRID)
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
        emit("lk_kernel", **row)
        if within < LK_MIN_SHARE or vis_agree < LK_MIN_SHARE:
            raise AssertionError(f"LK kernel disagrees with its plain version: {row}")
        rows[name] = row
        if name == "pipeline":
            rows["tracks"] = got_tracks
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
    return {"pipeline": pipe, "video": clean["video"], "lk_launches": launches["lk"],
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


def phase_features(scene, profile: bool = False) -> dict:
    """DINOv2 features and video depth at full width (ViT-B, seeded weights)
    on the clean scene's whole video: the ViT kernel's launches, output
    shapes, depth finite and >= 0, and agreement with the same extractor on
    plain attention; stage times (the second of two calls). With
    ``profile``, one more call of each under the profiler."""
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
        out, ms = _timed_call(kernel, video)
        launches = vit_attention.launches
        _timed_call(plain, video)
        want, plain_ms = _timed_call(plain, video)
        if vit_attention.launches != launches:
            raise AssertionError(f"the plain {name} extractor launched the ViT kernel")
        finite = bool(torch.isfinite(out).all().item())
        row = dict(stage=name, shape=list(out.shape), dtype=str(out.dtype).removeprefix("torch."),
                   launches=launches, ms=ms, plain_ms=plain_ms, finite=finite,
                   min=out.min().item(), max=out.max().item(),
                   vs_plain=dict(_rel_err(out, want), rtol=FEATURES_RTOL))
        emit("features", **row)
        if row["shape"] != expected[name] or not finite or launches != VIT_LAUNCHES:
            raise AssertionError(f"{name} features wrong: {row}")
        if name == "depth" and row["min"] < 0:
            raise AssertionError(f"negative depth: {row}")
        if not row["vs_plain"]["rel_err"] <= FEATURES_RTOL:
            raise AssertionError(f"{name}: kernel and plain attention disagree: {row}")
        rows[name] = row
        del out, want
        if profile:
            phase_profile(name, lambda: kernel(video))
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
    counters = {"vit_attention": vit_attention, "attention": fused_masked_attention,
                "lk": lk_kernel.track_video_lk_kernel, "matcher": cost_patches_multi}
    for fn in counters.values():
        fn.launches = 0
    timings = []
    for _ in range(RUNS):
        results = pipe.run_on_frames(scene["video"])
        timings.append({k: v * 1e3 for k, v in results["timings"].items()})
    launches = {name: fn.launches for name, fn in counters.items()}
    per_run = {"vit_attention": 2 * VIT_LAUNCHES, "attention": FORWARD_LAUNCHES,
               "lk": CHUNK_LAUNCHES, "matcher": 0}
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
    del whole, results, captured
    return {"pipeline": pipe, "launches": launches, "timings": timings}


KERNEL_CLASSES = (  # (class, substrings of a device kernel's name), first match wins
    ("vit_attention", ("vit_attention_kernel",)),
    ("attention", ("attention_fwd_kernel",)),
    ("lk", ("lk_track_kernel",)),
    ("matcher_costs", ("cost_patches_kernel",)),
    ("conv", ("conv", "implicit", "winograd", "cudnn", "fprop", "dgrad")),
    ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "Kernel2")),
    ("gather", ("index", "gather")),
    ("reduce", ("reduce_kernel",)),
    ("memcpy", ("Memcpy", "Memset")),
    ("elementwise", ("elementwise", "copy_kernel", "CatArray", "softmax")),
)


def phase_profile(stage: str, run, wall_ms=None, top: int = 15) -> None:
    """One more run of a stage under torch.profiler (``--profile`` only):
    device time by kernel class, the kernels that take most of it, and the
    stage's device busy share (its kernel time over its wall time; the
    profiler's host overhead lowers it). ``wall_ms`` reads the stage's own
    timing after the run (a pipeline's ``timings``); without it the wall
    time is the host clock around ``run``, synchronised."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        clock_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and not e.key.startswith("Activity Buffer")]
    device.sort(key=lambda e: e.self_device_time_total, reverse=True)
    classes: dict[str, float] = {}
    for e in device:
        name = next((c for c, keys in KERNEL_CLASSES if any(k in e.key for k in keys)), "other")
        classes[name] = classes.get(name, 0.0) + e.self_device_time_total / 1e3
    wall = wall_ms() if wall_ms is not None else clock_ms
    kernel_ms = sum(v for k, v in classes.items() if k != "memcpy")
    emit("profile", stage=stage, wall_ms=wall, kernel_ms=kernel_ms, by_class_ms=classes,
         device_busy_share=kernel_ms / wall,
         top_kernels=[{"name": e.key[:100], "calls": e.count,
                       "device_ms": e.self_device_time_total / 1e3} for e in device[:top]])


def profile_pipeline(pipe, video, stage: str) -> None:
    """``fused_tail``: a whole ``run_on_frames`` with given front ends, whose
    other stages launch no kernels (the video upload is a copy);
    ``upload_tracking_features``: the streamed upload, tracking and the
    streamed features alone."""
    run = pipe.run_on_frames if stage == "fused_tail" else pipe._streamed_upload_and_tracking
    phase_profile(stage, lambda: run(video), wall_ms=lambda: pipe.timings[stage] * 1e3)


def main(argv: list[str]) -> int:
    info = phase_device()
    phase_build()
    totals = phase_kernel()
    vit_totals = phase_vit_kernel()
    path = phase_pipeline()
    if "--profile" in argv:
        profile_pipeline(path["pipeline"], path["video"], "fused_tail")
    del path["pipeline"]
    scenes = make_scenes()
    lk = phase_lk_kernel(scenes["clean"])
    matcher = phase_matcher_kernel(scenes["clean"], lk.pop("tracks"))
    phase_tracking(scenes)
    tracked = phase_pipeline_tracked(scenes)
    if "--profile" in argv:
        profile_pipeline(tracked["pipeline"], tracked["video"], "upload_tracking_features")
    del tracked["pipeline"]
    torch.cuda.empty_cache()
    phase_features(scenes["clean"], profile="--profile" in argv)
    full = phase_pipeline_full(scenes["clean"])
    if "--profile" in argv:
        profile_pipeline(full["pipeline"], scenes["clean"]["video"], "upload_tracking_features")
    bound_by = "bytes" if totals["bytes_ms"] >= totals["flops_ms"] else "operations"
    kernels = [{
        "name": "fused_masked_attention",
        "route": "cuda",
        "source": "tdspa_torch/csrc/attention.cu",
        "replaces": "tdspa/kernels/attention.py:382",
        "also_replaces": "tdspa/kernels/attention.py:310",
        "launches": path["launches"],
        "max_abs_err": totals["max_abs_err"],
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": max(totals["bytes_ms"], totals["flops_ms"]),
        "bound_by": bound_by,
        "library_ms": totals["library_ms"],
        "per": "one forward: the 19 launches at their main-path shapes, f32 output",
    }]
    main_lk = lk["pipeline"]
    kernels.append({
        "name": "track_video_lk_kernel",
        "route": "cuda",
        "source": "tdspa_torch/csrc/lk.cu",
        "replaces": "tdspa/kernels/lk.py:787",
        "launches": tracked["lk_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in lk.values()),
        "ms": main_lk["ms"],
        "plain_ms": main_lk["plain_ms"],
        "bound_ms": main_lk["bound_ms"],
        "bound_by": main_lk["bound_by"],
        "library_ms": None,
        "per": ("one launch over the whole 150-frame video in the pipeline's configuration "
                f"(the streamed pipeline makes {CHUNK_LAUNCHES} per video, one per chunk); "
                f"launches counted over {tracked['runs']} clean-video pipeline runs"),
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
        "per": ("one matcher pass over a video (4 launches with 1 template and 4 with 4, "
                "4096 points x 150 frames); launches counted over the noisy-video pipeline run"),
    })
    kernels.append({
        "name": "vit_attention",
        "route": "cuda",
        "source": "tdspa_torch/csrc/vit_attention.cu",
        "replaces": "tdspa/kernels/attention.py:214",
        "launches": full["launches"]["vit_attention"],
        "max_abs_err": vit_totals["max_abs_err"],
        "ms": vit_totals["ms"],
        "plain_ms": vit_totals["plain_ms"],
        "bound_ms": max(vit_totals["bytes_ms"], vit_totals["flops_ms"]),
        "bound_by": "bytes" if vit_totals["bytes_ms"] >= vit_totals["flops_ms"] else "operations",
        "library_ms": vit_totals["library_ms"],
        "per": (f"one 150-frame video: {VIT_LAUNCHES} launches at (8,1297,12,64) for DINO and "
                f"{VIT_LAUNCHES} at (8,1370,12,64) for depth, f32 output; launches counted over "
                f"{RUNS} full-pipeline runs"),
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"],
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
