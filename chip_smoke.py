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
4. pipeline: ``InferencePipeline.run_on_frames`` at full width (150 frames
   of 512x512, 4096 tracks, 2048 support, 512 queries, DINO and depth
   features, bf16 model with fused attention, random weights from a seed)
   a few times, counting kernel launches (19 per forward); then the same
   pipeline with the plain attention path, same weights and split, and
   their agreement.

With ``--profile``, one more full-width run under ``torch.profiler`` reports
the device's busy time and the kernels that take it.

Then one line ``{"kernels": [...]}`` with each kernel's totals over one
forward, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a GPU it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from tdspa_torch.infer.pipeline import InferencePipeline
from tdspa_torch.kernels import build
from tdspa_torch.kernels.attention import attention_reference, fused_masked_attention
from tdspa_torch.models import TrackAutoEncoder3D

SEED = 0
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
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

NUM_FRAMES, HEIGHT, WIDTH, GRID = 150, 512, 512, 64
DINO_GRID = (37, 37, 768)
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


def phase_kernel() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    totals = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
              "bytes_ms": 0.0, "flops_ms": 0.0}
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
        for out_dtype in (torch.float32, torch.bfloat16):
            got = fused_masked_attention(q, k, v, mask, out_dtype=out_dtype)
            torch.cuda.synchronize()
            want = attention_reference(q, k, v, mask, out_dtype=out_dtype)
            err = (got.float() - want.float()).abs()
            rtol = KERNEL_RTOL_BF16_OUT if out_dtype == torch.bfloat16 else 0.0
            excess = (err - KERNEL_ATOL - rtol * want.float().abs()).max().item()
            finite = bool(torch.isfinite(got).all().item())
            out_bytes = 4 if out_dtype == torch.float32 else 2
            bytes_ms, flops_ms = attention_bound(batch, seq, kv_len, heads, depth, masked, out_bytes)
            bound_ms = max(bytes_ms, flops_ms)
            bound_by = "bytes" if bytes_ms >= flops_ms else "operations"
            ms = cuda_ms(lambda: fused_masked_attention(q, k, v, mask, out_dtype=out_dtype), iters=20)
            plain_ms = cuda_ms(lambda: attention_reference(q, k, v, mask, out_dtype=out_dtype), iters=5)
            row = dict(
                shape=name, B=batch, S=seq, K=kv_len, H=heads, D=depth,
                masked=bool(masked), out_dtype=str(out_dtype).removeprefix("torch."),
                max_abs_err=err.max().item(), atol=KERNEL_ATOL, rtol=rtol, finite=finite,
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, roofline_share=bound_ms / ms,
            )
            emit("kernel", **row)
            if not finite or excess > 0:
                raise AssertionError(f"attention kernel disagrees with its plain version: {row}")
            if out_dtype == torch.float32 and per_forward:
                # One forward's attention work (the pipeline's residual stream is f32).
                totals["max_abs_err"] = max(totals["max_abs_err"], row["max_abs_err"])
                for key, value in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                                   ("bytes_ms", bytes_ms), ("flops_ms", flops_ms)):
                    totals[key] += per_forward * value
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


KERNEL_CLASSES = (  # (class, substrings of a device kernel's name), first match wins
    ("attention", ("attention_fwd_kernel",)),
    ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "Kernel2")),
    ("gather", ("index", "gather")),
    ("reduce", ("reduce_kernel",)),
    ("memcpy", ("Memcpy", "Memset")),
    ("elementwise", ("elementwise", "copy_kernel", "CatArray", "softmax")),
)


def phase_profile(pipe, video, top: int = 15) -> None:
    """One more run under torch.profiler: device time by kernel class and the
    kernels that take most of it (``--profile`` only). The run's other stages
    launch no kernels, so kernel time over the ``fused_tail`` wall time is the
    tail's device busy share (the profiler's host overhead lowers it)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        results = pipe.run_on_frames(video)
    device = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and not e.key.startswith("Activity Buffer")]
    device.sort(key=lambda e: e.self_device_time_total, reverse=True)
    classes: dict[str, float] = {}
    for e in device:
        name = next((c for c, keys in KERNEL_CLASSES if any(k in e.key for k in keys)), "other")
        classes[name] = classes.get(name, 0.0) + e.self_device_time_total / 1e3
    tail_ms = results["timings"]["fused_tail"] * 1e3
    kernel_ms = sum(v for k, v in classes.items() if k != "memcpy")
    emit("profile", fused_tail_wall_ms=tail_ms, kernel_ms=kernel_ms, by_class_ms=classes,
         tail_device_busy_share=kernel_ms / tail_ms,
         top_kernels=[{"name": e.key[:100], "calls": e.count,
                       "device_ms": e.self_device_time_total / 1e3} for e in device[:top]])


def main(argv: list[str]) -> int:
    info = phase_device()
    phase_build()
    totals = phase_kernel()
    path = phase_pipeline()
    if "--profile" in argv:
        phase_profile(path["pipeline"], path["video"])
    bound_by = "bytes" if totals["bytes_ms"] >= totals["flops_ms"] else "operations"
    print(json.dumps({"kernels": [{
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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"],
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
