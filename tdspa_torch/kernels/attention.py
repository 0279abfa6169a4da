"""Multi-head attention: CUDA kernel wrappers + their plain version.

Replaces the TPU kernels of ``tdspa/kernels/attention.py``:

* on the 3DSPA path, ``_fused_forward`` / ``_mha_kernel`` (whole KV per
  batch tile) and ``_flash_attention`` / ``_mha_flash_kernel`` (KV-blocked
  online softmax). One Hopper kernel, ``tdspa_torch/csrc/attention.cu``,
  computes both (``fused_masked_attention``): it loops over 64-key tiles
  with an f32 online softmax, so the TPU's VMEM-fit dispatch
  (``fused_attention_fits``, ``_pick_kv_block``, ``_pick_tile``) has no
  counterpart. Device-memory bytes bound it on an H100 (see the source's
  note); it keeps the [S, K] logits and probabilities on chip.
* in the DINOv2 and VDA ViTs, ``_flash_perhead`` /
  ``_mha_flash_perhead_kernel`` (maskless, about 1.3k tokens per frame,
  head width 64): ``tdspa_torch/csrc/vit_attention.cu`` (``vit_attention``),
  which operations bound on an H100.

Both wrappers launch their kernel for CUDA tensors and run
``attention_reference`` for CPU tensors; neither falls back from one to the
other. Each counts its own launches. Forward only: the training slice adds
the backward.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from tdspa_torch.kernels import build

_FILL = torch.finfo(torch.float32).min


def attention_reference(q, k, v, key_mask=None, out_dtype=torch.float32):
    """Plain PyTorch version of the kernel's function.

    q [B,S,H,D], k/v [B,K,H,D] (rounded to bf16), key_mask [B,K] (nonzero =
    attend) or None -> [B,S,H,D] in ``out_dtype``. bf16 products with f32
    accumulation, logits scaled in f32, masked logits filled with
    ``finfo(f32).min`` (a fully masked row averages all values), f32 softmax,
    probabilities rounded to bf16 before P.V.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf = (x.to(torch.bfloat16).float() for x in (q, k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if key_mask is not None:
        attend = (key_mask != 0)[:, None, None, :]
        logits = logits.masked_fill(~attend, _FILL)
    probs = torch.softmax(logits, dim=-1).to(torch.bfloat16).float()
    return torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(out_dtype)


def _check(q, k, v, key_mask, out_dtype):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"expected q [B,S,H,D] and k, v [B,K,H,D]; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(
            f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in batch, heads or width"
        )
    if key_mask is not None and tuple(key_mask.shape) != (k.shape[0], k.shape[1]):
        raise ValueError(
            f"key_mask must be [B,K] = {(k.shape[0], k.shape[1])}, got {tuple(key_mask.shape)}"
        )
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    devices = {t.device for t in (q, k, v)} | (
        {key_mask.device} if key_mask is not None else set()
    )
    if len(devices) != 1:
        raise ValueError(f"q, k, v and key_mask lie on different devices: {devices}")


def _launch_shape(batch: int, seq: int, heads: int, sms: int) -> tuple[int, int]:
    """(query blocks per (item, head), warps per block).

    A warp owns 16 query rows and a block at most 8 warps. Blocks that share
    an (item, head) share nothing, so a large batch gets as few query
    blocks as fit the rows (K/V staged once per 8 warps); a small batch
    splits its rows over more blocks, down to one warp each, to reach about
    two blocks per SM.
    """
    row_tiles = -(-seq // 16)
    q_blocks = max(-(-row_tiles // 8), min(row_tiles, -(-2 * sms // (batch * heads))))
    return q_blocks, -(-row_tiles // q_blocks)


# tdspa_attention_forward(q, k, v, mask, out, out_bf16, B, S, K, H, D,
#                         q_blocks, warps, scale, stream) in csrc/attention.cu.
ARGTYPES = (
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
)


@functools.cache
def _kernel():
    fn = build.load("attention").tdspa_attention_forward
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def fused_masked_attention(q, k, v, key_mask=None, out_dtype=torch.float32):
    """Fused attention: q [B,S,H,D], k/v [B,K,H,D], key_mask [B,K] -> [B,S,H,D].

    CUDA tensors launch the Hopper kernel, which takes contiguous bf16
    q/k/v with D a multiple of 8 up to 128 and a bool or float key mask;
    anything else raises. CPU tensors run ``attention_reference``.
    ``fused_masked_attention.launches`` counts kernel launches.
    """
    _check(q, k, v, key_mask, out_dtype)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, key_mask, out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"kernel takes bf16 q/k/v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("kernel takes contiguous, 16-byte aligned q/k/v")
    batch, seq, heads, depth = q.shape
    kv_len = k.shape[1]
    if depth % 8 or not 8 <= depth <= 128 or seq == 0 or kv_len == 0:
        raise ValueError(f"kernel takes D in 8..128 (multiple of 8) and S, K > 0; got {tuple(q.shape)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "fused_masked_attention is forward-only; the backward comes with "
            "the training slice (ROADMAP.md queue 1, item 10)"
        )
    if key_mask is not None:
        if key_mask.dtype != torch.bool:
            key_mask = key_mask != 0
        key_mask = key_mask.contiguous()
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    if out.numel() == 0:
        return out
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    q_blocks, warps = _launch_shape(batch, seq, heads, sms)
    fn = _kernel()
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            key_mask.data_ptr() if key_mask is not None else None,
            out.data_ptr(), int(out_dtype == torch.bfloat16),
            batch, seq, kv_len, heads, depth, q_blocks, warps,
            1.0 / math.sqrt(depth), torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {rc}")
    fused_masked_attention.launches += 1
    return out


fused_masked_attention.launches = 0

VIT_ROWS = 128  # query rows per block of csrc/vit_attention.cu (8 warps of 16)
VIT_HEAD = 64  # the head width it takes (every DINOv2 preset)
# tdspa_vit_attention_forward(q, k, v, out, out_bf16, B, S, K, H, D,
#                             q_blocks, scale, stream) in csrc/vit_attention.cu.
VIT_ARGTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
)


@functools.cache
def _vit_kernel():
    fn = build.load("vit_attention").tdspa_vit_attention_forward
    fn.argtypes = VIT_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def vit_attention(q, k, v, out_dtype=torch.float32):
    """Maskless attention of ViT frames: q [B,S,H,D], k/v [B,K,H,D] -> [B,S,H,D].

    CUDA tensors launch the Hopper kernel, which takes contiguous bf16
    q/k/v with D = 64; anything else raises. CPU tensors run
    ``attention_reference(q, k, v, None)``. ``vit_attention.launches``
    counts kernel launches (apart from ``fused_masked_attention``'s).
    """
    _check(q, k, v, None, out_dtype)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, None, out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"kernel takes bf16 q/k/v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("kernel takes contiguous, 16-byte aligned q/k/v")
    batch, seq, heads, depth = q.shape
    kv_len = k.shape[1]
    if depth != VIT_HEAD or seq == 0 or kv_len == 0:
        raise ValueError(f"kernel takes D = {VIT_HEAD} and S, K > 0; got {tuple(q.shape)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "vit_attention is forward-only; the backward comes with the "
            "training slice (ROADMAP.md queue 1, item 10)"
        )
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = _vit_kernel()
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.bfloat16), batch, seq, kv_len, heads, depth,
            -(-seq // VIT_ROWS), 1.0 / math.sqrt(depth),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"ViT attention kernel launch failed: CUDA error {rc}")
    vit_attention.launches += 1
    return out


vit_attention.launches = 0
