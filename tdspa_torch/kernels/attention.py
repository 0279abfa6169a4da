"""Multi-head attention: CUDA kernel wrappers + their plain version.

Replaces the TPU kernels of ``tdspa/kernels/attention.py``:

* on the 3DSPA path, ``_fused_forward`` / ``_mha_kernel`` (whole KV per
  batch tile) and ``_flash_attention`` / ``_mha_flash_kernel`` (KV-blocked
  online softmax). One Hopper kernel, ``tdspa_torch/csrc/attention.cu``,
  computes both (``fused_masked_attention``): it loops over 64-key tiles
  with an f32 online softmax, so the TPU's VMEM-fit dispatch
  (``fused_attention_fits``, ``_pick_kv_block``, ``_pick_tile``) has no
  counterpart. Device-memory bytes bound it on an H100 (see the source's
  note); it keeps the [S, K] logits and probabilities on chip, and its
  persistent blocks keep TMA loads in flight ahead of three ``wgmma``
  warpgroups. ``work_plan`` says how a call is divided; a small batch over
  many keys runs as two CUDA kernels (key chunks, then their merge).
* in the DINOv2 and VDA ViTs, ``_flash_perhead`` /
  ``_mha_flash_perhead_kernel`` (maskless, about 1.3k tokens per frame,
  head width 64): ``tdspa_torch/csrc/vit_attention.cu`` (``vit_attention``),
  which operations bound on an H100: TMA loads from a producer warp, two
  consumer warpgroups on ``wgmma`` with the softmax of one tile under the
  P.V of the last (FlashAttention-3's shape).

Both wrappers launch their kernel for CUDA tensors and run
``attention_reference`` for CPU tensors; neither falls back from one to the
other. Each counts its own launches. Both are forward-only, as the Pallas
kernels are. ``fused_masked_attention`` goes through the custom op
``tdspa::fused_masked_attention`` (``kernels/ops.py``), which
``torch.export`` keeps in an exported program. Training differentiates
through ``fused_attention_fn``, the port of JAX's ``fused_attention`` (a
``custom_vjp``): its forward is ``fused_masked_attention`` with f32 output,
its backward ``attention_backward``, the VJP of ``xla_reference`` (JAX's
``_xla_reference``, which JAX's ``_fused_bwd`` recomputes under ``jax.vjp``
and XLA fuses). On CUDA tensors that is the Hopper kernel
``tdspa_torch/csrc/attention_backward.cu``, which recomputes the
probabilities from the saved inputs instead of keeping them; on CPU tensors
its plain version, ``attention_backward_reference``.
"""

from __future__ import annotations

import math

import torch

from tdspa_torch.kernels import build
from tdspa_torch.kernels.build import forward_only, on_cuda, records

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


def _kernel_takes(q, k, v, depth_ok: bool, depths: str):
    """The attention kernels' common limits: bf16 q/k/v, a head width they
    take (``depth_ok``, described by ``depths``), S and K > 0."""
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"kernel takes bf16 q/k/v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not depth_ok or q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError(f"kernel takes {depths} and S, K > 0; got {tuple(q.shape)}")


def _contiguous_aligned(*tensors):
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in tensors):
        raise ValueError("kernel takes contiguous, 16-byte aligned q/k/v (and g)")


QUERY_ROWS = 192  # query rows per work item of csrc/attention.cu (three warpgroups of 64)
KEY_TILE = 64  # keys per ring stage
SPLIT_MIN_TILES = 4  # split the keys only when an item walks at least this many tiles


def work_plan(batch: int, seq: int, kv_len: int, heads: int, sms: int) -> dict:
    """How ``csrc/attention.cu`` divides one call: work items are (item,
    head, 192 query rows, key chunk), walked by ``grid`` persistent blocks.

    The keys stay whole (one chunk) unless the (item, head, row tile) items
    are fewer than the SMs and each walks at least ``SPLIT_MIN_TILES`` key
    tiles (the B = 1 cross-attention over 2048 keys): then they are split
    into chunks of ``chunk_tiles`` tiles so that the items fill the card,
    and a second CUDA kernel merges the chunks (``cuda_kernels`` = 2).
    """
    row_tiles = -(-seq // QUERY_ROWS)
    tiles = -(-kv_len // KEY_TILE)
    items = batch * heads * row_tiles
    chunk_tiles = tiles
    if items < sms and tiles >= SPLIT_MIN_TILES:
        chunk_tiles = -(-tiles // -(-sms // items))
    chunks = -(-tiles // chunk_tiles)
    work = items * chunks
    return {"row_tiles": row_tiles, "chunk_tiles": chunk_tiles, "chunks": chunks, "work": work,
            "grid": min(work, sms), "cuda_kernels": 1 if chunks == 1 else 2}


def fused_masked_attention(q, k, v, key_mask=None, out_dtype=torch.float32):
    """Fused attention: q [B,S,H,D], k/v [B,K,H,D], key_mask [B,K] -> [B,S,H,D].

    Runs the custom op ``tdspa::fused_masked_attention`` (``kernels/ops.py``).
    CUDA tensors launch the Hopper kernel, which takes contiguous bf16
    q/k/v with D a multiple of 8 up to 128 and a bool or float key mask;
    anything else raises. CPU tensors run ``attention_reference`` (directly
    where autograd records, since the op has no autograd formula).
    ``fused_masked_attention.launches`` counts kernel launches.
    """
    from tdspa_torch.kernels import ops

    _check(q, k, v, key_mask, out_dtype)
    if not on_cuda("fused_masked_attention", q, k, v, key_mask):
        if records(q, k, v):
            return attention_reference(q, k, v, key_mask, out_dtype)
        return ops.fused_masked_attention(q, k, v, key_mask, out_dtype)
    _kernel_takes(q, k, v, q.shape[-1] % 8 == 0 and 8 <= q.shape[-1] <= 128,
                  "D in 8..128 (multiple of 8)")
    forward_only("fused_masked_attention (differentiate through fused_attention_fn)", q, k, v)
    if key_mask is not None and key_mask.dtype != torch.bool:
        key_mask = key_mask != 0
    return ops.fused_masked_attention(q, k, v, key_mask, out_dtype)


def launch(q, k, v, key_mask, out_dtype):
    """The kernel's launch on checked CUDA operands (the op's CUDA
    implementation): contiguous, 16-byte aligned bf16 q/k/v, a bool key mask
    or None."""
    _contiguous_aligned(q, k, v)
    batch, seq, heads, depth = q.shape
    kv_len = k.shape[1]
    if key_mask is not None:
        key_mask = key_mask.contiguous()
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    if out.numel() == 0:
        return out
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = work_plan(batch, seq, kv_len, heads, sms)
    part_o = part_ml = None
    if plan["chunks"] > 1:  # the key chunks' partial (O, m, l), merged by the second kernel
        rows = plan["chunks"] * batch * seq * heads
        part_o = torch.empty((rows, depth), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((rows, 2), dtype=torch.float32, device=q.device)
    build.launch(
        "tdspa_attention_forward", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        key_mask.data_ptr() if key_mask is not None else None,
        out.data_ptr(), None if part_o is None else part_o.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(), int(out_dtype == torch.bfloat16),
        batch, seq, kv_len, heads, depth, plan["chunk_tiles"], plan["grid"],
        1.0 / math.sqrt(depth),
    )
    fused_masked_attention.launches += 1
    return out


fused_masked_attention.launches = 0

VIT_ROWS = 128  # query rows per block of csrc/vit_attention.cu (two warpgroups of 64)
VIT_HEAD = 64  # the head width it takes (every DINOv2 preset)


def vit_attention(q, k, v, out_dtype=torch.float32):
    """Maskless attention of ViT frames: q [B,S,H,D], k/v [B,K,H,D] -> [B,S,H,D].

    CUDA tensors launch the Hopper kernel, which takes contiguous bf16
    q/k/v with D = 64; anything else raises. CPU tensors run
    ``attention_reference(q, k, v, None)``. ``vit_attention.launches``
    counts kernel launches (apart from ``fused_masked_attention``'s).
    """
    _check(q, k, v, None, out_dtype)
    if not on_cuda("vit_attention", q, k, v):
        return attention_reference(q, k, v, None, out_dtype)
    _kernel_takes(q, k, v, q.shape[-1] == VIT_HEAD, f"D = {VIT_HEAD}")
    _contiguous_aligned(q, k, v)
    forward_only("vit_attention", q, k, v)
    batch, seq, heads, depth = q.shape
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    if out.numel() == 0:
        return out
    build.launch(
        "tdspa_vit_attention_forward", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), int(out_dtype == torch.bfloat16), batch, seq, k.shape[1], heads, depth,
        -(-seq // VIT_ROWS), 1.0 / math.sqrt(depth),
    )
    vit_attention.launches += 1
    return out


vit_attention.launches = 0


def xla_reference(q, k, v, key_mask=None):
    """JAX's ``_xla_reference`` (``tdspa/kernels/attention.py:543-560``), the
    function its ``fused_attention`` backward differentiates.

    q is rounded to bf16 and divided by sqrt(D) rounded to bf16, in bf16;
    products of bf16 values accumulate in f32; masked logits are
    ``finfo(f32).min``; f32 softmax; probabilities rounded to bf16 before P.V;
    f32 out. The kernel instead scales the f32 logits by 1/sqrt(D): at D = 64
    the two agree exactly (sqrt(64) = 8 in bf16), at D = 96 bf16 sqrt(96) is
    9.8125 against 9.798, so the recompute's logits are 0.15 % smaller than
    the forward's. The backward follows JAX's recompute, not the forward.
    """
    qs = q.to(torch.bfloat16) / _root(q.shape[-1], q.device)
    logits = torch.einsum("...qhd,...khd->...hqk", qs.float(), k.to(torch.bfloat16).float())
    if key_mask is not None:
        attend = (key_mask != 0)[..., None, None, :]
        logits = torch.where(attend, logits, _FILL)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("...hqk,...khd->...qhd", probs.to(torch.bfloat16).float(),
                        v.to(torch.bfloat16).float())


def _root(depth: int, device) -> torch.Tensor:
    """bf16(sqrt(D)), JAX's ``jnp.sqrt(depth).astype(bfloat16)``."""
    return torch.tensor(math.sqrt(depth), dtype=torch.float32).to(torch.bfloat16).to(device)


def attention_backward_reference(q, k, v, key_mask, g, needs=(True, True, True)):
    """Plain PyTorch version of the backward kernel: the VJP of
    ``xla_reference`` for the cotangent g [B,S,H,D], written out at JAX's
    rounding points. Returns (dq, dk, dv) in the inputs' dtypes, None where
    ``needs`` is False.

    qs = bf16(q) / bf16(sqrt(D)) in bf16; logits qs.k^T in f32 (masked keys
    ``finfo(f32).min``); the row max m and sum l, P = exp(s - m) / l in f32;
    dP = g.v^T rounded to bf16 (the cotangent of bf16 P); D_ = rowsum(dP P);
    dS = P (dP - D_), zero at masked keys; dq = bf16(bf16(dS.k) / bf16(sqrt(D))),
    dk = bf16(dS^T.qs), dv = bf16(bf16(P)^T.g).
    """
    root = _root(q.shape[-1], q.device)
    qs = q.to(torch.bfloat16) / root
    kf, vf, gf = k.to(torch.bfloat16).float(), v.to(torch.bfloat16).float(), g.float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qs.float(), kf)
    attend = None
    if key_mask is not None:
        attend = (key_mask != 0)[:, None, None, :]
        logits = torch.where(attend, logits, _FILL)
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    probs = e / e.sum(dim=-1, keepdim=True)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf).to(torch.bfloat16).float()
    ds = probs * (dp - (dp * probs).sum(dim=-1, keepdim=True))
    if attend is not None:
        ds = torch.where(attend, ds, 0.0)
    dq = dk = dv = None
    if needs[0]:
        dqs = torch.einsum("bhqk,bkhd->bqhd", ds, kf).to(torch.bfloat16)
        dq = (dqs / root).to(q.dtype)
    if needs[1]:
        dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs.float()).to(torch.bfloat16).to(k.dtype)
    if needs[2]:
        dv = torch.einsum("bhqk,bqhd->bkhd", probs.to(torch.bfloat16).float(), gf)
        dv = dv.to(torch.bfloat16).to(v.dtype)
    return dq, dk, dv


def backward_rows(depth: int) -> int:
    """Query rows and keys of one work item of ``csrc/attention_backward.cu``:
    192 (three warpgroups of 64) for D <= 96, 128 for D > 96, where four
    192-row tiles of q, g, k, v and dS^T would not fit the SM's shared memory."""
    return 192 if depth <= 96 else 128


def backward_chunks(seq: int, kv_len: int, depth: int) -> tuple[int, int]:
    """(query chunks, key chunks) of ``csrc/attention_backward.cu``: a work
    item takes up to ``backward_rows(depth)`` query rows and keys. More than
    one key chunk runs a row-statistics pass first and sums f32 partials of dq
    in a last CUDA kernel; more than one query chunk, those of dk and dv."""
    rows = backward_rows(depth)
    return -(-seq // rows), -(-kv_len // rows)


def attention_backward(q, k, v, key_mask, g, needs=(True, True, True)):
    """The backward of ``fused_attention_fn``: (dq, dk, dv) for the cotangent
    g [B,S,H,D] of its f32 output, None where ``needs`` is False.

    CUDA tensors launch ``csrc/attention_backward.cu`` (bf16 q/k/v with D a
    multiple of 8 up to 128, bool or float key mask; g is made contiguous
    f32); anything else raises, and a failed launch raises ``RuntimeError``.
    CPU tensors run ``attention_backward_reference``.
    ``attention_backward.launches`` counts kernel launches.
    """
    _check(q, k, v, key_mask, torch.float32)
    if g.shape != q.shape:
        raise ValueError(f"g must be {tuple(q.shape)}, got {tuple(g.shape)}")
    if not on_cuda("attention_backward", q, k, v, key_mask, g):
        return attention_backward_reference(q, k, v, key_mask, g, needs)
    _kernel_takes(q, k, v, q.shape[-1] % 8 == 0 and 8 <= q.shape[-1] <= 128,
                  "D in 8..128 (multiple of 8)")
    batch, seq, heads, depth = q.shape
    kv_len = k.shape[1]
    g = g.float().contiguous()
    if key_mask is not None:
        key_mask = (key_mask if key_mask.dtype == torch.bool else key_mask != 0).contiguous()
    _contiguous_aligned(q, k, v, g)
    grads = [torch.empty(x.shape, dtype=torch.bfloat16, device=q.device) if n else None
             for x, n in zip((q, k, v), needs)]
    if not any(needs):
        return tuple(grads)
    q_chunks, k_chunks = backward_chunks(seq, kv_len, depth)
    parts = [None, None, None, None]
    if k_chunks > 1 and needs[0]:
        parts[0] = torch.empty((k_chunks, *q.shape), dtype=torch.float32, device=q.device)
    for i in (1, 2):
        if q_chunks > 1 and needs[i]:
            parts[i] = torch.empty((q_chunks, *k.shape), dtype=torch.float32, device=q.device)
    if k_chunks > 1:  # the row-statistics pass's (m, l, sum P dP) per key chunk
        parts[3] = torch.empty((k_chunks, batch, heads, seq, 4), dtype=torch.float32,
                               device=q.device)
    ptr = [None if t is None else t.data_ptr() for t in (*grads, *parts)]
    build.launch(
        "tdspa_attention_backward", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        key_mask.data_ptr() if key_mask is not None else None, g.data_ptr(), *ptr,
        batch, seq, kv_len, heads, depth, float(_root(depth, "cpu")),
    )
    attention_backward.launches += 1
    return tuple(grads)


attention_backward.launches = 0


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask):
        ctx.save_for_backward(q, k, v, key_mask)
        return fused_masked_attention(q, k, v, key_mask, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, key_mask = ctx.saved_tensors
        return (*attention_backward(q, k, v, key_mask, grad, tuple(ctx.needs_input_grad[:3])),
                None)


def fused_attention_fn(q, k, v, key_mask=None):
    """Differentiable fused attention: q [B,S,H,D], k/v [B,K,H,D], key_mask
    [B,K] -> f32 [B,S,H,D] (JAX's ``fused_attention``).

    Forward: ``fused_masked_attention`` (the kernel on CUDA tensors, its plain
    version on CPU tensors). Backward: ``attention_backward`` on the saved
    inputs (the backward kernel on CUDA tensors, ``attention_backward_reference``
    on CPU tensors), JAX's recompute of the probabilities instead of keeping
    them. The key mask gets no gradient.
    """
    return _FusedAttention.apply(q, k, v, key_mask)
