"""Dynamic-int8 matrix product: CUDA kernel wrapper + its plain version.

Replaces the TPU kernel ``tdspa/kernels/quant_matmul.py::_quant_matmul_pallas``
(body ``_quant_matmul_kernel``): ``y = int8(x / sx) . int8(W / sw) * sx * sw``
with per-row activation scales ``sx = max(amax, 1e-30) * f32(1/127)``
computed from x upcast to f32, per-column weight scales computed outside the kernel,
exact integer accumulation and f32 output. The Hopper kernels
(``tdspa_torch/csrc/quant_matmul.cu``) run in two launches: a quantise pass
that reads x once and writes int8 rows and their scales into scratch, then
a persistent TMA + ``wgmma`` GEMM that dequantises in its epilogue. They
take every shape of the 3DSPA forward, so the TPU's VMEM-fit dispatch
(``quant_matmul_fits``, ``_pick_bm``) has no counterpart.

``quant_matmul`` launches the kernels for CUDA tensors and runs
``quant_matmul_reference`` for CPU tensors, through the custom op
``tdspa::quant_matmul`` (``kernels/ops.py``), whose CUDA implementation
caches the quantised weights; it never falls back from one to the other.
``quant_matmul.launches`` counts its products (each one quantise pass and
one GEMM).
"""

from __future__ import annotations

import torch
from torch.utils.weak import WeakIdKeyDictionary

from tdspa_torch.kernels import build
from tdspa_torch.kernels.build import forward_only, on_cuda, records

ROWS = 128  # output rows per GEMM tile of csrc/quant_matmul.cu (two warpgroups of 64)
BN_CHOICES = (64, 128)  # output columns per GEMM tile
MAX_K = 3072  # the quantise pass holds a row in registers: 24 float4 per lane


# XLA rewrites a division by a constant into a product with the constant's
# f32 reciprocal, so the JAX package's jitted ``max(amax, 1e-30) / 127.0`` is
# ``max(amax, 1e-30) * f32(1/127)``; the port computes that product. The
# division x / scale is a true (IEEE) division on both sides.
INV_127 = 1.0 / 127.0


def dynamic_int8(x: torch.Tensor, dim: int):
    """Symmetric int8 quantisation with one scale per slice along ``dim``.

    The port of ``tdspa/core/quant.py::_dynamic_int8`` as XLA compiles it,
    for an f32 x (the port quantises only f32 values: the weights and the
    activations upcast to f32): ``scale = max(max|x|, 1e-30) * f32(1/127)``
    (kept with a size-1 ``dim``), ``q = clip(round(x / scale), -127, 127)``
    with round half to even. Returns (q int8, scale f32).
    """
    amax = x.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp(amax, min=1e-30) * INV_127
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def quant_matmul_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel's function: x [..., K] @ w [K, N] -> [..., N] f32.

    As the TPU kernel, x is upcast to f32 before its amax, divide, round and
    clip (``_dynamic_int8`` on a bf16 x would round in bf16); the weight is
    quantised per column. The integer products are summed in f64, which is
    exact here (|sum| <= 127^2 K < 2^53), then dequantised as (acc * sx) * sw.
    """
    xq, xs = dynamic_int8(x.float(), -1)
    wq, ws = dynamic_int8(w.float(), 0)
    acc = xq.double() @ wq.double()
    return acc.float() * xs * ws


def quantize_weight(w: torch.Tensor):
    """The kernel's weight operands: (wq int8 [N, K] contiguous, sw f32 [N]).

    Per-column scales as in the TPU entry (``quant_matmul.py:226-228``); the
    transposed layout puts each output column's K values in one row, the
    K-major B operand of ``wgmma``.
    """
    wq, ws = dynamic_int8(w.float(), 0)
    return wq.t().contiguous(), ws.reshape(-1).contiguous()


# Quantised weights per tensor: the tensor (a view's base) keys the entry,
# so it dies with the tensor; inside it, its version counter, address,
# shape, strides, dtype and device, so an in-place update or another view
# quantises anew.
_QUANTIZED = WeakIdKeyDictionary()


def cached_quantized_weight(w: torch.Tensor):
    """``quantize_weight(w)``, computed once per state of ``w``.

    The cached operands are the integers ``quantize_weight`` gives, so the
    product does not change. Inference tensors (made under
    ``torch.inference_mode``) keep no version counter and are quantised on
    every call.
    """
    if w.is_inference():
        return quantize_weight(w)
    owner = w if w._base is None else w._base
    key = (w._version, w.data_ptr(), tuple(w.shape), w.stride(), w.dtype, w.device)
    slot = _QUANTIZED.get(owner)
    if slot is None:
        slot = _QUANTIZED[owner] = {}
    if key not in slot:
        for stale in [k for k in slot if k[0] != key[0]]:
            del slot[stale]
        slot[key] = quantize_weight(w)
    return slot[key]


def _launch_shape(m: int, n: int, sms: int) -> tuple[int, int, int]:
    """(BN, output tiles, persistent blocks) of the GEMM.

    Tiles are ``ROWS`` x BN; the grid is one block per SM (fewer when there
    are fewer tiles), each walking its share of the tiles. BN = 128 when
    such tiles alone give every SM one (every large-M shape of the 3DSPA
    forward: each N there is a multiple of 128); a small M takes BN = 64, which
    doubles the tiles of its launch-bound products.
    """
    m_tiles = -(-m // ROWS)
    bn = 128 if m_tiles * -(-n // 128) >= sms else 64
    tiles = m_tiles * -(-n // bn)
    return bn, tiles, min(tiles, sms)


def _check_cuda_operands(*tensors) -> None:
    if not on_cuda("the int8 kernels", *tensors):
        raise ValueError(f"the kernel takes CUDA tensors, got {[str(t.device) for t in tensors]}")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in tensors):
        raise ValueError("kernel takes contiguous, 16-byte aligned operands")


def _check_k(k: int) -> None:
    if k % 16 or not 16 <= k <= MAX_K:
        raise ValueError(f"kernel takes K in 16..{MAX_K} (multiple of 16); got K={k}")


def quantize_rows(x2d: torch.Tensor):
    """The quantise pass: x2d [M, K] f32/bf16 -> (xq int8 [M, K], sx f32 [M])."""
    if x2d.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel takes f32/bf16 x, got {x2d.dtype}")
    _check_cuda_operands(x2d)
    m, k = x2d.shape
    _check_k(k)
    xq = torch.empty((m, k), dtype=torch.int8, device=x2d.device)
    sx = torch.empty((m,), dtype=torch.float32, device=x2d.device)
    if m:
        build.launch("tdspa_quantize_rows", x2d.device, x2d.data_ptr(), xq.data_ptr(),
                     sx.data_ptr(), int(x2d.dtype == torch.bfloat16), m, k)
    return xq, sx


def int8_gemm(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor):
    """The GEMM: xq int8 [M, K], sx f32 [M], wq int8 [N, K], ws f32 [N] -> [M, N] f32."""
    if xq.dtype != torch.int8 or sx.dtype != torch.float32 or wq.dtype != torch.int8 \
            or ws.dtype != torch.float32:
        raise TypeError(f"kernel takes int8 xq and wq, f32 sx and ws; got {xq.dtype}, "
                        f"{sx.dtype}, {wq.dtype}, {ws.dtype}")
    m, k = xq.shape
    n = wq.shape[0]
    if sx.shape != (m,) or wq.shape != (n, k) or ws.shape != (n,):
        raise ValueError(f"expected sx [M], wq [N, K] and ws [N] for M={m}, K={k}; got "
                         f"{tuple(sx.shape)}, {tuple(wq.shape)}, {tuple(ws.shape)}")
    _check_k(k)
    if n % 8 or n == 0:
        raise ValueError(f"kernel takes N a multiple of 8; got N={n}")
    _check_cuda_operands(xq, sx, wq, ws)
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    if m == 0:
        return out
    sms = torch.cuda.get_device_properties(xq.device).multi_processor_count
    bn, _, grid = _launch_shape(m, n, sms)
    build.launch("tdspa_int8_gemm", xq.device, xq.data_ptr(), sx.data_ptr(), wq.data_ptr(),
                 ws.data_ptr(), out.data_ptr(), m, k, n, bn, grid)
    return out


def launch(x2d: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """One product: x2d [M, K] f32/bf16, wq [N, K] int8, ws [N] f32 -> [M, N] f32.

    Takes contiguous, 16-byte aligned CUDA operands with K a multiple of 16
    up to ``MAX_K`` and N a multiple of 8; anything else raises.
    """
    if x2d.dim() != 2 or wq.dim() != 2 or wq.shape[1] != x2d.shape[1]:
        raise ValueError(f"expected x2d [M, K] and wq [N, K]; got {tuple(x2d.shape)}, "
                         f"{tuple(wq.shape)}")
    forward_only("quant_matmul", x2d)
    return int8_gemm(*quantize_rows(x2d), wq, ws)


def quant_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] through dynamic int8 -> [..., N] f32.

    Runs the custom op ``tdspa::quant_matmul`` (``kernels/ops.py``) on the
    rows of x. CUDA tensors: the op takes the weight's int8 operands from
    ``cached_quantized_weight`` and launches the kernels (forward-only). CPU
    tensors run ``quant_matmul_reference`` (directly where autograd records).
    """
    from tdspa_torch.kernels import ops

    if w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"expected x [..., K] and w [K, N]; got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    k, n = w.shape
    if not on_cuda("quant_matmul", x, w):
        if records(x, w):
            return quant_matmul_reference(x, w)
        return ops.quant_matmul(x.reshape(-1, k), w).reshape(x.shape[:-1] + (n,))
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel takes f32/bf16 x, got {x.dtype}")
    _check_k(k)
    if n % 8 or n == 0:
        raise ValueError(f"kernel takes N a multiple of 8; got N={n}")
    forward_only("quant_matmul", x)
    return ops.quant_matmul(x.reshape(-1, k).contiguous(), w).reshape(x.shape[:-1] + (n,))


quant_matmul.launches = 0
