"""Dynamic-int8 matrix product: CUDA kernel wrapper + its plain version.

Replaces the TPU kernel ``tdspa/kernels/quant_matmul.py::_quant_matmul_pallas``
(body ``_quant_matmul_kernel``): ``y = int8(x / sx) . int8(W / sw) * sx * sw``
with per-row activation scales ``sx = max(amax, 1e-30) * f32(1/127)``
computed from x upcast to f32, per-column weight scales computed outside the kernel,
exact integer accumulation and f32 output. The Hopper kernel
(``tdspa_torch/csrc/quant_matmul.cu``) quantises each 64-row slab of x into
shared memory and runs int8 ``mma.sync`` over it; it takes every shape of
the 3DSPA forward, so the TPU's VMEM-fit dispatch (``quant_matmul_fits``,
``_pick_bm``) has no counterpart.

``quant_matmul`` launches the kernel for CUDA tensors and runs
``quant_matmul_reference`` for CPU tensors; it never falls back from one to
the other. ``quant_matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tdspa_torch.kernels import build

ROWS = 64  # x rows per block of csrc/quant_matmul.cu
COLS = 128  # output columns per N tile
MAX_K = 3072  # the int8 slab [64, K] and two weight tiles fit one SM's shared memory


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
    column-major B operand of ``mma.sync``.
    """
    wq, ws = dynamic_int8(w.float(), 0)
    return wq.t().contiguous(), ws.reshape(-1).contiguous()


def _launch_shape(m: int, n: int, sms: int) -> tuple[int, int]:
    """(N splits, N tiles per split) of the grid.

    One block per 64-row M tile walks the N tiles of its split. A large M
    keeps every N tile in one block (the slab is quantised once); a small M
    splits the N tiles over more blocks, to reach about two blocks per SM.
    """
    m_tiles = -(-m // ROWS)
    n_tiles = -(-n // COLS)
    splits = min(n_tiles, max(1, -(-2 * sms // m_tiles)))
    per_split = -(-n_tiles // splits)
    return -(-n_tiles // per_split), per_split


# tdspa_quant_matmul(x, wq, ws, out, x_bf16, M, K, N, splits, tiles_per_split,
#                    stream) in csrc/quant_matmul.cu.
ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


@functools.cache
def _kernel():
    fn = build.load("quant_matmul").tdspa_quant_matmul
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def launch(x2d: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """One kernel launch: x2d [M, K] f32/bf16, wq [N, K] int8, ws [N] f32 -> [M, N] f32.

    Takes contiguous, 16-byte aligned CUDA operands with K a multiple of 16
    up to ``MAX_K`` and N a multiple of 8; anything else raises.
    """
    if x2d.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {x2d.device}")
    if x2d.dtype not in (torch.float32, torch.bfloat16) or wq.dtype != torch.int8 \
            or ws.dtype != torch.float32:
        raise TypeError(f"kernel takes f32/bf16 x, int8 wq, f32 ws; got {x2d.dtype}, "
                        f"{wq.dtype}, {ws.dtype}")
    m, k = x2d.shape
    n = wq.shape[0]
    if wq.shape != (n, k) or ws.shape != (n,):
        raise ValueError(f"expected wq [N, K] and ws [N] for K={k}; got {tuple(wq.shape)}, "
                         f"{tuple(ws.shape)}")
    if k % 16 or not 16 <= k <= MAX_K or n % 8 or n == 0:
        raise ValueError(f"kernel takes K in 16..{MAX_K} (multiple of 16) and N a multiple "
                         f"of 8; got K={k}, N={n}")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in (x2d, wq, ws)):
        raise ValueError("kernel takes contiguous, 16-byte aligned operands")
    if torch.is_grad_enabled() and x2d.requires_grad:
        raise NotImplementedError("quant_matmul is forward-only (inference)")
    out = torch.empty((m, n), dtype=torch.float32, device=x2d.device)
    if m == 0:
        return out
    sms = torch.cuda.get_device_properties(x2d.device).multi_processor_count
    splits, per_split = _launch_shape(m, n, sms)
    with torch.cuda.device(x2d.device):
        rc = _kernel()(
            x2d.data_ptr(), wq.data_ptr(), ws.data_ptr(), out.data_ptr(),
            int(x2d.dtype == torch.bfloat16), m, k, n, splits, per_split,
            torch.cuda.current_stream(x2d.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error {rc}")
    return out


def quant_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] through dynamic int8 -> [..., N] f32.

    CUDA tensors: the weight is quantised per column (``quantize_weight``)
    and the kernel launches. CPU tensors run ``quant_matmul_reference``.
    """
    if w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"expected x [..., K] and w [K, N]; got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError(f"x and w lie on different devices: {x.device}, {w.device}")
    if x.device.type == "cpu":
        return quant_matmul_reference(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    k, n = w.shape
    wq, ws = quantize_weight(w)
    out = launch(x.reshape(-1, k).contiguous(), wq, ws)
    quant_matmul.launches += 1
    return out.reshape(x.shape[:-1] + (n,))


quant_matmul.launches = 0
