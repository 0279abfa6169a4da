"""The one seam between tdspa_torch and its CUDA libraries: build the kernels
under ``tdspa_torch/csrc/``, bind their entry points with ctypes and launch
them.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with
``nvcc`` for ``sm_90a`` into ``build/tdspa_torch/lib<name>-<digest>.so`` at
the repository root (git-ignored). The digest covers the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source or header
rebuilds and an unchanged one loads at once.
Nothing here runs at import time: a kernel builds at its first launch, or all
of them together (one ``nvcc`` each, in parallel) through ``build_all``.

``ENTRIES`` is the one table of the libraries' ``extern "C"`` entry points
and their argument types. ``launch`` calls one on a device's current stream
and raises on a CUDA error. The wrappers in ``kernels/`` keep their operand
checks, their launch plans and their plain versions, and share the rest:
``on_cuda``, the device rule (CPU tensors run the plain version, CUDA tensors
launch, nothing falls back from one to the other); ``forward_only``, the
refusal where autograd would record through a launch; ``aligned`` and
``rows`` for the row kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
from pathlib import Path
import shutil
import subprocess
import tempfile
import time

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tdspa_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Extra flags per source. --fmad=false keeps a kernel from fusing a product
# and a sum into one rounding: the LK kernel's thresholded decisions then see
# the values its plain version computes, the bilinear kernel equals the plain
# gather bit for bit, and the ViT block's residual stream equals the eager
# chain's.
EXTRA_FLAGS = {"lk": ("--fmad=false",), "bilinear": ("--fmad=false",),
               "vit_block": ("--fmad=false",)}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Every extern "C" entry point of csrc/*.cu: symbol -> (library, argument
# types). Each returns 0 or a CUDA error code and takes the stream last.
ENTRIES = {
    # (q, k, v, mask, out, part_o, part_ml, out_bf16, B, S, K, H, D, chunk_tiles, grid, scale)
    "tdspa_attention_forward": ("attention", [_P] * 7 + [_I] * 8 + [_F, _P]),
    # (q, k, v, out, out_bf16, B, S, K, H, D, q_blocks, scale)
    "tdspa_vit_attention_forward": ("vit_attention", [_P] * 4 + [_I] * 7 + [_F, _P]),
    # (level_ptrs, level_h, level_w, levels, tmpl0, tmpl_rescue, h_r, w_r, queries, tpos,
    #  init_vel, gauss_w, tracks, vis, vel_out, N, T, window, iterations, fb, ncc, tncc,
    #  corr_radius, corr_iterations, corr_accept, rescue_level)
    "tdspa_lk_track": ("lk", [_P] * 3 + [_I] + [_P] * 2 + [_I] * 2 + [_P] * 7 + [_I] * 4
                       + [_F] * 3 + [_I] * 2 + [_F, _I, _P]),
    # (feats, tvec, fpos, out, N, T, Hf, Wf, D, M, R)
    "tdspa_cost_patches": ("matcher", [_P] * 4 + [_I] * 7 + [_P]),
    # (x, xq, sx, x_bf16, M, K)
    "tdspa_quantize_rows": ("quant_matmul", [_P] * 3 + [_I] * 3 + [_P]),
    # (xq, sx, wq, ws, out, M, K, N, bn, grid)
    "tdspa_int8_gemm": ("quant_matmul", [_P] * 5 + [_I] * 5 + [_P]),
    # (x, out, g1, wqkv_t, sq, sk, wo_t, bo, g2, w1_t, b1, w2_t, b2, xb, ln1, qkv, att, y,
    #  ln2, hid, x_bf16, out_bf16, N, S, C, H, DH, MLP, stages, sms, scale)
    "tdspa_block_forward": ("block", [_P] * 20 + [_I] * 10 + [_F, _P]),
    # (grid, coords, out, grid_bf16, out_bf16, T, H, W, C, N)
    "tdspa_bilinear_sample": ("bilinear", [_P] * 3 + [_I] * 7 + [_P]),
    # (q, k, v, mask, g, dq, dk, dv, dq_part, dk_part, dv_part, stats, B, S, K, H, D, root)
    "tdspa_attention_backward": ("attention_backward", [_P] * 12 + [_I] * 5 + [_F, _P]),
    # (x, scale, out, x_bf16, out_bf16, centered, rows, width, lanes, nv)
    "tdspa_row_norm_forward": ("norm", [_P] * 3 + [_I] * 7 + [_P]),
    # (x, scale, dy0, dy1, dy2, dy3, dx, partial, dscale, cotangents, x_bf16, dy_bf16,
    #  centered, rows, width, lanes, nv, parts)
    "tdspa_row_norm_backward": ("norm", [_P] * 9 + [_I] * 9 + [_P]),
    # (x, h, bias, layer_scale, x_out, scale, norm_bias, out, x_bf16, h_bf16, out_bf16, eps,
    #  rows, width, lanes, nv)
    "tdspa_vit_residual_norm": ("vit_block", [_P] * 8 + [_I] * 3 + [_F] + [_I] * 4 + [_P]),
    # (y, bias, out, bf16, rows, hidden)
    "tdspa_swiglu_gate": ("vit_block", [_P] * 3 + [_I] * 3 + [_P]),
}
KERNELS = tuple(dict.fromkeys(library for library, _ in ENTRIES.values()))


def flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "tdspa_torch are built from source at first use"
    )


def library_path(name: str) -> Path:
    source = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(path.read_bytes() for path in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(source + headers + " ".join(flags(name)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=KERNELS) -> dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source, all at once.

    Returns seconds of wall time per library built (0.0 for one already
    built). The compiler's report (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside each library as ``<name>.log``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *flags(name), "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        started[name] = (proc, tmp, target, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, target, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, target)  # atomic: a concurrent build never sees half a file
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return seconds


def bind(symbol: str, path=None):
    """``symbol`` of ``ENTRIES`` with its argument types and an int result,
    from its library, built if need be, or from the library at ``path`` (a
    build of another version of its source)."""
    library, argtypes = ENTRIES[symbol]
    if path is None:
        build_all((library,))
        path = library_path(library)
    fn = getattr(ctypes.CDLL(str(path)), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


class _Bound(dict):
    def __missing__(self, symbol):
        fn = self[symbol] = bind(symbol)
        return fn


# The entry points bound so far, by symbol, each at its first launch. A tool
# that times another build of a source through the wrappers sets its entry
# to ``bind(symbol, path)``.
BOUND = _Bound()


def launch(symbol: str, device, *args) -> None:
    """Call ``symbol`` with ``args`` and ``device``'s current stream, on that
    device; raise ``RuntimeError`` when it returns a CUDA error."""
    with torch.cuda.device(device):
        rc = BOUND[symbol](*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} failed: CUDA error {rc}")


def on_cuda(what: str, *tensors) -> bool:
    """The device rule: False for CPU tensors (``what`` runs its plain
    version), True for CUDA tensors (it launches its kernel); ``ValueError``
    for tensors on two devices or on any other device. None entries are
    skipped."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{what}: operands lie on different devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {device}")
    return True


def records(*tensors) -> bool:
    """Whether autograd would record an op on ``tensors`` (None entries skipped)."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def forward_only(what: str, *tensors) -> None:
    """Raise ``NotImplementedError`` where autograd would record on ``tensors``:
    a kernel's output carries no gradient."""
    if records(*tensors):
        raise NotImplementedError(f"{what} is forward-only on CUDA tensors: its kernel's "
                                  "output would carry no gradient")


def aligned(t):
    """t itself if it starts on a 16-byte boundary, else a fresh (aligned)
    copy: the kernels move 16-byte words."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def rows(x, what: str) -> int:
    """The rows of x [..., W], of which a row kernel takes fewer than 2^31."""
    n = x.numel() // x.shape[-1] if x.shape[-1] else 0
    if n >= 2 ** 31:
        raise ValueError(f"{what} takes fewer than 2^31 rows; got {n}")
    return n
