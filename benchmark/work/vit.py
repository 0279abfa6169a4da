"""Work of a DINOv2 backbone over a video, as the serving pipeline runs it
(``tdspa_torch/features/dino.py``): frames resized to patch multiples, the
ViT over groups of ``frame_chunk`` frames within each upload chunk (the last
group of a chunk padded to ``frame_chunk``), from the configuration's
``backbone`` block. Shapes as the plain reference (``reference/dinov2.py``)
computes them.

``forward_flops`` counts the matrix products and attention of the real
frames (2 flops a multiply-add; patch embedding, q, k, v, output, the FFN,
q k^T and p v; norms, softmax, SiLU or GELU and sums not counted; padded
frames not counted). ``attention_calls`` lists the maskless attention's
launches, padded groups included, since the kernel computes them; the bound
of a call is the larger of bytes over the HBM peak and flops over the bf16
tensor-core peak: q, k, v read once in bf16, the output written once (f32,
the residual dtype), 4 B H S K D flops.
"""

from __future__ import annotations

from benchmark.harness.peaks import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S
from benchmark.reference.dinov2 import ffn_width


def tokens(backbone: dict, height: int, width: int) -> int:
    """Tokens a frame: the patch grid of the resized frame and the CLS token."""
    p = backbone["patch_size"]
    return (height // p) * (width // p) + 1


def forward_flops(backbone: dict, frames: int, height: int, width: int) -> float:
    d, p = backbone["hidden_size"], backbone["patch_size"]
    n = tokens(backbone, height, width)
    h = ffn_width(backbone)
    ffn = 2.0 * n * d * 2 * h + 2.0 * n * h * d if backbone["ffn"] == "swiglu" else 4.0 * n * d * h
    layer = 8.0 * n * d * d + 4.0 * n * n * d + ffn
    embed = 2.0 * (n - 1) * 3 * p * p * d
    return frames * (embed + backbone["num_layers"] * layer)


def attention_calls(backbone: dict, frames: int, height: int, width: int, upload_chunk: int,
                    frame_chunk: int = 8) -> list[tuple[int, int, int, int, int]]:
    """(items B, query rows S, keys K, heads H, head size D) of every launch."""
    n = tokens(backbone, height, width)
    heads = backbone["num_heads"]
    head = backbone["hidden_size"] // heads
    groups = sum(-(-min(upload_chunk, frames - s) // frame_chunk)
                 for s in range(0, frames, upload_chunk))
    return [(frame_chunk, n, n, heads, head)] * (groups * backbone["num_layers"])


def attention_bound_s(call, out_bytes: int = 4) -> float:
    b, s, k, h, d = call
    nbytes = 2 * b * h * d * (s + 2 * k) + out_bytes * b * s * h * d
    flops = 4.0 * b * h * s * k * d
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS)
