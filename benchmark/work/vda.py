"""Work of Video Depth Anything over a video, as the scoring pipeline runs it with VDA's
temporal head (``tdspa_torch/features/depth.py``): frames resized to ``input_size`` at
patch multiples, then windows of ``window`` frames, each later one ``window - overlap``
frames on and reading ``overlap`` keyframes of the window before, until every frame is
given (VDA's ``infer_video_depth``). Shapes as the plain reference (``reference/vda.py``)
computes them, from the configuration's ``depth`` block.

``forward_flops`` counts the matrix products, convolutions and attention of every frame
pass (2 flops a multiply-add; keyframes and padding included, since the model computes
them): the encoder (``work/vit.py``), the DPT head's convolutions, and the four motion
modules (``proj_in``, ``proj_out``, q, k, v, ``to_out``, q k^T and p v over the frames, the
GEGLU feed-forward). Norms, softmax, GELU, resizes and sums are not counted.
``attention_calls`` lists the encoder's maskless attention launches: one a layer a
window, all the window's frames in one launch.
"""

from __future__ import annotations

from benchmark.work import vit


def windows(frames: int, window: int, overlap: int) -> int:
    """Windows until every frame is given: the first gives ``window`` frames, each later
    one ``window - overlap``."""
    stride = window - overlap
    return 1 + max(0, -(-(frames - window) // stride))


def grid(depth: dict, height: int, width: int) -> tuple[int, int]:
    """The encoder's patch grid for a ``height`` x ``width`` frame: the long side at
    ``input_size``, rounded to patch multiples."""
    p = depth["encoder"]["patch_size"]
    scale = depth["input_size"] / max(height, width)
    return (max(round(height * scale / p), 1), max(round(width * scale / p), 1))


def _conv(pixels: int, c_in: int, c_out: int, k: int) -> float:
    return 2.0 * pixels * c_in * c_out * k * k


def head_flops(depth: dict, gh: int, gw: int) -> float:
    """The DPT head's convolutions for one frame on a gh x gw patch grid, motion modules
    apart."""
    d = depth["encoder"]["hidden_size"]
    p = depth["encoder"]["patch_size"]
    oc, f = depth["out_channels"], depth["features"]
    n0 = gh * gw
    sides = [(gh * 4, gw * 4), (gh * 2, gw * 2), (gh, gw), ((gh + 1) // 2, (gw + 1) // 2)]
    px = [h * w for h, w in sides]
    flops = sum(_conv(n0, d, c, 1) for c in oc)  # projects
    flops += 2.0 * n0 * oc[0] * oc[0] * 16 + 2.0 * n0 * oc[1] * oc[1] * 4  # the two ConvTs
    flops += _conv(px[3], oc[3], oc[3], 3)  # resize_layers[3]
    flops += sum(_conv(n, c, f, 3) for n, c in zip(px, oc))  # layer{1..4}_rn
    # refinenet4 has one residual unit (2 convs) at layer 4's grid; the others two (4
    # convs) at their grid; each out_conv runs after the resize to the next grid.
    flops += 2 * _conv(px[3], f, f, 3) + _conv(px[2], f, f, 1)
    flops += 4 * _conv(px[2], f, f, 3) + _conv(px[1], f, f, 1)
    flops += 4 * _conv(px[1], f, f, 3) + _conv(px[0], f, f, 1)
    full = px[0] * 4  # refinenet1 resizes x 2
    flops += 4 * _conv(px[0], f, f, 3) + _conv(full, f, f, 1)
    flops += _conv(full, f, f // 2, 3)  # output_conv1
    out = gh * p * gw * p
    return flops + _conv(out, f // 2, 32, 3) + _conv(out, 32, 1, 1)  # output_conv2


def motion_flops(depth: dict, gh: int, gw: int, frames: int) -> float:
    """The four motion modules over one window of ``frames`` frames."""
    m = depth["motion"]
    oc, f = depth["out_channels"], depth["features"]
    sides = [(gh, gw), ((gh + 1) // 2, (gw + 1) // 2), (gh, gw), (gh * 2, gw * 2)]
    total = 0.0
    for c, (h, w) in zip([oc[2], oc[3], f, f], sides):
        locations = h * w
        n = frames * locations
        block = m["num_attention_blocks"] * (8.0 * n * c * c + 4.0 * locations * frames ** 2 * c)
        block += 2.0 * n * c * 2 * m["ff_mult"] * c + 2.0 * n * m["ff_mult"] * c * c
        total += 4.0 * n * c * c + m["num_transformer_block"] * block
    return total


def forward_flops(depth: dict, frames: int, height: int, width: int) -> float:
    gh, gw = grid(depth, height, width)
    p = depth["encoder"]["patch_size"]
    count = windows(frames, depth["window"], depth["overlap"])
    passes = count * depth["window"]
    backbone = vit.forward_flops(depth["encoder"], passes, gh * p, gw * p)
    return backbone + passes * head_flops(depth, gh, gw) + \
        count * motion_flops(depth, gh, gw, depth["window"])


def attention_calls(depth: dict, frames: int, height: int,
                    width: int) -> list[tuple[int, int, int, int, int]]:
    """(items B, query rows S, keys K, heads H, head size D) of every launch."""
    enc = depth["encoder"]
    gh, gw = grid(depth, height, width)
    n = gh * gw + 1
    heads = enc["num_heads"]
    count = windows(frames, depth["window"], depth["overlap"])
    call = (depth["window"], n, n, heads, enc["hidden_size"] // heads)
    return [call] * (count * enc["num_layers"])
