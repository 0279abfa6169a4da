"""Per-stage times of the fused block in two checkouts on one card, in turns.

    python3 tdspa_torch/tools/ab_block_stages.py PARENT_DIR

builds the parent checkout's ``csrc/block.cu`` (with its own ``csrc/*.cuh``)
into ``build/ab_block/`` of this checkout (git-ignored) and binds it beside
this checkout's library (``kernels/build.py::bind``): the C entry point
``tdspa_block_forward`` has kept its signature (``build.ENTRIES``) in every
version. Both run through this checkout's ``kernels/block.py::launch_stages`` on
``chip_smoke.py``'s seeded blocks (f32 x, norm scales and biases perturbed)
at the readout [512, 129, 1280] and decompress [1, 128, 1152] layers: first
each layer against ``block_reference`` (``BLOCK_ATOL``), then each of the
seven stages alone and the whole layer (``cuda_ms``), in the order PARENT,
CHANGE, CHANGE, PARENT. Prints one JSON line per (layer, checkout, turn),
with each stage's bound (``chip_smoke.py::block_stage_bounds``). Needs a GPU.
"""

from __future__ import annotations

import json
from pathlib import Path
import subprocess
import sys

ROOT = Path(__file__).resolve().parents[2]


def main(argv: list[str]) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    parent = Path(argv[0]).resolve()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from tdspa_torch.core.attention import ParallelTransformerBlock, reset_parameters
    from tdspa_torch.kernels import block as kb
    from tdspa_torch.kernels import build

    cs.phase_device()
    out_dir = ROOT / "build" / "ab_block"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libblock_parent.so"
    proc = subprocess.run([build._nvcc(), *build.flags("block"), "-I", str(parent / "tdspa_torch/csrc"),
                           "-o", str(lib), str(parent / "tdspa_torch/csrc/block.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        print(proc.stdout + proc.stderr, file=sys.stderr)
        return 1
    fns = {"parent": build.bind("tdspa_block_forward", lib),
           "change": build.bind("tdspa_block_forward")}
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    heads, head_dim = cs.BLOCK_HEADS, cs.BLOCK_QKV // cs.BLOCK_HEADS
    for name, items, seq, width, mlp, _ in cs.BLOCK_SHAPES:
        block = ParallelTransformerBlock(width, mlp, heads, cs.BLOCK_QKV, dtype=torch.bfloat16,
                                         use_fused=True, fused_block=True, device="cuda")
        reset_parameters(block, gen)
        with torch.no_grad():
            for param in block.parameters():
                if param.dim() == 1:
                    param.add_(0.1 * torch.randn(param.shape, generator=gen, device="cuda"))
        x = torch.randn((items, seq, width), generator=gen, device="cuda")
        bounds = cs.block_stage_bounds(items, seq, width, mlp, heads, head_dim, x.element_size())
        with torch.inference_mode():
            ops = kb._operands(block)
            want = kb.block_reference(x, ops, heads)
            for label, fn in fns.items():
                build.BOUND["tdspa_block_forward"] = fn
                got, _ = kb.launch_stages(x, ops, heads, torch.float32)
                err = (got - want).abs().max().item()
                if not torch.isfinite(got).all() or err > cs.BLOCK_ATOL:
                    raise AssertionError(f"{label} block disagrees with block_reference: {err}")
            del want, got
            for turn, label in enumerate(("parent", "change", "change", "parent")):
                build.BOUND["tdspa_block_forward"] = fns[label]
                _, bufs = kb.launch_stages(x, ops, heads, torch.float32)
                stage_ms = {stage: cs.cuda_ms(lambda i=i: kb.launch_stages(
                    x, ops, heads, torch.float32, 1 << i, bufs), iters=5)
                    for i, stage in enumerate(kb.STAGES)}
                layer_ms = cs.cuda_ms(lambda: kb.launch_stages(
                    x, ops, heads, torch.float32, kb.ALL_STAGES, bufs), iters=5)
                print(json.dumps({"ab_block": label, "turn": turn, "shape": name,
                                  "x": [items, seq, width], "mlp": mlp, "layer_ms": layer_ms,
                                  "stage_ms": stage_ms,
                                  "stage_bound_ms": {s: bounds[s][0] for s in kb.STAGES}}),
                      flush=True)
                del bufs
        del block, x, ops
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
