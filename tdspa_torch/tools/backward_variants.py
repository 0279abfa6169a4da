"""Where the time of ``csrc/attention_backward.cu`` goes, on the card.

    python3 tdspa_torch/tools/backward_variants.py

Builds copies of the source with the products and elementwise work of one
phase of the consumer warpgroups removed (phase 1, the row pass with the
dP^T it stores; phase 2, the key pass: s^T, P^T, dS^T and dv; phase 3, dk
and dq; or all three: the loads, the conversions and the stores alone) or
with the divisions by bf16(sqrt(D)) made IEEE divisions (``__fdiv_rn``)
again, binds each (``kernels/build.py::bind``) in place of the wrapper's kernel and times it
at the 3D encoder, readout and 2D encoder shapes of phase
``attention_backward`` (B = 2048), in turns. The removed variants compute wrong gradients: only
their times mean anything. The division variant must equal the kernel bit
for bit. Prints one JSON line per shape. Needs a GPU and nvcc; the copies
are built into the git-ignored ``build/`` directory.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

VARIANTS = {
    "kernel": [],
    "ieee_division": [("div_root(f.x, root, rinv), div_root(f.y, root, rinv)",
                       "__fdiv_rn(f.x, root), __fdiv_rn(f.y, root)"),
                      ("x0 = div_root(round_bf16(x0), root, rinv);",
                       "x0 = __fdiv_rn(round_bf16(x0), root);"),
                      ("x1 = div_root(round_bf16(x1), root, rinv);",
                       "x1 = __fdiv_rn(round_bf16(x1), root);")],
    "no_row_pass": [("    if (r0 < rows) {\n#pragma unroll 1\n      for (int t = 0;",
                     "    if (r0 < rows && K < 0) {\n#pragma unroll 1\n      for (int t = 0;")],
    "no_key_pass": [("    if (kr < keys) {\n      float (&acc)", "    if (kr < keys && K < 0) {\n      float (&acc)")],
    "no_dk_dq": [("      if (kr < keys) {\n        const int steps = (rows + 15) / 16;",
                  "      if (kr < keys && K < 0) {\n        const int steps = (rows + 15) / 16;"),
                 ("      if (mine) {", "      if (mine && K < 0) {")],
}
VARIANTS["loads_and_stores"] = (VARIANTS["no_row_pass"] + VARIANTS["no_key_pass"]
                                + VARIANTS["no_dk_dq"])
ORDER = ["kernel", "ieee_division", "no_row_pass", "no_key_pass", "no_dk_dq", "loads_and_stores",
         "ieee_division", "kernel"]
SHAPES = [("encoder_3d", 2048, 151, 151, 8, 96, "rows"), ("readout", 2048, 129, 129, 8, 96, False),
          ("encoder_2d", 2048, 150, 150, 8, 64, "rows")]


def build_variants(build, report) -> dict:
    out_dir = build.BUILD_DIR.parent / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (build.CSRC / "attention_backward.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = source
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        (out_dir / f"{name}.cu").write_text(text)
        cmd = [build._nvcc(), *build.flags("attention_backward"), "-I", str(build.CSRC), "-o",
               str(out_dir / f"lib{name}.so"), str(out_dir / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{log[-3000:]}")
        print(json.dumps({"variant": name, "ptxas": report(log)}), flush=True)
        fns[name] = build.bind("tdspa_attention_backward", out_dir / f"lib{name}.so")
    return fns


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from tdspa_torch.kernels import attention as ka
    from tdspa_torch.kernels import build

    cs.phase_device()
    fns = build_variants(build, cs.ptxas_report)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for name, *shape in SHAPES:
        q, k, v, mask = cs.attention_inputs(gen, *shape)
        g = torch.randn(q.shape, generator=gen, device="cuda")
        row, outs = {"shape": name}, {}
        for variant in ORDER:
            build.BOUND["tdspa_attention_backward"] = fns[variant]
            outs[variant] = ka.attention_backward(q, k, v, mask, g)
            row.setdefault(variant, []).append(
                cs.cuda_ms(lambda: ka.attention_backward(q, k, v, mask, g), 10))
        row["ieee_division_bit_equal"] = all(
            torch.equal(a, b) for a, b in zip(outs["kernel"], outs["ieee_division"]))
        print(json.dumps(row), flush=True)
        del q, k, v, mask, g, outs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
