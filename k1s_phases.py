#!/usr/bin/env python3
"""Where the time of K1s's tensor-core instance goes, on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 k1s_phases.py

It builds ``cycloneml_tpu_torch/csrc/glm_stacked.cu`` as it is and four
variants of it, each with one phase of the tensor-core kernel taken out
(the margins' products, the gradient's products, the epilogue's
sigmoid/softplus arithmetic, the copies of X; a tile's labels are still
copied), all nvcc processes started together
(``ops/build.build_variants``, into
``cycloneml_tpu_torch/_build/glm_stacked_variants/``). Then it times
``ops/kernels.glm_sweep_stacked`` through each build (CUDA events, 10
launches after 2) at the OneVsRest shape, 2,000,000 x 1280, for K = 8 and
16 models, on bf16 X and on e4m3 codes with their x_scale, and prints one
JSON line per build and K. A variant computes a wrong answer by design: the
time it saves is what that phase costs where it cannot overlap the others.
It prints the card's name and power limit first, and exits non-zero when
no CUDA device is present.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

N, D = 2_000_000, 1280
MODELS = (8, 16)
ROWS = 1 << 18
# each variant: (text of the kernel, replacement), each text found once
VARIANTS = {
    "no_margins": [("const int kb = warp + kTcWarps * i;\n      if (kb < nkb) {",
                    "const int kb = warp + kTcWarps * i;\n"
                    "      if (kb < nkb && n < 0) {")],
    "no_gradient": [("const int cb = warp + kTcWarps * i;\n      if (cb < nkb) {\n"
                     "        // A = X^T",
                     "const int cb = warp + kTcWarps * i;\n"
                     "      if (cb < nkb && n < 0) {\n        // A = X^T")],
    "no_epilogue_math": [("mult = logistic_mult(m, yv, wv);", "mult = m * wv;"),
                         ("kahan_add(sum_s, sum_c, logistic_loss(m, yv, wv));",
                          "")],
    "no_copies": [("      tc_copy_tile<!kCodes, kCopiers>(",
                   "      if (n < 0) tc_copy_tile<!kCodes, kCopiers>(")],
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k1s_phases: no CUDA device; this needs the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chip_smoke import _time_ms
    from cycloneml_tpu_torch.dataset.instance import quantize_fp8
    from cycloneml_tpu_torch.ops import build, kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or "not measured (nvidia-smi gave nothing)",
          flush=True)
    libs = build.build_variants("glm_stacked", build.edited_sources(
        (build.CSRC_DIR / "glm_stacked.cu").read_text(), VARIANTS))
    g = torch.Generator(device="cuda").manual_seed(0)
    x32 = torch.empty((N, D), device="cuda")
    for lo in range(0, N, ROWS):
        x32[lo:lo + ROWS] = torch.randn((min(ROWS, N - lo), D), generator=g,
                                        device="cuda")
    x8, scale, _ = quantize_fp8(x32)
    s32 = torch.as_tensor(scale, dtype=torch.float32, device="cuda")
    xb = x32.to(torch.bfloat16)
    del x32
    w = torch.ones(N, device="cuda")
    try:
        for k in MODELS:
            y = (torch.rand((N, k), generator=g, device="cuda") > 0.5).to(
                torch.bfloat16)
            b = torch.randn((k, D), generator=g, device="cuda") / D ** 0.5
            off = torch.randn(k, generator=g, device="cuda") * 0.3
            for name, lib in libs.items():
                build._libs["glm_stacked"] = lib  # the wrapper loads this one
                ms = {}
                for dt, x, s in (("bfloat16", xb, None), ("e4m3", x8, s32)):
                    ms[dt] = _time_ms(lambda: kernels.glm_sweep_stacked(
                        x, y, w, b, off, x_scale=s), 10, 2)
                print("k1s_phase: " + json.dumps(
                    {"build": name, "n": N, "d": D, "k": k, "ms": ms}),
                    flush=True)
    finally:
        build._libs.pop("glm_stacked", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
