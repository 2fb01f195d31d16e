#!/usr/bin/env python3
"""Where the time of K1s's tensor-core instance goes, on one NVIDIA card.

Run from the root of a checkout:

    python3 k1s_phases.py [--parent OLD_glm_stacked.cu] [--wide]

It builds ``cycloneml_tpu_torch/csrc/glm_stacked.cu`` as it is and four
variants of it, each with one phase of the tensor-core kernel taken out
(the margins' products, the gradient's products, the epilogue's
sigmoid/softplus arithmetic, the copies of X; a tile's labels are still
copied), and, with ``--parent``, another version of the file with the
same C interface (an earlier commit's, for an A/B inside one run), all
nvcc processes started together
(``ops/build.build_variants``, into
``cycloneml_tpu_torch/_build/glm_stacked_variants/``). Then it times
``ops/kernels.glm_sweep_stacked`` through each build (CUDA events, 10
launches after 2) at the OneVsRest shape, 2,000,000 x 1280, for K = 8 and
16 models, on bf16 X and on e4m3 codes with their x_scale, in two rounds
(the second in reverse build order), and prints one JSON line per build,
K and round. With ``--wide`` it times the wide instance
instead (the same kernel on a cluster of CTAs, each with a column slice;
one more variant without the cluster barrier that publishes each tile's
partial margins) at CIFAR-10's OneVsRest shape, 50,000 x 3,072, for K = 8,
10 and 16, and at 250,000 x 8,192 for K = 8 and 16, each beside the
two-pass instance in the full build (``two_pass``: ``kernels._stacked``
forced to it, groups of 8). A variant computes a wrong answer by design: the
time it saves is what that phase costs where it cannot overlap the others.
It prints the card's name and power limit first, and exits non-zero when
no CUDA device is present.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

N, D = 2_000_000, 1280
MODELS = (8, 16)
WIDE_CASES = ((50_000, 3072, (8, 10, 16)), (250_000, 8192, (8, 16)))
ROWS = 1 << 18
ROUNDS = 2
# each variant: (text of the kernel, replacement), each text found once
VARIANTS = {
    "no_margins": [("const int kb = warp + kTcWarps * i;\n        if (kb < nkb) {",
                    "const int kb = warp + kTcWarps * i;\n"
                    "        if (kb < nkb && n < 0) {")],
    "no_gradient": [("const int cb = warp + kTcWarps * i;\n      if (cb < nkb) {\n"
                     "        // A = X^T",
                     "const int cb = warp + kTcWarps * i;\n"
                     "      if (cb < nkb && n < 0) {\n        // A = X^T")],
    "no_epilogue_math": [("          mult = logistic_mult(m, yv, wv);\n"
                          "          kahan_add(sum_s, sum_c, mult);",
                          "          mult = m * wv;\n"
                          "          kahan_add(sum_s, sum_c, mult);"),
                         ("kahan_add(sum_s, sum_c, logistic_loss(m, yv, wv));",
                          "")],
    "no_copies": [("      tc_copy_tile<!kCodes, kCopiers>(",
                   "      if (n < 0) tc_copy_tile<!kCodes, kCopiers>(")],
}
# the wide instance: the same four, and its per-tile cluster barrier (the
# remote margins are then read unsynchronized; the last barrier stays)
WIDE_VARIANTS = {**VARIANTS, "no_cluster_sync": [
    ("        own_margins(j - 1);\n        cluster_arrive();\n",
     "        own_margins(j - 1);\n"),
    ("      cluster_wait();  // tile j - 1's margins, cluster-wide\n", ""),
    ("        own_margins(j);\n        cluster_sync();\n",
     "        own_margins(j);\n")]}


def _x_forms(torch, quantize_fp8, n, d, g):
    """bf16 X and e4m3 codes with their float32 scale, drawn on the card."""
    x32 = torch.empty((n, d), device="cuda")
    for lo in range(0, n, ROWS):
        x32[lo:lo + ROWS] = torch.randn((min(ROWS, n - lo), d), generator=g,
                                        device="cuda")
    x8, scale, _ = quantize_fp8(x32)
    s32 = torch.as_tensor(scale, dtype=torch.float32, device="cuda")
    xb = x32.to(torch.bfloat16)
    del x32
    return (("bfloat16", xb, None), ("e4m3", x8, s32))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another glm_stacked.cu with the same C interface, "
                         "built and timed beside this one")
    ap.add_argument("--wide", action="store_true",
                    help="the wide instance's phases, at CIFAR-10's and "
                         "8,192 columns")
    args = ap.parse_args()
    wide = args.wide
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
    sources = build.edited_sources(
        (build.CSRC_DIR / "glm_stacked.cu").read_text(),
        WIDE_VARIANTS if wide else VARIANTS)
    if args.parent is not None:
        sources["parent"] = args.parent.read_text()
    libs = build.build_variants("glm_stacked", sources)
    order = list(libs)
    g = torch.Generator(device="cuda").manual_seed(0)
    try:
        for n, d, models in (WIDE_CASES if wide else ((N, D, MODELS),)):
            forms = _x_forms(torch, quantize_fp8, n, d, g)
            w = torch.ones(n, device="cuda")
            for k in models:
                y = (torch.rand((n, k), generator=g, device="cuda")
                     > 0.5).to(torch.bfloat16)
                b = torch.randn((k, d), generator=g, device="cuda") / d ** 0.5
                off = torch.randn(k, generator=g, device="cuda") * 0.3
                for rnd, name in ((r, name) for r in range(ROUNDS) for name in
                                  (order if r % 2 == 0 else order[::-1])):
                    # the wrapper's library
                    build._libs["glm_stacked"] = libs[name]
                    ms = {}
                    for dt, x, s in forms:
                        ms[dt] = _time_ms(lambda: kernels.glm_sweep_stacked(
                            x, y, w, b, off, x_scale=s), 10, 2)
                        if wide and name == "full":
                            ms[dt + " two_pass"] = _time_ms(
                                lambda: kernels._stacked(
                                    x, y, w, b, off, s, kernels.TWO_PASS, 8),
                                10, 2)
                    print("k1s_phase: " + json.dumps(
                        {"build": name, "round": rnd, "n": n, "d": d,
                         "k": k, "ms": ms}), flush=True)
            del forms
            torch.cuda.empty_cache()
    finally:
        build._libs.pop("glm_stacked", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
