#!/usr/bin/env python3
"""Where the time of the GLM sweep (K1 and K2) goes, on one NVIDIA card.

Run from the root of a checkout:

    python3 glm_phases.py [--parent OLD_glm_sweep.cu] [--wide]

It builds ``cycloneml_tpu_torch/csrc/glm_sweep.cu`` as it is and four
variants of it, each with one phase of the sweep taken out (the copies of
X into the ring, the margins' products, the link's arithmetic, the
gradient's block sums; y and w are still copied), and, with ``--parent``,
another version of the file with the same C interface (an earlier commit's,
for an A/B inside one run), all nvcc processes started together
(``ops/build.build_variants``, into
``cycloneml_tpu_torch/_build/glm_sweep_variants/``). Then it times
``ops/kernels.glm_sweep`` through each build (CUDA events, 20 launches
after 3) for K2 (the squared link) at the LinearRegression shape, 400,000 x
2000, and K1 (the logistic link) at the LogisticRegression shape,
2,000,000 x 1280, each on float32 and bf16 X and on e4m3 codes with their
x_scale, in two rounds (the second in reverse build order), and prints one
JSON line per build and round, then the instances' plans (ring stages,
block rows, shared memory, CTAs on each SM) of the build as it is. With
``--wide`` the variants take the same four phases out of the wide
instance (``glm_sweep_wide_kernel``, one read of X past 2,048 columns)
instead, and the cases are K2 and K1 at the linear probe's shape,
1,281,167 x 4,096, on bf16 X and e4m3 codes, and K1 on float32 X at
500,000 x 4,096, each beside the two-pass instance (``two_pass`` in the
lines: the full build's ``kernels._sweep`` forced to it). A
variant computes a wrong answer by design: the time it saves is what that
phase costs where it cannot overlap the others. It prints the card's name
and power limit first, and exits non-zero when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

K2_SHAPE = (400_000, 2000)    # LinearRegression, configuration 2
K1_SHAPE = (2_000_000, 1280)  # LogisticRegression, bench.py's shape
WIDE_SHAPE = (1_281_167, 4096)  # the linear probe (VGG-16 fc7, ImageNet-1k)
WIDE_F32_N = 500_000            # rows of f32 X at the probe's width
ROUNDS = 2
# each variant: (text of the kernel, replacement) pairs, each text found
# once (ops/build.edited_sources)
VARIANTS = {
    "no_copies": [("        if constexpr (kSlotBytes == 16)\n"
                   "          hopper::cp_async16(",
                   "        if (n < 0)\n          ;\n"
                   "        else if constexpr (kSlotBytes == 16)\n"
                   "          hopper::cp_async16(")],
    "no_margins": [("for (int k = 0; k < kSlots; ++k) {\n"
                    "      const float* bk",
                    "for (int k = 0; k < kSlots && n < 0; ++k) {\n"
                    "      const float* bk")],
    "no_link_math": [("link_eval<LINK>(mj + off, yl, wl, ys, mult_l, loss_l);"
                      "\n    float mult[R];",
                      "mult_l = wl * mj;\n    loss_l = mult_l + yl;"
                      "\n    float mult[R];")],
    "no_gradient": [("for (int k = 0; k < kSlots; ++k) {\n"
                     "      uint32_t u[R][W];",
                     "for (int k = 0; k < kSlots && n < 0; ++k) {\n"
                     "      uint32_t u[R][W];")],
}
# the same four phases of the wide instance (glm_sweep_wide_kernel)
WIDE_VARIANTS = {
    "no_copies": [("            if constexpr (SB == 16)\n"
                   "              hopper::cp_async16(",
                   "            if (n < 0)\n              ;\n"
                   "            else if constexpr (SB == 16)\n"
                   "              hopper::cp_async16(")],
    "no_margins": [("    for (int k = 0; k < KS; ++k) {\n#pragma unroll\n"
                    "      for (int i = 0; i < G; ++i) {\n",
                    "    for (int k = 0; k < KS && n < 0; ++k) {\n"
                    "#pragma unroll\n"
                    "      for (int i = 0; i < G; ++i) {\n")],
    "no_link_math": [("link_eval<LINK>(m + off, yw[0], yw[1], ys, mult, loss);",
                      "mult = yw[1] * m;\n      loss = mult + yw[0];")],
    "no_gradient": [("        if (r0 + b0 < n) {\n          uint32_t u[R][W];",
                     "        if (r0 + b0 < n && n < 0) {\n"
                     "          uint32_t u[R][W];")],
}


def _inputs(torch, n, d, seed, squared,
            forms=("float32", "bfloat16", "e4m3")):
    """X (n, d) in each of ``forms`` (float32, bf16, e4m3 codes with their
    float32 scale), made on the card (by row blocks, so that no float32
    copy of a wide X is held beside the others), and the sweep's
    vectors."""
    from cycloneml_tpu_torch.dataset.instance import quantize_fp8
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = 1 << 16
    out = {f: torch.empty((n, d), device="cuda", dtype={
        "float32": torch.float32, "bfloat16": torch.bfloat16,
        "e4m3": torch.float8_e4m3fn}[f]) for f in forms}
    scale = None
    if "e4m3" in forms:  # one scale for all rows: the first block's
        _, scale, _ = quantize_fp8(torch.randn((rows, d), generator=g,
                                               device="cuda"))
        s32 = torch.as_tensor(scale, dtype=torch.float32, device="cuda")
    for lo in range(0, n, rows):
        blk = torch.randn((min(rows, n - lo), d), generator=g, device="cuda")
        for f, x in out.items():
            x[lo:lo + rows] = (blk / s32).clamp(-448, 448) if f == "e4m3" \
                else blk
    forms = {f: (x, s32 if f == "e4m3" else None) for f, x in out.items()}
    y = (torch.randn(n, generator=g, device="cuda") if squared else
         (torch.rand(n, generator=g, device="cuda") > 0.5).float())
    beta = torch.randn(d, generator=g, device="cuda") / d ** 0.5
    return forms, y, torch.ones(n, device="cuda"), beta


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another glm_sweep.cu with the same C interface, "
                         "built and timed beside this one")
    ap.add_argument("--wide", action="store_true",
                    help="the wide instance's phases, at the linear "
                         "probe's width")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("glm_phases: no CUDA device; this needs the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cycloneml_tpu_torch.ops import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or "not measured (nvidia-smi gave nothing)",
          flush=True)
    sources = build.edited_sources(
        (build.CSRC_DIR / "glm_sweep.cu").read_text(),
        WIDE_VARIANTS if args.wide else VARIANTS)
    if args.parent is not None:
        sources["parent"] = args.parent.read_text()
    libs = build.build_variants("glm_sweep", sources)
    time_builds(libs, _wide_cases() if args.wide else _cases())
    return 0


def _cases():
    """(label, link, X, x_scale, y, w, beta) at both fits' shapes, for
    every form of X."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    cases = []
    for (n, d), link, seed in ((K2_SHAPE, kernels.SQUARED, 3),
                               (K1_SHAPE, kernels.LOGISTIC, 1)):
        forms, y, w, beta = _inputs(torch, n, d, seed,
                                    link == kernels.SQUARED)
        k = "K2" if link == kernels.SQUARED else "K1"
        for dt, (x, s) in forms.items():
            cases.append((f"{k} {dt} {n}x{d}", link, x, s, y, w, beta))
    return cases


def _wide_cases():
    """The wide instance's cases: K2 and K1 at the probe's shape on bf16 X
    and e4m3 codes, K1 on f32 X at WIDE_F32_N rows."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    cases = []
    n, d = WIDE_SHAPE
    forms, y, w, beta = _inputs(torch, n, d, 5, True, forms=("bfloat16",
                                                             "e4m3"))
    y1 = (y > 0).float()
    for dt, (x, s) in forms.items():
        cases.append((f"K2 {dt} {n}x{d}", kernels.SQUARED, x, s, y, w, beta))
        cases.append((f"K1 {dt} {n}x{d}", kernels.LOGISTIC, x, s, y1, w,
                      beta))
    forms, y, w, beta = _inputs(torch, WIDE_F32_N, d, 6, False,
                                forms=("float32",))
    x, s = forms["float32"]
    cases.append((f"K1 float32 {WIDE_F32_N}x{d}", kernels.LOGISTIC, x, s, y,
                  w, beta))
    return cases


def time_builds(libs: dict, cases: list, plan_of: str = "full") -> None:
    """Times every case through every build, ROUNDS rounds (every other
    one in reverse build order), one JSON line per build and round; then
    the plan of each case's instance in the build ``plan_of``."""
    from chip_smoke import _time_ms
    from cycloneml_tpu_torch.ops import build, kernels
    order = list(libs)
    try:
        for rnd in range(ROUNDS):
            for name in (order if rnd % 2 == 0 else order[::-1]):
                build._libs["glm_sweep"] = libs[name]  # the wrapper's library
                ms = {}
                for label, link, x, s, y, w, beta in cases:
                    ms[label] = _time_ms(lambda: kernels.glm_sweep(
                        x, y, w, beta, 0.1, link=link, ys=0.4, x_scale=s),
                        20, 3)
                    if name == "full" and x.shape[1] > kernels.NARROW_MAX_D:
                        ms[label + " two_pass"] = _time_ms(
                            lambda: kernels._sweep(
                                x, y, w, beta, 0.1, link, 0.4, s,
                                kernels.TWO_PASS), 20, 3)
                print("glm_phase: " + json.dumps(
                    {"build": name, "round": rnd, "ms": ms}), flush=True)
        build._libs["glm_sweep"] = libs[plan_of]
        for label, link, x, *_ in cases:
            print("glm_plan: " + json.dumps(
                {"case": label, **kernels.glm_sweep_plan(
                    x.dtype, link, x.shape[1])}), flush=True)
    finally:
        build._libs.pop("glm_sweep", None)


if __name__ == "__main__":
    sys.exit(main())
