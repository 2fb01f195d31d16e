#!/usr/bin/env python3
"""Where the time of ALS's normal equations (``als_normal``) goes, on one
NVIDIA card.

Run from the root of a checkout:

    python3 als_phases.py

At BASELINE configuration 4 (chip_smoke.py's copy of
benchmarks/als_scale.py's ``make_data``: MovieLens-25M's shape, 24,000,095
training ratings, rank 64; random factors as chip_smoke.py phase 34 draws
them) it builds ``cycloneml_tpu_torch/csrc/als_normal.cu`` as it is and
five variants of it, each with phases of the tensor-core instance taken
out: the factor rows' copies into the ring (``no_gathers``; the ids and
ratings are still copied), the mma.sync products (``no_products``; the
fragments are still loaded and split), the epilogue (``no_epilogue``: the
shared tiles, the stores of A and b), all three (``skeleton``: what a CTA
costs beside them: its ids and ratings, its barriers, its fragments), and
the whole body (``empty``: the launch of one CTA a piece alone),
all nvcc processes started together (``ops/build.build_variants``, into
``cycloneml_tpu_torch/_build/als_normal_variants/``). Then it times
``ops/kernels.als_normal`` through each build (CUDA events, 5 launches
after 1) for both half-steps, explicit, and for the build as it is also
implicit and the FMA instance (``instance="fma"``, the earlier float32
design), in two rounds (the second in reverse build order), one JSON line
per build and round. A variant computes a wrong answer by design: the
time it saves is what that phase costs where it cannot overlap the
others. It prints the card's name and power limit first, and exits
non-zero when no CUDA device is present.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROUNDS = 2
REPS, WARM = 5, 1
_GATHER = ("              hopper::cp_async16(\n"
           "                  hopper::smem_u32(dst + k * kPitch + c),")
_PRODUCTS = ("  mma_tf32(c, al, bh0, bh1);\n  mma_tf32(c, ah, bl0, bl1);\n"
             "  mma_tf32(c, ah, bh0, bh1);")
_STORE = "    if (live) {\n      if (diag && ra == rb)\n        tc_store<true>"
_COPY_OUT = ("    tc_copy_out<kThreadsN>(up, adst, r, ci, cj, wi, wj, vec_out, "
             "tid);")
# each variant: (text of the kernel, replacement) pairs, each text found
# once (ops/build.edited_sources); r < 0 never holds, so each taken-out
# step stays in the code the compiler sees
_NO_GATHERS = [(_GATHER, "              if (r < 0) " + _GATHER.strip())]
_NO_PRODUCTS = [(_PRODUCTS,
                 "  c[0] += __uint_as_float(al[0] ^ bh0 ^ ah[1] ^ bl1);")]
_NO_EPILOGUE = [(_STORE, _STORE.replace("if (live)", "if (live && r < 0)")),
                (_COPY_OUT, "    if (r < 0) " + _COPY_OUT.strip())]
_BODY = ("  for (int p = blockIdx.y; p < pairs; p += gridDim.y) {\n"
         "    int ti = 0, tj = 0;")
VARIANTS = {
    # one CTA a piece that returns at once: the launch and the dispatch of
    # the CTAs
    "empty": [(_BODY, "  if (r > 0) return;\n" + _BODY)],
    "no_gathers": _NO_GATHERS,
    "no_products": _NO_PRODUCTS,
    "no_epilogue": _NO_EPILOGUE,
    "skeleton": _NO_GATHERS + _NO_PRODUCTS + _NO_EPILOGUE,
}


def _orders():
    """Configuration 4's two half-steps: {side: (source factors, order,
    the implicit mode's Y^T Y)}."""
    import torch
    import chip_smoke
    from cycloneml_tpu_torch.ml.recommendation import als
    data = chip_smoke._als_data()
    tr = data["train"]
    uid, users = als.compact_ids(data["users"][tr])
    iid, items = als.compact_ids(data["items"][tr])
    n_u, n_i = len(uid), len(iid)
    ord_u, ord_i = als.build_orders(users, items, data["ratings"][tr], n_u,
                                    n_i, torch.float32, torch.device("cuda"))
    g = torch.Generator(device="cuda").manual_seed(5)
    r = chip_smoke.ALS_RANK
    fac = {side: torch.randn(n, r, generator=g, device="cuda").abs()
           / r ** 0.5 for side, n in (("users", n_u), ("items", n_i))}
    return {side: (fac[src], order, torch.mm(fac[src].T, fac[src]))
            for side, src, order in (("users", "items", ord_u),
                                     ("items", "users", ord_i))}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("als_phases: no CUDA device; this needs the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chip_smoke import ALS_REG, _time_ms
    from cycloneml_tpu_torch.ops import build, kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or "not measured (nvidia-smi gave nothing)",
          flush=True)
    libs = build.build_variants("als_normal", build.edited_sources(
        (build.CSRC_DIR / "als_normal.cu").read_text(), VARIANTS))
    cases = _orders()
    names = list(libs)
    try:
        for rnd in range(ROUNDS):
            for name in (names if rnd % 2 == 0 else names[::-1]):
                build._libs["als_normal"] = libs[name]  # the wrapper's
                ms = {}
                for side, (src, order, yty) in cases.items():
                    for implicit in (False, True):
                        for inst in (kernels.TENSOR_CORE, kernels.FMA):
                            if name != "full" and (implicit or
                                                   inst == kernels.FMA):
                                continue
                            label = side + (" implicit" if implicit else "")
                            if inst == kernels.FMA:
                                label += " fma"
                            ms[label] = _time_ms(
                                lambda: kernels.als_normal(
                                    src, order, implicit, 1.0, ALS_REG,
                                    yty if implicit else None,
                                    instance=inst), REPS, WARM)
                print("als_phase: " + json.dumps(
                    {"build": name, "round": rnd, "ms": ms}), flush=True)
    finally:
        build._libs.pop("als_normal", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
