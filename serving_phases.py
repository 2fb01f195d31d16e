#!/usr/bin/env python3
"""The serving margins kernel by bucket, on one NVIDIA card.

Run from the root of a checkout:

    python3 serving_phases.py [--parent OLD.cu ...] [--variants]
                              [--lanes ovr8,cifar10,...]

It builds ``csrc/serving_margins.cu`` (``ops/kernels.serving_margins``)
and an empty kernel, and for seven lanes of seeded random models, at every
bucket 1, 2, 4, ..., 1,024:

- the OneVsRest gang, 8 models x 1,280 features, float32 coefficients and
  e4m3 codes with their scales;
- the CIFAR-10 gang, 10 models x 3,072 features, float32;
- a multinomial model, 8 margins x 1,280 features, float32;
- a LinearRegression model, 2,000 features (a ragged width), float32;
- one float64 lane, 1 model x 1,280 features, and the OneVsRest gang in
  float64;

it times, with CUDA events (10 replays after 2 of a CUDA graph that holds
``LAUNCHES`` back-to-back launches, the time a launch), the kernel, the
empty kernel (the launch floor: a launch that does nothing, in the same
kind of graph) and ``torch.addmm`` of the intercepts, the rows and the
dequantized coefficients (the library call the port never makes); the
kernel also as back-to-back eager calls (10 after 2), which the host's
launch path paces. Each bucket gets its bytes bound (the rows, the
coefficients, the scales and intercepts read once and the margins written
once, at 3.35 TB/s) beside the floor, the layout and tile the launch
takes (``kernels.serving_margins_plan``), and whether the kernel's margins
are its plain twin's (``serving_margins_plain`` on the card) bit for bit.

Each ``--parent`` also builds an earlier ``serving_margins.cu`` with the
same C entry point (``serving_margins_launch``; e.g. the one-warp-a-margin
design, ``git show 7eea535:cycloneml_tpu_torch/csrc/serving_margins.cu``),
named by its file's stem, times it the same way in turns with this one
(parent, this, this, parent), prints its plan where it exports
``serving_margins_plan``, and checks that the two give the same bits (its
output filled with NaN before its launch); with ``--variants`` likewise
each of ``VARIANTS``, this source with one choice changed
(``ops/build.edited_sources``; its text edits fail loudly when the
kernel's text changes).

It prints the card's name and power limit first and one JSON line per
measurement, and exits non-zero when no CUDA device is present or a check
fails.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPS, WARM = 10, 2
LAUNCHES = 20                       # back-to-back launches a timing graph
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
MAX_BUCKET = 1024
SEED = 21
# name: (models, margins a model, features, dtype, e4m3 codes)
LANES = {"ovr8": (8, 1, 1280, "float32", False),
         "ovr8_e4m3": (8, 1, 1280, "float32", True),
         "cifar10": (10, 1, 3072, "float32", False),
         "multinomial": (1, 8, 1280, "float32", False),
         "linreg": (1, 1, 2000, "float32", False),
         "f64": (1, 1, 1280, "float64", False),
         "ovr8_f64": (8, 1, 1280, "float64", False)}
EMPTY_SRC = r"""
#include <cuda_runtime.h>
__global__ void serving_empty_kernel() {}
extern "C" int serving_empty_launch(void* stream) {
  serving_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
"""
_P, _I = ctypes.c_void_p, ctypes.c_int
# with --variants: this source with one choice changed, each timed in
# turns with it (build.edited_sources: every old text occurs once)
VARIANTS = {
    # every plain-coefficient launch on the staged tiles (e4m3 codes keep
    # the direct layout)
    "staged": [("  if (p.direct) return p;",
                "  p.direct = quantized;\n  if (p.direct) return p;")],
    # every launch on the direct layout (one warp an output)
    "direct": [("  if (p.direct) return p;",
                "  p.direct = true;\n  return p;")],
}


def _line(tag: str, **fields) -> None:
    print(f"{tag}: " + json.dumps(fields, default=float), flush=True)


def _events_ms(fn, reps: int = REPS, warm: int = WARM) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _graph_ms(fn) -> float:
    """The time a call of ``fn`` takes on the device: a CUDA graph of
    ``LAUNCHES`` calls, timed over REPS replays after WARM."""
    import torch
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()                       # an eager call first: nothing loads in
        s.synchronize()            # the capture
        g = torch.cuda.CUDAGraph()
        g.capture_begin(capture_error_mode="thread_local")
        for _ in range(LAUNCHES):
            fn()
        g.capture_end()
    torch.cuda.current_stream().wait_stream(s)
    return _events_ms(g.replay) / LAUNCHES


def _operands(lane, dev):
    """Seeded coefficients, intercepts (and scales) of a lane on ``dev``,
    and the flat dequantized coefficients torch.addmm takes."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.serving.servable import _quantize_rows
    k, km, d, dtype, quantized = LANES[lane]
    dt = getattr(torch, dtype)
    r = np.random.default_rng([SEED, k, d, int(quantized), len(dtype)])
    coef = r.normal(scale=0.05, size=(k, km, d))
    icpt = r.normal(size=(k, km))
    if quantized:
        c, s, i = (t.to(dev) for t in _quantize_rows(coef, icpt, dt))
        flat = c.to(dt) * s[..., None]
    else:
        c = torch.as_tensor(coef).to(dev, dt)
        i, s = torch.as_tensor(icpt).to(dev, dt), None
        flat = c
    rows = torch.as_tensor(r.standard_normal((MAX_BUCKET, d))).to(dev, dt)
    return c, i, s, flat.reshape(k * km, d), rows


def _bound_ms(lane, b) -> float:
    k, km, d, dtype, quantized = LANES[lane]
    e = 8 if dtype == "float64" else 4
    n_bytes = (b * d * e + k * km * d * (1 if quantized else e)
               + k * km * e * (2 if quantized else 1) + k * b * km * e)
    return n_bytes / H100_BYTES_PER_S * 1e3


def _build(parents, variants):
    """The package's library, the empty kernel, the parents' sources and
    (``variants``) this source's VARIANTS, all nvcc processes at once;
    returns the libraries other than the package's."""
    from cycloneml_tpu_torch.ops import build, kernels
    sources = {"empty": EMPTY_SRC}
    for path in parents:
        sources[path.stem] = path.read_text()
    if variants:
        own_src = (build.CSRC_DIR / "serving_margins.cu").read_text()
        edited = build.edited_sources(own_src, VARIANTS)
        sources.update({n: t for n, t in edited.items() if n != "full"})
    with ThreadPoolExecutor(2) as pool:
        own = pool.submit(kernels._library, "serving_margins")
        libs = build.build_variants("serving_phases", sources)
        own.result()
    libs["empty"].serving_empty_launch.argtypes = [_P]
    libs["empty"].serving_empty_launch.restype = _I
    for name, lib in libs.items():
        if name != "empty":
            lib.serving_margins_launch.argtypes = kernels._SIGNATURES[
                "serving_margins"]["serving_margins_launch"]
            lib.serving_margins_launch.restype = _I
            if hasattr(lib, "serving_margins_plan"):
                lib.serving_margins_plan.argtypes = kernels._SIGNATURES[
                    "serving_margins"]["serving_margins_plan"]
                lib.serving_margins_plan.restype = _I
    return libs


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, action="append", default=[],
                    help="an earlier serving_margins.cu with the same C "
                         "entry point, built and timed beside this one "
                         "under its file's stem (repeatable)")
    ap.add_argument("--variants", action="store_true",
                    help="also build and time this source's VARIANTS")
    ap.add_argument("--lanes", default=",".join(LANES),
                    help="the lanes to time, comma-separated (default: "
                         "all of LANES)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serving_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    from cycloneml_tpu_torch.ops import kernels
    from cycloneml_tpu_torch.serving import bucket_sizes

    libs = _build(args.parent, args.variants)
    others = [n for n in libs if n != "empty"]
    dev = torch.device("cuda")

    def empty():
        kernels._cuda_check(libs["empty"].serving_empty_launch(
            torch.cuda.current_stream().cuda_stream), "empty launch")

    floor = _graph_ms(empty)
    _line("launch_floor", ms=floor, card=card)
    failed = []
    for lane in args.lanes.split(","):
        c, i, s, flat, rows = _operands(lane, dev)
        k, km, d, dtype, quantized = LANES[lane]
        code = kernels._SERVING_DTYPE_CODE[rows.dtype]
        for b in bucket_sizes(MAX_BUCKET):
            x = rows[:b].contiguous()
            out = torch.empty((k, b, km), dtype=x.dtype, device=dev)

            def new(x=x, out=out):
                kernels.serving_margins(x, c, i, s, out=out)

            def other(name, x=x, out=out):
                kernels._cuda_check(libs[name].serving_margins_launch(
                    code, int(quantized), x.data_ptr(), c.data_ptr(),
                    kernels._ptr(s), i.data_ptr(), k, b, km, d,
                    out.data_ptr(), torch.cuda.current_stream().cuda_stream),
                    f"{name} serving_margins launch")

            got = kernels.serving_margins(x, c, i, s).clone()
            twin = kernels.serving_margins_plain(x, c, i, s)
            row = {"lane": lane, "bucket": b, "models": k, "margins": km,
                   "d": d, "dtype": dtype, "e4m3": quantized,
                   "bound_ms": _bound_ms(lane, b), "floor_ms": floor,
                   "equal_to_twin": bool(torch.equal(got, twin)),
                   "plan": kernels.serving_margins_plan(
                       x.dtype, quantized, b, k * km, d)}
            # each other build in turns with this one: other, this, this,
            # other; its bits against this one's (over NaN, so a launch
            # that writes nothing fails) and its plan where it has one
            row["ms"] = []
            for name in others:
                if hasattr(libs[name], "serving_margins_plan"):
                    plan = (ctypes.c_int * 8)()
                    kernels._cuda_check(libs[name].serving_margins_plan(
                        code, int(quantized), b, k * km, d, plan),
                        f"{name} serving_margins plan")
                    row[f"{name}_plan"] = dict(zip(row["plan"], plan))
                out.fill_(float("nan"))
                other(name)
                torch.cuda.synchronize()
                row[f"equal_to_{name}"] = bool(torch.equal(got, out))
                ms = []
                for turn in (name, "kernel", "kernel", name):
                    t = _graph_ms(new if turn == "kernel"
                                  else lambda: other(name))
                    (row["ms"] if turn == "kernel" else ms).append(t)
                row[f"{name}_ms"] = ms
                row[f"{name}_eager_ms"] = _events_ms(lambda: other(name))
            if not others:
                row["ms"] = [_graph_ms(new)]
            row["eager_ms"] = _events_ms(new)
            row["addmm_ms"] = _graph_ms(
                lambda x=x: torch.addmm(i.reshape(-1), x, flat.T))
            row["share_of_bound"] = row["bound_ms"] / min(row["ms"])
            _line("serving_bucket", **row)
            if not all(v for key, v in row.items()
                       if key.startswith("equal_to_")):
                failed.append((lane, b))
    _line("serving_phases_done", card=card, failed=failed,
          launches=kernels.serving_margins.launches)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
