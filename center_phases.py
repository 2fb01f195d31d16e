#!/usr/bin/env python3
"""Where KMeans' center sums spend their time, on one NVIDIA card.

Run from the root of a checkout:

    python3 center_phases.py [--parent OLD_center_sums.cu]

At configuration 3 (``RandomDatasets.normal(seed=12)``, 10,000,000 x 128,
bf16 tier; the assignment K3 gives to the centers of ``KMeans(k=1000,
maxIter=10, tol=1e-5, seed=3)``, chip_smoke.py phase 8's fit) it times each
stage of the center sums alone, with CUDA events (10 calls after 2) and
torch.profiler's device time:

- the sorted instance (``ops/kernels._sorted_launch``, the one past
  ``COUNT_MAX_K`` clusters): the int64 cast of the assignment,
  ``torch.sort``, the int32 cast of its indices, the ``bincount`` and
  ``cumsum`` offsets, and the whole call (its sums are the counting
  instance's kernels on the same order);
- the counting instance (the default up to ``COUNT_MAX_K`` clusters): its
  histogram, its scans (beside the same scan by ``torch.cumsum`` and the
  offsets from its result, the alternative), its scatter,
  ``center_warp_kernel`` and the reduce, each alone on a scratch the
  whole call filled (the C entry point's stage bits);
- both instances whole, in turns (sorted, counting, counting, sorted),
  their scratch beyond the inputs, and whether their results are bitwise
  equal and the counting order is ``torch.sort``'s;
- with ``--parent``, an earlier ``center_sums.cu`` whose C entry point
  ``center_sums_launch`` takes the int64 ``torch.sort`` order and no stage
  bits (the design of one CTA per piece and block of 128 columns, a
  thread a column and the column after the last summing w): built as it
  is and with its piece grid leaving out the weights' column, each launch
  (its piece kernel and reduce) timed on the same order, in turns with
  the counting instance, its whole call (cast, sort, offsets, launch),
  and whether its sums are bitwise the counting instance's.

It prints the card's name and power limit first and one JSON line per
measurement, and exits non-zero when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

KM_N, KM_D, KM_K = 10_000_000, 128, 1000    # configuration 3
REPS, WARM = 10, 2
H100_BYTES_PER_S = 3.35e12                  # HBM3, H100 SXM data sheet
# the earlier source's piece grid, and the same without the weights'
# column (at d = 128: one block of 128 columns instead of two)
GRID = ("const unsigned col_blocks = (unsigned)((n_cols + 1 + kCols - 1) / "
        "kCols);\n  if (max_pieces > 0)")
GRID_NO_W = ("const unsigned col_blocks = (unsigned)((n_cols + kCols - 1) / "
             "kCols);\n  if (max_pieces > 0)")
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
PARENT_ARGS = [_I, _I, _P, _P, _P, _P, _P, _I, _LL, _I, _LL, _P, _P, _P, _P]


def _line(tag: str, **fields) -> None:
    print(f"{tag}: " + json.dumps(fields, default=float), flush=True)


def _time_ms(fn, reps: int = REPS, warm: int = WARM) -> float:
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


def _device_ms(fn, reps: int = REPS):
    """Device time per call by kernel name (torch.profiler over ``reps``
    calls after two), and their total; None when the profiler saw no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0.0)
        if us > 0:
            by_name[e.key[:60]] = us / reps / 1000.0
    if not by_name:
        return None
    return {"total_ms": sum(by_name.values()), "kernels_ms": by_name}


def _scratch_mib(fn) -> float:
    """Device memory one call takes beyond what is held before it."""
    import torch
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - held) / 2**20


def _data(ctx):
    """Configuration 3's X, w and the assignment to a fit's centers."""
    import torch
    from cycloneml_tpu_torch.dataset.random import RandomDatasets
    from cycloneml_tpu_torch.ml.clustering import KMeans
    from cycloneml_tpu_torch.ops import kernels
    ds = RandomDatasets.normal(ctx, KM_N, KM_D, seed=12)
    model = KMeans(k=KM_K, maxIter=10, tol=1e-5, seed=3).fit(ds)
    c = torch.as_tensor(model.cluster_centers_matrix().to_array(),
                        dtype=torch.float32, device=ds.x.device)
    best, _ = kernels.kmeans_assign(ds.x, c)
    return ds.x, ds.w, best


def _sorted_call(x, w, best):
    from cycloneml_tpu_torch.ops import kernels
    return [t.to(w.dtype) for t in kernels._sorted_launch(
        x, w, best, KM_K, x.shape[1])]


def sorted_design(x, w, best):
    """The sorted instance's bookkeeping, each step alone, and its whole
    call."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    n, d = x.shape
    b64 = best.to(torch.int64)
    idx = torch.sort(b64, stable=True).indices

    def offsets():
        rows = torch.bincount(b64, minlength=KM_K)[:KM_K]
        off = torch.zeros(KM_K + 1, dtype=torch.int64, device=x.device)
        off[1:] = torch.cumsum(rows, 0)
        pcs = torch.zeros(KM_K + 1, dtype=torch.int64, device=x.device)
        pcs[1:] = torch.cumsum((rows + kernels.PIECE_ROWS - 1)
                               // kernels.PIECE_ROWS, 0)
        return off, pcs

    whole = lambda: _sorted_call(x, w, best)  # noqa: E731
    times = {
        "int64_cast_ms": _time_ms(lambda: best.to(torch.int64)),
        "torch_sort_ms": _time_ms(lambda: torch.sort(b64, stable=True)),
        "int32_cast_ms": _time_ms(lambda: idx.to(torch.int32)),
        "bincount_cumsum_ms": _time_ms(offsets),
        "whole_ms": _time_ms(whole),
    }
    _line("sorted_stages", n=n, d=d, k=KM_K, **times,
          device=_device_ms(whole), scratch_mib=_scratch_mib(whole))
    return times


def counting_design(x, w, best):
    """The counting instance's stages, each alone, and the scan by
    torch.cumsum beside its own."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    n, d = x.shape
    k = KM_K
    sc = kernels._scratch(n, k, x.device, d)
    kernels._launch(sc, k, kernels._STAGES_ALL, best, x, w)

    def stage(bits):
        return lambda: kernels._launch(sc, k, bits, best, x, w)

    nb = sc.table.shape[0] // k

    def cumsum_scan():
        # the same bookkeeping by torch: the (cluster, block) table's
        # exclusive scan and the clusters' row and piece offsets
        flat = sc.table
        incl = torch.cumsum(flat, 0, dtype=torch.int32)
        rows = flat.view(k, nb).sum(1)
        pcs = torch.zeros(k + 1, dtype=torch.int64, device=x.device)
        pcs[1:] = torch.cumsum((rows + kernels.PIECE_ROWS - 1)
                               // kernels.PIECE_ROWS, 0)
        return incl - flat, pcs

    kernels._launch(sc, k, kernels._HIST, best)  # a fresh table
    times = {
        "histogram_ms": _time_ms(stage(kernels._HIST)),
        "scan_ms": _time_ms(stage(kernels._HIST | kernels._SCAN))
        - _time_ms(stage(kernels._HIST)),
        "scan_by_torch_cumsum_ms": _time_ms(cumsum_scan),
    }
    kernels._launch(sc, k, kernels._STAGES_ALL, best, x, w)
    times.update({
        "scatter_ms": _time_ms(stage(kernels._SCATTER)),
        "warp_pieces_ms": _time_ms(stage(kernels._PIECES)),
        "reduce_ms": _time_ms(stage(kernels._REDUCE)),
        "order_alone_ms": _time_ms(lambda: kernels._center_order(best, k)),
        "whole_ms": _time_ms(lambda: kernels.center_sums(x, w, best, k)),
    })
    whole = lambda: kernels.center_sums(x, w, best, k)  # noqa: E731
    pieces = int(sc.order.piece_start[k])
    _line("counting_stages", n=n, d=d, k=k, blocks=nb, pieces=pieces,
          **times, device=_device_ms(whole),
          scratch_mib=_scratch_mib(whole))
    return times


def turns(x, w, best):
    """Both instances whole, in turns, and what they agree on."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    n, d = x.shape
    calls = {"sorted": lambda: _sorted_call(x, w, best),
             "counting": lambda: kernels.center_sums(x, w, best, KM_K)}
    a, b = calls["counting"](), calls["sorted"]()
    co = kernels._center_order(best, KM_K)
    same_order = torch.equal(co.order.long(),
                             torch.sort(best.long(), stable=True).indices)
    ms = [_time_ms(calls[name]) for name in (
        "sorted", "counting", "counting", "sorted")]
    n_bytes = n * d * x.element_size() + n * 4 + n * 4 + KM_K * (d + 1) * 4
    _line("turns", n=n, d=d, k=KM_K, sorted_counting_counting_sorted_ms=ms,
          bound_ms=n_bytes / H100_BYTES_PER_S * 1e3, bound_by="bytes",
          bitwise_equal=bool(torch.equal(a[0], b[0])
                             and torch.equal(a[1], b[1])),
          order_is_stable_sort=bool(same_order))
    return a


def parent_design(parent: Path, x, w, best, new):
    """An earlier center_sums.cu (int64 order, no stage bits), with and
    without its weights' column, on the torch.sort order, in turns with
    the counting instance; ``new``: the counting instance's result."""
    import torch
    from cycloneml_tpu_torch.ops import build, kernels
    n, d = x.shape
    k = KM_K
    libs = build.build_variants("center_sums_parent", build.edited_sources(
        parent.read_text(), {"no_w": [(GRID, GRID_NO_W)]}))
    for lib in libs.values():
        lib.center_sums_launch.argtypes = PARENT_ARGS
        lib.center_sums_launch.restype = _I
    b64 = best.to(torch.int64)
    order = torch.sort(b64, stable=True).indices
    rows = torch.bincount(b64, minlength=k)[:k]
    offsets = torch.zeros(k + 1, dtype=torch.int64, device=x.device)
    offsets[1:] = torch.cumsum(rows, 0)
    pieces = torch.zeros(k + 1, dtype=torch.int64, device=x.device)
    pieces[1:] = torch.cumsum((rows + kernels.PIECE_ROWS - 1)
                              // kernels.PIECE_ROWS, 0)
    max_pieces = -(-n // kernels.PIECE_ROWS) + k
    f64 = torch.float64
    partials = torch.empty(max_pieces * (d + 1), dtype=f64, device=x.device)
    sums = torch.empty((k, d), dtype=f64, device=x.device)
    counts = torch.empty(k, dtype=f64, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib, o=order, off=offsets, pcs=pieces):
        err = lib.center_sums_launch(
            kernels._SUM_DTYPE_CODE[x.dtype], kernels._SUM_DTYPE_CODE[w.dtype],
            x.data_ptr(), w.data_ptr(), o.data_ptr(), off.data_ptr(),
            pcs.data_ptr(), k, x.stride(0), d, max_pieces,
            partials.data_ptr(), sums.data_ptr(), counts.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"the earlier center_sums_launch: error {err}")

    def whole():
        b = best.to(torch.int64)
        o = torch.sort(b, stable=True).indices
        r = torch.bincount(b, minlength=k)[:k]
        off = torch.zeros(k + 1, dtype=torch.int64, device=x.device)
        off[1:] = torch.cumsum(r, 0)
        pcs = torch.zeros(k + 1, dtype=torch.int64, device=x.device)
        pcs[1:] = torch.cumsum((r + kernels.PIECE_ROWS - 1)
                               // kernels.PIECE_ROWS, 0)
        launch(libs["full"], o, off, pcs)
        return sums.to(w.dtype), counts.to(w.dtype)

    old = [t.clone() for t in whole()]
    torch.cuda.synchronize()
    counting = lambda: kernels.center_sums(x, w, best, k)  # noqa: E731
    ms = {name: [] for name in ("full", "no_w", "whole", "counting")}
    for rnd in range(2):  # in turns
        names = ("full", "no_w", "whole", "counting")
        for name in (names if rnd == 0 else names[::-1]):
            if name in libs:
                ms[name].append(_time_ms(lambda: launch(libs[name])))
            elif name == "whole":
                ms[name].append(_time_ms(whole))
            else:
                ms[name].append(_time_ms(counting))
    _line("parent_stages", n=n, d=d, k=k, source=str(parent),
          launch_ms=ms["full"], launch_without_w_column_ms=ms["no_w"],
          whole_ms=ms["whole"], counting_whole_ms=ms["counting"],
          device=_device_ms(whole), scratch_mib=_scratch_mib(whole),
          bitwise_equal_to_counting=bool(torch.equal(old[0], new[0])
                                         and torch.equal(old[1], new[1])))


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="an earlier center_sums.cu whose center_sums_launch "
                         "takes the int64 order and no stage bits, built "
                         "and timed beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("center_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    from cycloneml_tpu_torch import CycloneConf, CycloneContext

    ctx = CycloneContext(CycloneConf().set("cyclone.master", "cuda"))
    try:
        x, w, best = _data(ctx)
        sorted_design(x, w, best)
        counting_design(x, w, best)
        new = turns(x, w, best)
        if args.parent is not None:
            parent_design(args.parent, x, w, best, new)
    finally:
        ctx.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
