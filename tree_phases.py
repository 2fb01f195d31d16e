#!/usr/bin/env python3
"""Where the decision-tree level histogram (``tree_hist``) spends its time,
on one NVIDIA card.

Run from the root of a checkout:

    python3 tree_phases.py [--variants] [--parent OLD_tree_hist.cu]

On HIGGS's shape (chip_smoke.py's ``_higgs``: 11,000,000 x 28 drawn on the
card from seed 23, bf16 X, binned at maxBins 32 by ``BinnedDataset`` into
one-byte bins; classification channels, C = 3) it times, with CUDA events
(5 calls after 2, 3 for 20 trees) and torch.profiler's device time by
kernel, four levels:

- ``dt0``: a DecisionTree's level 0 (one tree, every row at node 0);
- ``rf0``: a 20-tree forest's level 0 (Poisson(1) counts drawn on the card,
  a row out of a tree's sample at -1);
- ``dt5`` and ``rf5``: a deep level of 32 nodes (a_pad 32), each row's
  node the five bits of its bins of five features against bin 16 (tree t:
  features t, t + 5, ..., mod 28), so that a node's rows lie scattered as
  in a grown tree.

For each: the keys (``kernels.tree_keys``), the keys and the sort
(``kernels.tree_launch_inputs``), the sort alone (``kernels.tree_order``),
the piece table by windows of rows (the C entry's stage 1 alone), the
pieces (stage 2 alone on that order and table), the reduce (stage 4
alone on the filled partials), and the whole call (``kernels.tree_hist``);
at the deep levels the launch (stages 1, 2 and 4) with its windows and in
one window, in turns; with the
plan (``tree_hist_plan``), the pieces, the bytes bounds at 3.35 TB/s with
the bins at one byte and at int32, and the largest difference from the
plain twin in float64 relative to the cell. With ``--parent``, an earlier
``tree_hist.cu`` whose C entry point takes int32 bins and a piece table
built on the host (the lane-a-bin design, e.g. ``git show
3420739:cycloneml_tpu_torch/csrc/tree_hist.cu``) is built and driven as
its wrapper drove it (the same sort, the offsets read back, the pieces
cut in numpy and copied over, the launch), in turns with this one (new,
parent, parent, new), and its tables compared.

With ``--variants``, the pieces stage is timed beside this kernel built
with the sums taken out and with the gathers taken out (``VARIANTS``:
text edits that fail loudly when the kernel's text changes).

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

REPS, WARM = 5, 2
DEEP_NODES = 32
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
PARENT_ARGS = [_P, _P, _P, _P, _P, _P, _LL, _P, _LL, _LL, _I, _I, _I, _I, _I,
               _I, _P, _P, _P]


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


def _device_ms(fn, reps: int = 3):
    """Device time per call by kernel name (torch.profiler over ``reps``
    calls after one); None when the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
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


def _levels(bins, y):
    """The four levels' (name, chans, pos, a_pad)."""
    import torch
    import chip_smoke
    from cycloneml_tpu_torch.ml.tree import impl
    n, d = bins.shape
    dev = bins.device
    g = torch.Generator(device=dev).manual_seed(chip_smoke.TREE_SEED)
    w = torch.ones(n, dtype=torch.float64, device=dev)
    label = y.to(torch.int64)
    out = []
    for trees in (1, chip_smoke.RF_TREES):
        cnt = (torch.poisson(torch.ones((n, trees), device=dev), generator=g)
               if trees > 1 else torch.ones((n, 1), device=dev))
        chans = impl._channels(cnt, y.to(torch.float64), w, label, 2)
        live = cnt > 0
        del cnt
        pos0 = torch.where(live, 0, -1).to(torch.int32)
        node = torch.zeros((n, trees), dtype=torch.int32, device=dev)
        for t in range(trees):
            for k in range(5):
                f = (t + 5 * k) % d
                node[:, t] += (bins[:, f] > 15).to(torch.int32) << k
        deep = torch.where(live, node, -1).to(torch.int32)
        del node, live
        tag = "dt" if trees == 1 else "rf"
        out += [(f"{tag}0", chans, pos0, 1), (f"{tag}5", chans, deep,
                                              DEEP_NODES)]
    return out


def new_design(name, bins, chans, pos, a_pad, n_bins):
    """This checkout's stages, each alone, and the whole call."""
    import torch
    import chip_smoke
    from cycloneml_tpu_torch.ops import kernels
    n, d = bins.shape
    T, C = chans.shape[1], chans.shape[2]
    dev = bins.device
    dbc = d * n_bins * C
    lp = kernels.tree_launch_inputs(pos, 0, T, a_pad, dbc)
    keys = kernels.tree_keys(pos, 0, T, a_pad)
    scratch = kernels.tree_launch_scratch(lp, dbc)
    out = torch.empty((T, a_pad, d, n_bins, C), dtype=torch.float32,
                      device=dev)

    def launch(stages):
        kernels._tree_launch(bins, chans, lp, 0, a_pad, n_bins, scratch, out,
                             stages)

    def whole():
        return kernels.tree_hist(bins, chans, pos, a_pad, n_bins)
    launch(7)
    reps = 3 if T > 1 else REPS
    times = {
        "keys_ms": _time_ms(lambda: kernels.tree_keys(pos, 0, T, a_pad),
                            reps),
        "keys_and_sort_ms": _time_ms(lambda: kernels.tree_launch_inputs(
            pos, 0, T, a_pad, dbc), reps),
        "sort_ms": _time_ms(lambda: kernels.tree_order(keys, T * a_pad),
                            reps),
        "piece_table_ms": _time_ms(lambda: launch(1), reps),
        "pieces_ms": _time_ms(lambda: launch(2), reps),
        "reduce_ms": _time_ms(lambda: launch(4), reps),
        "whole_ms": _time_ms(whole, reps),
    }
    if lp.n_windows > 1:
        # the same level in one window (the pieces of each key in row
        # order), in turns with the windows
        one = lp._replace(n_windows=1, max_pieces=-(-n * T // lp.piece_rows)
                          + lp.n_keys)
        scratch_one = kernels.tree_launch_scratch(one, dbc)
        ms = {"windows": [], "one_window": []}
        for who in ("windows", "one_window", "one_window", "windows"):
            lpw, scw = (lp, scratch) if who == "windows" else (one,
                                                                scratch_one)
            ms[who].append(_time_ms(lambda: kernels._tree_launch(
                bins, chans, lpw, 0, a_pad, n_bins, scw, out), reps))
        times["launch_ms_by_windows"] = ms
        del scratch_one
    got = whole()
    twin = kernels.tree_hist_plain(bins, chans.double(), pos, a_pad, n_bins)
    rel = float(((got.double() - twin).abs()
                 / twin.abs().clamp(min=1e-30)).max())
    active = int((pos >= 0).sum())
    plan = kernels.tree_hist_plan(n_bins, C, d, bins.dtype)
    least, design = chip_smoke._tree_hist_bytes(
        n, d, T, C, a_pad, n_bins, active, bins.element_size(),
        plan["feature_blocks"])
    least32, _ = chip_smoke._tree_hist_bytes(n, d, T, C, a_pad, n_bins,
                                             active)
    bps = chip_smoke.H100_BYTES_PER_S
    _line(f"{name}_stages", n=n, d=d, trees=T, a_pad=a_pad, C=C, B=n_bins,
          active_row_trees=active, pieces=int(scratch[0][-1]),
          piece_rows=lp.piece_rows, windows=lp.n_windows,
          max_pieces=lp.max_pieces, plan=plan,
          **times, bound_ms=least / bps * 1e3,
          bound_int32_bins_ms=least32 / bps * 1e3,
          design_bound_ms=design / bps * 1e3,
          share=least / bps * 1e3 / times["whole_ms"],
          counts_exact=bool(torch.equal(got[..., 0].double(), twin[..., 0])),
          max_rel_to_twin=rel, device=_device_ms(whole))
    return got


# the kernel with one phase taken out: the sums (the rows' loop), or the
# gathers (every sub-chunk past the first ring's reuses its staged rows,
# and the row ids are made up, not read)
VARIANTS = {
    "no_sums": [("        const int steps = kWhole ? kSub / 16 : "
                 "(m + 15) / 16;", "        const int steps = 0;")],
    "no_gathers": [("? (order[first + i] - tl) / tg",
                    "? (int)((first + i) & 1023)"),
                   ("    if (row < 0) return;\n    const int slot",
                    "    if (row < 0 || sub >= kStages) return;\n"
                    "    const int slot")],
}


def variants(levels, bins, n_bins):
    """The pieces stage of this checkout's kernel and of VARIANTS, in turns
    (full, variants, variants reversed, full), at each level."""
    import torch
    from cycloneml_tpu_torch.ops import build, kernels
    src = (build.CSRC_DIR / "tree_hist.cu").read_text()
    libs = build.build_variants("tree_hist",
                                build.edited_sources(src, VARIANTS))
    for lib in libs.values():
        for fn, argtypes in kernels._SIGNATURES["tree_hist"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I
    d = bins.shape[1]
    for name, chans, pos, a_pad in levels:
        T, C = chans.shape[1], chans.shape[2]
        dbc = d * n_bins * C
        lp = kernels.tree_launch_inputs(pos, 0, T, a_pad, dbc)
        seg, table, partial = kernels.tree_launch_scratch(lp, dbc)
        out = torch.empty((T, a_pad, d, n_bins, C), dtype=torch.float32,
                          device=bins.device)

        def launch(lib, stages):
            kernels._cuda_check(lib.tree_hist_launch(
                bins.data_ptr(), bins.element_size(), bins.stride(0),
                chans.data_ptr(), chans.stride(0), chans.stride(1),
                lp.order.data_ptr(), lp.offsets.data_ptr(), lp.n_keys,
                lp.piece_rows, lp.n_windows, lp.max_pieces, d, n_bins, C, 0,
                a_pad, seg.data_ptr(), table.data_ptr(), partial.data_ptr(),
                out.data_ptr(), stages,
                torch.cuda.current_stream().cuda_stream), "variant launch")

        names = list(libs)
        ms = {v: [] for v in names}
        reps = 3 if T > 1 else REPS
        for v in names + names[::-1]:
            launch(libs[v], 1)             # its own piece table
            ms[v].append(_time_ms(lambda: launch(libs[v], 2), reps))
        _line(f"{name}_variants", pieces_ms=ms)


def _pieces_host(offsets, dbc, out_elems, piece_rows=8192,
                 budget_bytes=1 << 30):
    """The first design's host piece table: each key's rows cut into
    pieces of the least piece_rows x 2^j whose partial tables fit the
    budget (or twice the output)."""
    import numpy as np
    rows = np.diff(offsets)
    budget = max(budget_bytes, 8 * out_elems)
    while True:
        per_key = -(-rows // piece_rows)
        if int(per_key.sum()) * dbc * 4 <= budget or \
                piece_rows >= max(int(rows.max(initial=0)), 1):
            break
        piece_rows *= 2
    key_piece = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum(per_key, out=key_piece[1:])
    n_pieces = int(key_piece[-1])
    piece_key = np.repeat(np.arange(len(rows), dtype=np.int32), per_key)
    piece_first = (offsets[:-1][piece_key]
                   + (np.arange(n_pieces) - key_piece[piece_key]) * piece_rows)
    piece_len = np.minimum(offsets[1:][piece_key] - piece_first,
                           piece_rows).astype(np.int32)
    return piece_key, piece_first, piece_len, key_piece


def parent_call(lib, bins32, chans, pos, a_pad, n_bins):
    """The earlier design's whole call, as its wrapper made it."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    n, d = bins32.shape
    T, C = chans.shape[1], chans.shape[2]
    dev = bins32.device
    dbc = d * n_bins * C
    out = torch.empty((T, a_pad, d, n_bins, C), dtype=torch.float32,
                      device=dev)
    keys = torch.where(pos >= 0, pos + torch.arange(
        T, device=dev, dtype=torch.int32) * a_pad,
        torch.full_like(pos, -1)).T.contiguous().view(-1)
    order, offsets = kernels.tree_order(keys, T * a_pad)
    pk, pf, pl, kp = _pieces_host(offsets.cpu().numpy(), dbc,
                                  T * a_pad * dbc)
    tabs = [torch.from_numpy(x).to(dev) for x in (pk, pf, pl, kp)]
    partial = torch.empty(len(pk) * dbc, dtype=torch.float32, device=dev)
    err = lib.tree_hist_launch(
        bins32.data_ptr(), chans.data_ptr(), order.data_ptr(),
        tabs[0].data_ptr(), tabs[1].data_ptr(), tabs[2].data_ptr(), len(pk),
        tabs[3].data_ptr(), T * a_pad, n, d, n_bins, C, T, 0, a_pad,
        partial.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the earlier tree_hist_launch: error {err}")
    return out


def parent_design(parent: Path, levels, bins, n_bins, new_tables):
    """The earlier tree_hist.cu on int32 bins, in turns with this one."""
    import torch
    from cycloneml_tpu_torch.ops import build, kernels
    lib = build.build_variants("tree_hist_parent",
                               {"full": parent.read_text()})["full"]
    lib.tree_hist_launch.argtypes = PARENT_ARGS
    lib.tree_hist_launch.restype = _I
    bins32 = bins.to(torch.int32).contiguous()
    for (name, chans, pos, a_pad), new in zip(levels, new_tables):
        T = chans.shape[1]
        rows_first = chans.contiguous()    # the earlier engine's layout
        reps = 3 if T > 1 else REPS
        calls = {"new": lambda: kernels.tree_hist(bins, chans, pos, a_pad,
                                                  n_bins),
                 "parent": lambda: parent_call(lib, bins32, rows_first,
                                               pos, a_pad, n_bins)}
        old = calls["parent"]()
        ms = {"new": [], "parent": []}
        for who in ("new", "parent", "parent", "new"):
            ms[who].append(_time_ms(calls[who], reps))
        rel = float(((old.double() - new.double()).abs()
                     / new.double().abs().clamp(min=1e-30)).max())
        _line(f"{name}_turns", source=str(parent), new_ms=ms["new"],
              parent_ms=ms["parent"],
              speedup=min(ms["parent"]) / min(ms["new"]),
              counts_equal=bool(torch.equal(old[..., 0], new[..., 0])),
              max_rel_new_vs_parent=rel,
              parent_device=_device_ms(calls["parent"]))
        del old, rows_first


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", action="store_true",
                    help="also time the pieces with the sums or the gathers "
                         "taken out (VARIANTS)")
    ap.add_argument("--parent", type=Path, default=None,
                    help="an earlier tree_hist.cu whose tree_hist_launch "
                         "takes int32 bins and a host piece table, built "
                         "and timed in turns with this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tree_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    import chip_smoke
    from cycloneml_tpu_torch.ml.tree import BinnedDataset
    from cycloneml_tpu_torch.ops import build

    build.build_all(["tree_hist", "center_sums"])
    ctx = chip_smoke._context("tree_phases")
    try:
        ds = chip_smoke._higgs(ctx, chip_smoke.HIGGS_N)
        binned = BinnedDataset.from_instance_dataset(ds, 32, 17)
        bins, n_bins = binned.bins, binned.max_bins
        levels = _levels(bins, ds.y)
        del ds
        tables = [new_design(name, bins, chans, pos, a_pad, n_bins)
                  for name, chans, pos, a_pad in levels]
        if args.variants:
            variants(levels, bins, n_bins)
        if args.parent is not None:
            parent_design(args.parent, levels, bins, n_bins, tables)
    finally:
        ctx.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
