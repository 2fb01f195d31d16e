#!/usr/bin/env python3
"""What S1's and S2's design choices cost, on one NVIDIA card.

Run from the root of a checkout:

    python3 ell_phases.py
    python3 ell_phases.py --config5 [--root DIR]

At the Criteo-class shape (``generate_criteo_like(seed=0)``, 45,840,617
rows x 39 slots, 2^20 columns, drawn on the card) it times, with CUDA
events (5 launches after 1):

- S1 (``ops/kernels.ell_rows``, the logistic link with a standardizing
  scale, and the Gram link without) through ``csrc/ell_sweep.cu`` as it is
  and built with CTAs of 8 and 16 warps (``kRowWarps``; all builds started
  together by ``ops/build.build_variants``), each with hot-column tables of
  0, 1,024, 2,048 and 4,096 slots where the shared memory holds them, in
  turns with cuSPARSE's CSR SpMV X beta; each line carries the table's
  share of the slots and whether mult is bitwise the table-less one;
- S2 (``ops/kernels.ell_cols``, the gradient) over copies of the nonzeros
  in blocks of 2^20, 2^21, 2^22 and 2^23 rows and in one block (the plain
  column order), each timed in turns with cuSPARSE's CSR SpMV X^T r over
  the one-block copy, with its pieces, build time and whether its
  gradient is bitwise the one-block copy's.

With ``--config5`` it takes BASELINE configuration 5 instead (the
NYTimes-shape bag of words, 300,000 x 102,660, 232 slots, as chip_smoke.py
phase 26 draws it) and times the Lanczos step's two kernels (S1 at the
Gram link, then S2) with CUDA events (20 launches after 2), the column
copy's build and ``RowMatrix.compute_svd(20)`` twice, through the package
under ``--root`` (default: this checkout). The wrappers' calls it makes
are those every version of the sparse tier has taken, so the same script
times an older checkout's package beside this one's.

It prints the card's name and power limit first and one JSON line per
measurement, and exits non-zero when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

CRITEO_N, CRITEO_D = 45_840_617, 1 << 20
NYT_N, NYT_D, NYT_K, NYT_SV = 300_000, 102_660, 232, 20   # configuration 5
ROW_WARPS = (8, 16)             # S1's CTA widths built beside the source's
HOT_SLOTS = (0, 1024, 2048, 4096)
BLOCKS_LOG2 = (20, 21, 22, 23)  # S2's row blocks beside one block
SMEM_LIMIT = 232_448            # bytes of shared memory a CTA may use
ROUNDS = 2


def _line(tag: str, **fields) -> None:
    print(f"{tag}: " + json.dumps(fields, default=float), flush=True)


def _time_ms(fn, reps: int = 5, warm: int = 1) -> float:
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


def _source_row_warps(src: str) -> int:
    key = "constexpr int kRowWarps = "
    return int(src[src.index(key) + len(key):].split(";")[0])


def config5(root: str) -> None:
    """The Lanczos step's kernels and the SVD at configuration 5's shape,
    through the package under ``root``."""
    import torch
    from cycloneml_tpu_torch import CycloneConf, CycloneContext
    from cycloneml_tpu_torch.dataset.random import nytimes_like
    from cycloneml_tpu_torch.dataset.sparse import SparseInstanceDataset
    from cycloneml_tpu_torch.linalg.distributed import RowMatrix
    from cycloneml_tpu_torch.ops import kernels

    ctx = CycloneContext(CycloneConf().set("cyclone.master", "cuda"))
    try:
        idx, val = nytimes_like(NYT_N, NYT_D, NYT_K)
        ds = SparseInstanceDataset.from_ell(ctx, idx, val, n_features=NYT_D)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        columns = ds.columns()
        torch.cuda.synchronize()
        copy_s = time.perf_counter() - t0
        # the hot table where this version has one, as the step passes it
        extra = ({"hot": ds.hot_columns()} if hasattr(ds, "hot_columns")
                 else {})
        g = torch.Generator(device=ds.device).manual_seed(5)
        q = torch.randn(NYT_D, generator=g, device=ds.device)

        def s1():
            return kernels.ell_rows(ds.indices, ds.values, ds.y, ds.w, q,
                                    0.0, kernels.GRAM, None, **extra)

        mult = s1()[0]

        def s2():
            return kernels.ell_cols(ds.indices, ds.values, mult, NYT_D,
                                    columns=columns)

        svd_s, steps = [], []
        for _ in range(2):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            RowMatrix(ds).compute_svd(NYT_SV, max_gram_dim=4096, tol=1e-9,
                                      max_iter=300)
            torch.cuda.synchronize()
            svd_s.append(time.perf_counter() - t0)
            steps.append(kernels.ell_rows.launches_by_link[kernels.GRAM])
        _line("config5", root=os.path.abspath(root), n=NYT_N, d=NYT_D,
              k=NYT_K, s1_gram_ms=_time_ms(s1, 20, 2),
              s2_ms=_time_ms(s2, 20, 2), column_copy_s=copy_s,
              pieces=columns.piece_col.shape[0], svd_s=svd_s,
              lanczos_steps=steps)
    finally:
        ctx.stop()


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config5", action="store_true",
                    help="time configuration 5's Lanczos step and SVD")
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)), help="checkout whose package --config5 times")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ell_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.root if args.config5
                    else os.path.dirname(os.path.abspath(__file__)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    if args.config5:
        config5(args.root)
        return 0
    from cycloneml_tpu_torch import CycloneConf, CycloneContext
    from cycloneml_tpu_torch.dataset.random import generate_criteo_like
    from cycloneml_tpu_torch.ops import build, kernels

    src = (build.CSRC_DIR / "ell_sweep.cu").read_text()
    own = _source_row_warps(src)
    key = f"constexpr int kRowWarps = {own};"
    variants = {f"w{w}": [(key, f"constexpr int kRowWarps = {w};")]
                for w in ROW_WARPS if w != own}
    libs = build.build_variants("ell_sweep",
                                build.edited_sources(src, variants))
    widths = {"full": own, **{v: int(v[1:]) for v in variants}}

    ctx = CycloneContext(CycloneConf().set("cyclone.master", "cuda"))
    try:
        ds = generate_criteo_like(ctx, CRITEO_N, seed=0, hash_dim=CRITEO_D)
        n, k = ds.indices.shape
        d, dev = CRITEO_D, ds.device
        g = torch.Generator(device=dev).manual_seed(21)
        beta = torch.randn(d, generator=g, device=dev) * 0.1
        scale = torch.rand(d, generator=g, device=dev) + 0.5
        tables = {t: kernels.ell_hot_columns(ds.indices, ds.values, d,
                                             slots=t)
                  for t in HOT_SLOTS if t}
        one = kernels.ell_columns(ds.indices, ds.values, d,
                                  block_rows=1 << max(n - 1, 1).bit_length())
        counts = kernels.column_counts(one, d)
        crow = torch.arange(0, n * k + 1, k, dtype=torch.int32, device=dev)
        x_csr = torch.sparse_csr_tensor(crow, ds.indices.view(-1),
                                        ds.values.view(-1), size=(n, d),
                                        check_invariants=False)

        def rows(link, sc, hot):
            return kernels.ell_rows(ds.indices, ds.values, ds.y, ds.w, beta,
                                    -1.0, link, sc, hot=hot)

        build._libs["ell_sweep"] = libs["full"]
        ref = rows(kernels.LOGISTIC, scale, None)[0]
        for rnd in range(ROUNDS):
            for name, lib in libs.items():
                build._libs["ell_sweep"] = lib
                for t in HOT_SLOTS:
                    tile = widths[name] * 32 * (min(k, 40) | 1) * 4
                    if tile + t * 12 > SMEM_LIMIT:
                        continue
                    hot = tables.get(t)
                    same = torch.equal(rows(kernels.LOGISTIC, scale, hot)[0],
                                       ref)
                    turns = [_time_ms(f) for f in (
                        lambda: rows(kernels.LOGISTIC, scale, hot),
                        lambda: torch.mv(x_csr, beta),
                        lambda: torch.mv(x_csr, beta),
                        lambda: rows(kernels.LOGISTIC, scale, hot))]
                    _line("s1", round=rnd, row_warps=widths[name],
                          hot_slots=t, hot_share=0.0 if hot is None
                          else kernels.hot_share(hot, counts),
                          turns_kernel_spmv_spmv_kernel_ms=turns,
                          gram_unscaled_ms=_time_ms(
                              lambda: rows(kernels.GRAM, None, hot)),
                          mult_bitwise_as_without_table=same)
        del x_csr, crow
        build._libs["ell_sweep"] = libs["full"]
        mult = ref
        col_ptr = torch.zeros(d + 1, dtype=torch.int64, device=dev)
        col_ptr[1:] = torch.cumsum(counts, 0)
        xt_csr = torch.sparse_csr_tensor(col_ptr.int(), one.rows, one.vals,
                                         size=(d, n), check_invariants=False)
        g_one = kernels.ell_cols(ds.indices, ds.values, mult, d, columns=one)
        for lg in (*BLOCKS_LOG2, None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cols = one if lg is None else kernels.ell_columns(
                ds.indices, ds.values, d, block_rows=1 << lg)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            same = torch.equal(kernels.ell_cols(ds.indices, ds.values, mult,
                                                d, columns=cols), g_one)
            for rnd in range(ROUNDS):
                turns = [_time_ms(f) for f in (
                    lambda: kernels.ell_cols(ds.indices, ds.values, mult, d,
                                             columns=cols),
                    lambda: torch.mv(xt_csr, mult),
                    lambda: torch.mv(xt_csr, mult),
                    lambda: kernels.ell_cols(ds.indices, ds.values, mult, d,
                                             columns=cols))]
                _line("s2", round=rnd, block_rows=cols.block_rows,
                      blocks=cols.block_ptr.shape[0] - 1,
                      pieces=cols.piece_col.shape[0],
                      build_s=build_s if lg is not None else None,
                      turns_kernel_xtr_xtr_kernel_ms=turns,
                      grad_bitwise_as_one_block=same)
            del cols
    finally:
        ctx.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
