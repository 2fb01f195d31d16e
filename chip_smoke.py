#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cycloneml_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing lines of its own; any failure exits non-zero without
the final result line:

1. the card: name and power limit (nvidia-smi), torch device name, count;
2. the build of every kernel from ``cycloneml_tpu_torch/csrc`` (one nvcc per
   source, started together), with each kernel instance's registers,
   shared memory and spills from ``-Xptxas -v`` (K3 and K4: the
   tensor-core instances for bf16 and e4m3 X, the FMA ones for f32);
3. K1 (the GLM sweep, logistic link) against its plain PyTorch version run
   in float64 on the card, at the LogisticRegression fit's shape
   (n=2,000,000, d=1280) for f32 and bf16 X with and without centering,
   and at a ragged shape (n=1,000,003, d=1000): |dloss|/|loss| <= 1e-5,
   max|dgrad| <= 1e-4 max|grad|, sum(w) = n exactly, two launches bitwise
   equal; then its time (CUDA events) beside the plain version's, the
   bound, and a yardstick of two cuBLAS gemvs the port never calls, with
   the instance's plan (ring stages, block rows, shared memory, CTAs
   resident on each SM);
4. LogisticRegression: ``LogisticRegression(maxIter=25, regParam=0.01,
   tol=0.0).fit`` on data generated on the card at bench.py's shape (bf16
   tier, seed 0), through K1 (usePallasKernels=auto) and through the plain
   aggregator (false). K1 must be launched exactly ``total_evals`` times;
   each fit runs 25 iterations or stops on an exact float32 stall; the
   models agree within the reference's kernel-vs-plain bound (rtol 5e-3,
   atol 5e-4) and their final objectives to 1e-4; its iterations and
   evaluations are printed beside those of the sweep's per-row order
   (``ROW_ORDER_COUNTS``), as they are for phases 6, 12 and 13;
5. K2 (the GLM sweep, squared link) with K1's checks, at the
   LinearRegression configuration's shape (n=400,000, d=2000) and a ragged
   one (n=1,000,003, d=1000), timed likewise;
6. LinearRegression at the repo's configuration 2 (``generate_regression
   (seed=11, noise=0.1)`` at 400,000 x 2,000, bf16 tier; ``regParam=0.001,
   elasticNetParam=0.5, maxIter=100, tol=1e-7, solver="l-bfgs"``, so
   OWL-QN), a warm and a steady fit through K2 and through the plain
   aggregator: K2 launched exactly once per loss evaluation, final
   objectives to 1e-4, coefficients within rtol 5e-3, atol 5e-4, and the
   count of coordinates whose zero pattern differs;
7. K3 (nearest-center assignment) against its plain version in float64
   (row chunks) at configuration 3's shape (n=10,000,000, d=128, k=1000;
   bf16 and f32) and a ragged one (n=1,000,003, d=100, k=37): where the
   argmins differ, d2_64[best] - d2_64[best64] <= 1e-5 max(d2_64, |x|^2)
   (the count of such rows is printed), |dist - dist64| <= 1e-4 of the
   same scale, two launches bitwise equal, counted under the instance the
   dtype picks (tensor cores for bf16, FMA for f32); the same rule on bf16
   X at the main shape against 500 center pairs c, c + delta (delta ~
   1e-6, so float32 rounding decides which of a pair wins); times beside
   the plain f32 version, the bound (three bf16 tensor-core passes for
   bf16 and e4m3, with the f32 FMA bound beside it), and a yardstick of
   the chunked f32 product x c^T with TF32 off;
8. KMeans at configuration 3 (``RandomDatasets.normal(seed=12)``, 10M x
   128, bf16 tier; ``k=1000, maxIter=10, tol=1e-5, seed=3``) through K3 and
   through the plain assignment: K3 launched exactly Lloyd steps +
   k-means|| passes times, all of them the tensor-core instance, training
   costs to 1e-4 relative; and one Lloyd step from identical initial
   centers, max|dcenter| <= 1e-4 max|center|; a second fit through K3
   gives bitwise-equal centers and cost; the center sums of one Lloyd step
   (``center_sums``: stable sort + fixed-order sums, no float atomics)
   against float64 ``index_add_`` sums (1e-6 of the largest sum, counts
   exact), two calls bitwise equal, scratch below one copy of X, timed
   beside the ``index_add_`` update they replaced;
9. K4 (the Gramian) against its plain version in float64 (row chunks) at
   400,000 x 2,000 (bf16 and f32) and at a ragged shape with a third of the
   rows masked by w = 0: |dG_ij| <= 1e-4 sqrt(G_ii G_jj), G == G^T
   bitwise, two launches bitwise equal, counted under the dtype's
   instance; times beside the plain f32 version, the bound, the library
   call x^T x (f32, TF32 off) and, as a rate reference that is not the
   same function (its output is bf16), cuBLAS's bf16 x^T x;
10. PCA: ``PCA(k=10).fit`` and ``RowMatrix.compute_svd(k=10)`` on data
   with a known spectrum, X = (Z diag(s)) Q^T at 400,000 x 2,000 (bf16 tier,
   s_j = (j+1)^-1/2, Q orthogonal from a float64 QR), through K4 and
   through the plain Gramian: K4 launched once per Gramian (its
   tensor-core instance), |cos| between
   matched components >= 1 - 1e-6, explained variance and singular values
   to 1e-5 relative; both against Q[:, :10] (min |cos| printed, >= 0.99);
11. the fp8 rung (``cyclone.data.dtype=float8``): K1 and K2 on e4m3 codes
   quantized on the card (``quantize_fp8``) with their per-column
   ``x_scale``, held against their float64 plain versions on the
   dequantized values with phase 3's checks, at the fit shapes and the
   ragged one, and timed (the bound: the bytes of the 1-byte codes);
12. LogisticRegression on the fp8 rung: phase 4's data (generated bf16 on
   the card) quantized on the card, fitted through K1's e4m3 instance and
   through the plain aggregator on identical codes: e4m3 launches equal to
   the evaluations and no bf16/f32 launch, no fp8 fallback, coefficients
   within rtol 5e-3 / atol 5e-4 and objectives to 1e-4 of each other, and
   within the reference's 20% fp8 envelope of the bf16 K1 fit on the same
   rows;
13. LinearRegression at configuration 2 on the fp8 rung through K2's e4m3
   instance, with phase 12's checks;
14. K3 and K4 on e4m3 codes with their x_scale, with phases 7 and 9's
   checks against float64 on the dequantized values, at the same shapes
   (KMeans and PCA are not fp8-capable: no fit launches these instances);
15. K1s (K1's sweep for K models over one X) against its plain version
   in float64 at the fit shape (float32 and bf16 X, bf16 labels beside
   bf16 X) and at the ragged shape with a third of the rows at w=0, for K
   in K1S_MODELS (20 > K_MAX: two launches), with and without centering:
   phase 3's checks per model, one launch per group counted under X's
   dtype and under the instance it picks (tensor cores for bf16 and e4m3,
   FMA for f32), and at K=1 K1s against K1 under the same bounds; times at
   every K beside the plain version, both bounds (the tensor-core one,
   B and the multipliers in three bf16 parts, and the f32-FMA figure) and
   two yardsticks the port never calls (K serial K1 launches, two cuBLAS
   f32 GEMMs);
16. OneVsRest at full width: 8 classes at 2,000,000 x 1280 (bf16;
   ``generate_multiclass``, bench_ovr_stacked's recipe, on the card),
   ``LogisticRegression(maxIter=25, regParam=0.01, tol=0)``,
   parallelism=8 through K1s (warm, steady), through the plain stacked
   aggregator and serially (8 fits through K1): K1s launched exactly once
   per stacked evaluation and K1 never in the stacked fit, coefficients
   within rtol 5e-3 / atol 5e-4 and objectives to 1e-4 of both, the
   predictions agreeing on >= 99.9% of rows; then the same rows quantized
   on the card, stacked through K1s's e4m3 instance;
17. CrossValidator over regParam {0.001, 0.01, 0.1} (3 folds,
   areaUnderROC) on phase 4's data cut to 500,000 rows at full width,
   stacked (K1s, once per evaluation of every fold's fit) and serial: the
   same best regParam, avgMetrics to 1e-4;
18. K1s's e4m3 instance with phase 15's checks on codes with x_scale;
19. LinearRegression through the WLS component (the normal solver) at
   configuration 2's data: a default ``LinearRegression()`` (auto resolves
   to normal, Cholesky) and ``solver="normal", regParam=0.001,
   elasticNetParam=0.5`` (OWL-QN over the moments). The moments against
   float64 moments of the same bf16 rows (|dA_ij| <= 1e-4 sqrt(A_ii A_jj),
   vectors and sums to 1e-5), both fits' coefficients within rtol 5e-3 /
   atol 5e-4 of the float64-moment solve, the elastic-net solution's
   objective, evaluated on the float64 moments, within 1e-4 of phase 6's
   K2 fit's (the objective the fit reports from float32 moments is
   printed beside it), no kernel launched; on the fp8 rung a
   default fit records exactly one precision fallback and launches
   nothing. The moments pass is timed beside its bound (2 n d^2 float32
   operations), with the host solve and the fits;
20. bounded binomial LogisticRegression on phase 4's data
   (``lowerBoundsOnCoefficients = 0``, regParam=0.01, maxIter=25, tol=0;
   L-BFGS-B with host line searches) through K1 and through the plain
   aggregator: K1 launched exactly ``total_evals`` times and no other
   kernel, every coefficient >= 0 exactly (the count at the bound
   printed), models within rtol 5e-3 / atol 5e-4 and objectives to 1e-4;
21. multinomial LogisticRegression on phase 16's data (8 classes,
   maxIter=25, regParam=0.01, tol=0, family auto): one evaluation of the
   plain multinomial aggregator against float64 on the same rows (loss to
   1e-5, gradient to 1e-4 of its largest entry), the fit warm and steady
   (no kernel), the share of its predictions that agree with phase 16's
   OneVsRest model, and the same rows quantized on the card, fitted within
   the 20% fp8 envelope of the bf16 fit;
22. LinearSVC on phase 4's data (regParam=0.01, maxIter=25): one hinge
   evaluation on the standardized copy against float64 (phase 21's
   bounds), the count of rows whose side of the hinge differs, the fit's
   time and peak memory beside X's bytes;
23. GeneralizedLinearRegression (poisson, log link) at 400,000 x 2,000
   bf16 (x from the seeded generator scaled by 1/sqrt(d), y ~ Poisson(
   exp(x.beta)) with beta from numpy): the first IRLS pass's XᵀWX against
   float64 (phase 19's rule), the coefficients within rtol 5e-3 / atol
   5e-4 of a float64 IRLS on the card with as many passes, the pass timed
   beside its bound, the summary's and the fit's times;
24. S1 and S2 (the sparse tier's row and column passes,
   ``csrc/ell_sweep.cu``) against their plain versions in float64 on
   Criteo-class rows drawn on the card (45,840,617 rows, the Criteo
   display-advertising training set's, x 39 slots: 13 integer fields at
   columns 0-12 with log1p(count), 26 categorical fields of zipf(1.1)
   ranks hashed into 2^20 columns; 1.79e9 nonzeros, 14.3 GB of ELL), one
   evaluation per link (logistic with a standardizing scale, squared,
   hinge, Gram) and the moments mode: |dloss| <= 1e-5 |loss|, max|dgrad|
   <= 1e-4 max|grad|, sum(w) exact, two launches bitwise equal; their
   times beside the plain versions, the bounds (bytes, and with one
   32-byte sector a gather) and cuSPARSE CSR SpMV (X beta, X^T r);
25. sparse LogisticRegression on those rows (``maxIter=25,
   regParam=0.01``): the column copy's set-up time and peak memory, a fit
   through S1 and S2 (S1 launched ``total_evals`` times, S2 once more for
   the summary, nothing else), a second one bitwise equal, and the plain
   aggregator's fit: objectives to 1e-4; the two again on the float64
   accumulator tier (``cyclone.compute.dtype=float64``): objectives to
   1e-4, coefficients within rtol 5e-3 / atol 5e-4 (on the float32 tier
   their distance is printed beside that of two plain fits, float32 and
   float64); the split into kernel and host time, peak memory against the
   ELL's bytes, training AUC;
26. BASELINE configuration 5: ``RowMatrix.compute_svd(20, max_gram_dim=
   4096, tol=1e-9, max_iter=300)`` by Lanczos over the NYTimes-shape bag
   of words (300,000 x 102,660, 232 slots, the reference's numpy recipe),
   one Gram matvec (S1 then S2) against float64 and bitwise repeatable,
   S1 and S2 once per Lanczos step, all 20 singular values within 5e-3 of
   scipy's float64 svds on the same CSR (times of both printed);
27. the rest of RowMatrix on phase 10's data: Lanczos
   (``compute_svd(10, max_gram_dim=1024)``) within 1e-4 of the Gramian
   branch, ``multiply`` by a seeded 2,000 x 64 matrix within 1e-5 of
   float64, ``column_similarities`` within 1e-5 of the float64 Gramian's
   cosines (K4 once per Gramian);
28. a ``{"kernels": [...]}`` JSON line with K1-K4, K1s, their e4m3
   instances, the center sums and S1/S2 (K3, K4 and K1s marked as redesigned for
   the tensor cores, with their instance, f32 FMA bounds and ptxas lines;
   K2 in both instances and K1's e4m3 instance marked as redesigned around
   a per-lane cp.async ring, and every GLM sweep with its instance, ring
   plan and ptxas lines; K1's entry also carries its launches in phase
   20's bounded fit), the total wall time; the last line is ``{"ok":
   true, "device": {...}}``.

Phases 19-23 begin by asserting that TF32 is off.

Each path's launch counts are set to 0 just before its fit and read just
after. It exits non-zero, printing no result, when no CUDA device is
present or when the port's package is not beside it.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

FIT_N, FIT_D = 2_000_000, 1280
RAGGED_N, RAGGED_D = 1_000_003, 1000
LIN_N, LIN_D = 400_000, 2000                  # configuration 2 (epsilon)
KM_N, KM_D, KM_K = 10_000_000, 128, 1000      # configuration 3
KM_RAGGED = (1_000_003, 100, 37)
GRAM_N, GRAM_D = 400_000, 2000                # PCA at the epsilon width
GRAM_RAGGED = (300_007, 777)
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores
H100_BF16_FLOPS = 989e12     # bf16 tensor cores, dense
H100_FP8_FLOPS = 1979e12     # fp8 tensor cores, dense
FP8_COEF_NORMREL = 0.20      # the reference's fp8 coefficient envelope
KERNEL_SOURCES = ["glm_sweep", "kmeans_assign", "gramian", "glm_stacked",
                  "center_sums", "ell_sweep"]
K1S_MODELS = (1, 3, 8, 16, 20)   # 20 > K_MAX: two launches of K1s
OVR_K = 8                        # OneVsRest's classes (bench_ovr_stacked)
CV_N = 500_000                   # CrossValidator's rows (the cut of FIT_N)
CV_REGS = (0.001, 0.01, 0.1)
# (iterations, evaluations) of the sweep's fits at these configurations
# when its lanes summed the gradient with a Kahan step a row (PERF.md §6);
# the block order may move them, and a move past 2 is explained there
ROW_ORDER_COUNTS = {"fit": (9, 10), "linreg_fit": (6, 37),
                    "fp8_fit": (9, 10), "fp8_linreg_fit": (6, 37)}
CRITEO_N = 45_840_617   # rows of the Criteo display-advertising training set
CRITEO_D = 1 << 20      # hashed columns (the reference demo's default width)
NYT_N, NYT_D, NYT_K = 300_000, 102_660, 232   # configuration 5 (NYTimes)
NYT_SV = 20                                   # its singular values
MULTIPLY_COLS = 64
DEVICE = "cuda"
ROWS = 1 << 18               # rows generated or checked at a time
ROWS64 = 1 << 16             # rows widened to float64 at a time


def _line(tag: str, **fields) -> None:
    print(f"{tag}: " + json.dumps(fields, default=float), flush=True)


def _time_ms(fn, reps: int, warm: int = 2) -> float:
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


def phase_card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "not measured (nvidia-smi gave nothing)"
    print(card, flush=True)  # name, power limit: as nvidia-smi gives them
    kind = torch.cuda.get_device_name(0)
    _line("device", kind=kind, count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda,
          python=sys.version.split()[0])
    return card, kind


def _kernel_name(mangled: str) -> str:
    """A readable name for a mangled kernel instance: its X (or partial)
    dtype and its other template arguments (glm_sweep_kernel: elements
    per lane and the link, 0 logistic, 1 squared; glm_stacked_kernel:
    columns per thread and models per launch; glm_stacked_tc_kernel:
    k-blocks per warp and models per launch; center_piece_kernel: w's
    dtype; gramian_tc_kernel: the staging; kmeans_assign_tc_kernel:
    whether X is resident)."""
    m = re.search(r"([a-z_]+_kernel)(I(13__nv_bfloat16|13__nv_fp8_e4m3|f|d)?"
                  r"(f|d)?((?:L[ib]\d+E)*))?", mangled)
    if m is None:
        return mangled
    if m.group(2) is None:
        return m.group(1)
    if m.group(1).startswith("ell_"):  # S1's link, S2's mode or width
        arg = [int(a) for a in re.findall(r"L[ib](\d+)E", m.group(5))]
        label = {"ell_rows_kernel": ("logistic", "squared", "hinge", "gram"),
                 "ell_cols_piece_kernel": ("gradient", "moments")}.get(
                     m.group(1))
        text = label[arg[0]] if label else f"M={arg[0]}"
        if len(arg) > 1 and arg[1]:
            text += ", scaled"
        return f"{m.group(1)}<{text}>"
    names = {"f": "f32", "d": "f64", "13__nv_bfloat16": "bf16",
             "13__nv_fp8_e4m3": "e4m3"}
    # the FMA K1s instance takes float32 X only: no type argument
    args = [names[m.group(3)] if m.group(3) else "f32"]
    if m.group(4):  # a second type: the center sums' w
        args.append("w " + names[m.group(4)])
    ints = re.findall(r"Li(\d+)E", m.group(5))
    if len(ints) == 2 and m.group(1) == "glm_stacked_kernel":
        args += [f"C={ints[0]}", f"KG={ints[1]}"]
    elif len(ints) == 2 and m.group(1) == "glm_stacked_tc_kernel":
        args += [f"NB={ints[0]}", f"KG={ints[1]}"]
    elif len(ints) == 2:
        args += [f"E={ints[0]}", ("logistic", "squared")[int(ints[1])]]
    if len(ints) == 1:  # the tensor-core Gramian's staging
        args.append(("cp.async", "cp.async codes", "ld.global")[int(ints[0])])
    bools = re.findall(r"Lb(\d)E", m.group(5))
    if bools:  # the tensor-core assignment: X resident or staged per block
        args.append(("X per block", "X resident")[int(bools[0])])
    return f"{m.group(1)}<{', '.join(args)}>"


def phase_build():
    """Builds every kernel; returns ptxas's lines (registers, shared
    memory, spills) by kernel instance."""
    from cycloneml_tpu_torch.ops import build
    t0 = time.perf_counter()
    build.build_all(KERNEL_SOURCES)
    secs = time.perf_counter() - t0
    ptxas = {}
    for name in KERNEL_SOURCES:
        report = build.ptxas_report(name)
        func = None
        # the report of the build that made the library
        text = report.read_text() if report.exists() else ""
        for ln in text.splitlines():
            if "Compiling entry function" in ln:
                func = _kernel_name(ln.split("'")[1] if "'" in ln else ln)
            elif func and ("registers" in ln or "spill" in ln):
                info = ln.split(':')[-1].strip()
                print(f"ptxas {name} {func}: {info}")
                ptxas.setdefault(func, []).append(info)
    _line("build", sources=KERNEL_SOURCES, seconds=round(secs, 2))
    return ptxas


def _k1_inputs(n, d, seed):
    import torch
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.empty((n, d), dtype=torch.float32, device=dev)
    for lo in range(0, n, 1 << 18):
        x[lo:lo + (1 << 18)] = torch.randn(
            (min(1 << 18, n - lo), d), generator=g, device=dev)
    truth = torch.randn(d, generator=g, device=dev) / d ** 0.5
    y = (x @ truth + torch.randn(n, generator=g, device=dev) > 0).float()
    w = torch.ones(n, device=dev)
    coef = torch.randn(d + 1, generator=g, device=dev) / d ** 0.5
    inv_std = torch.rand(d, generator=g, device=dev) + 0.5
    mu = torch.randn(d, generator=g, device=dev) * 0.5
    return x, y, w, coef, inv_std, mu


def _fold_truth(x, y, w, inv_std, mu, coef, d, x_scale=None):
    """The scaled sweep in float64 through the plain version (on the
    dequantized values when ``x_scale`` is given)."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    c = coef.double()
    beta = inv_std.double() * c[:d]
    off = c[d] - torch.dot(mu.double(), c[:d])
    loss, g, msum, wsum = kernels.glm_sweep_plain(
        x, y, w, beta, off, acc_dtype=torch.float64, x_scale=x_scale)
    grad = torch.cat([inv_std.double() * g - mu.double() * msum,
                      msum.reshape(1)])
    return loss, grad, wsum


def _randn(n, d, g, dtype=None):
    """(n, d) N(0, 1) on the card, drawn ROWS rows at a time."""
    import torch
    x = torch.empty((n, d), dtype=dtype or torch.float32, device=DEVICE)
    for lo in range(0, n, ROWS):
        x[lo:lo + ROWS] = torch.randn((min(ROWS, n - lo), d), generator=g,
                                      device=DEVICE).to(x.dtype)
    return x


def _x_forms(x32, fp8):
    """``(X, x_scale float32, x_scale float64)`` for each form of X a
    kernel phase holds: float32 and bfloat16 X (no scale), or, with
    ``fp8``, the e4m3 codes of x32 quantized on the card
    (``quantize_fp8``) with their per-column scale, float32 for the kernel
    and float64 for the truth."""
    import torch
    if not fp8:
        yield x32, None, None
        yield x32.to(torch.bfloat16), None, None
        return
    from cycloneml_tpu_torch.dataset.instance import quantize_fp8
    x8, scale, _ = quantize_fp8(x32)
    yield (x8, torch.as_tensor(scale, dtype=torch.float32, device=DEVICE),
           torch.as_tensor(scale, dtype=torch.float64, device=DEVICE))


def _dt(x) -> str:
    return str(x.dtype)[6:]


def _main_dtype(fp8):
    """The dtype whose numbers at the main shape go into the kernels
    line: bfloat16, or e4m3 for the fp8 entries."""
    import torch
    return torch.float8_e4m3fn if fp8 else torch.bfloat16


def _bound(n_bytes, flops, peak_flops=H100_F32_FLOPS):
    """(bound ms, what bounds it): the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    t_b, t_o = n_bytes / H100_BYTES_PER_S, flops / peak_flops
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def phase_kernel(fp8=False):
    """K1 against its plain version (on float32 and bf16 X, or with
    ``fp8`` on e4m3 codes with their x_scale); returns the main-shape
    numbers for the kernels line."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    results = {}
    main_dt = _main_dtype(fp8)
    for n, d, seed in ((FIT_N, FIT_D, 1), (RAGGED_N, RAGGED_D, 2)):
        x32, y, w, coef, inv_std, mu = _k1_inputs(n, d, seed)
        for x, s32, s64 in _x_forms(x32, fp8):
            dtype = x.dtype
            for centered in (False, True):
                m = mu if centered else torch.zeros_like(mu)
                got = kernels.fused_binary_logistic_scaled(
                    x, y, w, inv_std, m, coef, d, x_scale=s32)
                again = kernels.fused_binary_logistic_scaled(
                    x, y, w, inv_std, m, coef, d, x_scale=s32)
                torch.cuda.synchronize()
                t_loss, t_grad, t_w = _fold_truth(x, y, w, inv_std, m,
                                                  coef, d, s64)
                rel_loss = abs(float(got["loss"]) - float(t_loss)) \
                    / abs(float(t_loss))
                err = float((got["grad"].double() - t_grad).abs().max())
                gmax = float(t_grad.abs().max())
                bitwise = all(torch.equal(got[k], again[k])
                              for k in ("loss", "grad", "count"))
                ok = (rel_loss <= 1e-5 and err <= 1e-4 * gmax
                      and float(got["count"]) == n and float(t_w) == n
                      and bitwise)
                _line("k1_check", n=n, d=d, dtype=_dt(x),
                      x_scale=s32 is not None, centered=centered,
                      rel_loss=rel_loss,
                      max_abs_grad_err=err, max_abs_grad=gmax,
                      count=float(got["count"]), bitwise_equal=bitwise,
                      ok=ok)
                if not ok:
                    raise AssertionError(f"K1 disagrees with its plain "
                                         f"version at n={n} d={d} {dtype}")
                if n == FIT_N and dtype == main_dt:
                    results["max_abs_err"] = max(
                        results.get("max_abs_err", 0.0), err)
            results.update(_k1_times(x, y, w, coef, inv_std, d, n, s32,
                                     main_dt))
            del x
        del x32
        torch.cuda.empty_cache()
    return results


def _gemv_yardstick(x, beta, residual):
    """The sweep's two gemvs in cuBLAS at X's dtype (``residual(m)`` maps
    the margins to the multipliers); None for e4m3 codes, which torch.mv
    does not take."""
    import torch
    if x.dtype == torch.float8_e4m3fn:
        return None
    xb = beta.to(x.dtype)
    mult = residual(torch.mv(x, xb).float()).to(x.dtype)
    return _time_ms(lambda: (torch.mv(x, xb), torch.mv(x.t(), mult)), 10, 2)


def _k1_times(x, y, w, coef, inv_std, d, n, x_scale, main_dt):
    import torch
    from cycloneml_tpu_torch.ops import kernels
    beta = inv_std * coef[:d]
    off = coef[d]
    dt = _dt(x)
    k_ms = _time_ms(lambda: kernels.glm_sweep(x, y, w, beta, off,
                                              x_scale=x_scale), 20, 3)
    p_ms = _time_ms(lambda: kernels.glm_sweep_plain(x, y, w, beta, off,
                                                    x_scale=x_scale), 3, 1)
    yard_ms = _gemv_yardstick(
        x, beta, lambda m: w * (torch.sigmoid(m + off) - y))
    n_bytes = n * d * x.element_size() + 2 * n * 4 + d * 4 + (d + 3) * 4
    bound, bound_by = _bound(n_bytes, 4.0 * n * d)
    plan = kernels.glm_sweep_plan(x.dtype, kernels.LOGISTIC, d)
    _line("k1_time", n=n, d=d, dtype=dt, kernel_ms=k_ms, plain_ms=p_ms,
          bound_ms=bound, bound_by=bound_by, yardstick_two_gemv_ms=yard_ms,
          achieved_gb_s=n_bytes / k_ms / 1e6, **plan)
    if n == FIT_N and x.dtype == main_dt:
        return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                "bound_by": bound_by, "yardstick_ms": yard_ms, "plan": plan}
    return {}


def _fit(ctx, ds, mode):
    import torch
    from cycloneml_tpu_torch.ml.classification import LogisticRegression
    ctx.conf.set("cyclone.ml.usePallasKernels", mode)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = LogisticRegression(maxIter=25, regParam=0.01, tol=0.0).fit(ds)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def _ran_to_stop(summary) -> bool:
    """maxIter=25 iterations, or an earlier stop that tol=0 allows: the
    objective did not change at all in the last iteration (|df| <= 0),
    which happens once the fit reaches float32 resolution."""
    hist = summary.objective_history
    return summary.total_iterations == 25 or (
        len(hist) >= 2 and hist[-1] == hist[-2])


def _train_accuracy(ds, coef, intercept) -> float:
    """Share of the real rows the model classifies right, on the card."""
    import torch
    c = torch.as_tensor(coef, dtype=torch.float32, device=ds.x.device)
    hits = 0
    for lo in range(0, ds.n_rows, 1 << 18):
        hi = min(lo + (1 << 18), ds.n_rows)
        pred = (ds.x[lo:hi].float() @ c + intercept > 0).float()
        hits += int((pred == ds.y[lo:hi].float()).sum())
    return hits / ds.n_rows


def phase_fit():
    import numpy as np
    import torch
    from cycloneml_tpu_torch import CycloneConf, CycloneContext
    from cycloneml_tpu_torch.dataset.random import generate_classification
    from cycloneml_tpu_torch.ops import kernels

    ctx = CycloneContext(CycloneConf().set("cyclone.app.name", "chip_smoke")
                         .set("cyclone.master", DEVICE))
    try:
        t0 = time.perf_counter()
        ds = generate_classification(ctx, FIT_N, FIT_D, seed=0)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        # the main path: counts zeroed just before, read just after
        kernels.reset_launch_counts()
        k_model, k_warm = _fit(ctx, ds, "auto")
        launches = kernels.glm_sweep.launches_by_link[kernels.LOGISTIC]
        others = _other_launches(kernels, "logistic")
        ks = k_model.summary
        k_again, k_steady = _fit(ctx, ds, "auto")
        p_model, p_warm = _fit(ctx, ds, "false")
        p_again, p_steady = _fit(ctx, ds, "false")
        ps = p_model.summary
        peak = torch.cuda.max_memory_allocated()
        kc, pc = k_model.coefficients.values, p_model.coefficients.values
        coef_ok = bool(np.allclose(kc, pc, rtol=5e-3, atol=5e-4)) and \
            abs(k_model.intercept - p_model.intercept) <= \
            5e-4 + 5e-3 * abs(p_model.intercept)
        obj_rel = abs(ks.objective_history[-1] - ps.objective_history[-1]) \
            / abs(ps.objective_history[-1])
        acc = _train_accuracy(ds, kc, k_model.intercept)
        _line("fit", n=FIT_N, d=FIT_D, data_dtype=str(ds.x.dtype)[6:],
              generate_s=gen_s,
              kernel={"iterations": ks.total_iterations,
                      "evals": ks.total_evals,
                      "row_order_counts": ROW_ORDER_COUNTS["fit"],
                      "dispatches": ks.total_dispatches,
                      "k1_launches": launches, "warm_s": k_warm,
                      "steady_s": k_steady,
                      "final_objective": ks.objective_history[-1]},
              plain={"iterations": ps.total_iterations,
                     "evals": ps.total_evals,
                     "dispatches": ps.total_dispatches, "warm_s": p_warm,
                     "steady_s": p_steady,
                     "final_objective": ps.objective_history[-1]},
              max_abs_coef_diff=float(np.max(np.abs(kc - pc))),
              objective_rel_diff=obj_rel, train_accuracy=acc,
              max_memory_allocated=peak)
        checks = {
            "kernel fit ran 25 iterations or stopped on an exact float32 "
            "stall": _ran_to_stop(ks),
            "plain fit ran 25 iterations or stopped on an exact float32 "
            "stall": _ran_to_stop(ps),
            "K1 launched once per evaluation": launches == ks.total_evals,
            "no other kernel launched": others == 0,
            "coefficients agree (rtol 5e-3, atol 5e-4)": coef_ok,
            "final objectives agree to 1e-4": obj_rel <= 1e-4,
            "finite model": bool(np.all(np.isfinite(kc))),
            "repeat fit reproduces the model": bool(np.array_equal(
                k_again.coefficients.values, kc)),
        }
        for what, ok in checks.items():
            print(f"fit check: {what}: {'ok' if ok else 'FAILED'}")
        if not all(checks.values()):
            raise AssertionError("the fit failed a check")
        return launches
    finally:
        ctx.stop()


def _other_launches(kernels, *own: str) -> int:
    """Launches of every kernel but those named in ``own`` since the last
    reset."""
    counts = {"logistic": kernels.glm_sweep.launches_by_link["logistic"],
              "squared": kernels.glm_sweep.launches_by_link["squared"],
              "kmeans_assign": kernels.kmeans_assign.launches,
              "gramian": kernels.gramian.launches,
              "glm_stacked": kernels.glm_sweep_stacked.launches,
              "center_sums": kernels.center_sums.launches,
              "ell_rows": kernels.ell_rows.launches,
              "ell_cols": kernels.ell_cols.launches}
    return sum(v for k, v in counts.items() if k not in own)


def _context(name):
    from cycloneml_tpu_torch import CycloneConf, CycloneContext
    return CycloneContext(CycloneConf().set("cyclone.app.name", name)
                          .set("cyclone.master", DEVICE))


def _timed(fn):
    """(fn(), seconds) with the card synchronized on both sides."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _check(tag: str, checks: dict) -> None:
    for what, ok in checks.items():
        print(f"{tag} check: {what}: {'ok' if ok else 'FAILED'}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"{tag} failed a check")


# -- K2 and LinearRegression --------------------------------------------------

def phase_k2(fp8=False):
    """K2 against its plain version in float64 (on float32 and bf16 X, or
    with ``fp8`` on e4m3 codes with their x_scale); returns the main-shape
    numbers for the kernels line."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    results = {}
    main_dt = _main_dtype(fp8)
    for n, d, seed in ((LIN_N, LIN_D, 3), (RAGGED_N, RAGGED_D, 4)):
        g = torch.Generator(device=DEVICE).manual_seed(seed)
        x32 = _randn(n, d, g)
        y = torch.randn(n, generator=g, device=DEVICE) * 3 + 1
        w = torch.ones(n, device=DEVICE)
        coef = torch.randn(d, generator=g, device=DEVICE) / d ** 0.5
        inv_std = torch.rand(d, generator=g, device=DEVICE) + 0.5
        for x, s32, s64 in _x_forms(x32, fp8):
            dtype = x.dtype
            for centered in (False, True):
                mu = (torch.randn(d, generator=g, device=DEVICE) * 0.5
                      if centered else torch.zeros(d, device=DEVICE))
                y_pars = torch.tensor([0.4, 0.3 if centered else 0.0],
                                      device=DEVICE)
                got = kernels.fused_least_squares_scaled(
                    x, y, w, inv_std, mu, y_pars, coef, d, x_scale=s32)
                again = kernels.fused_least_squares_scaled(
                    x, y, w, inv_std, mu, y_pars, coef, d, x_scale=s32)
                torch.cuda.synchronize()
                c, s, m, yp = (t.double() for t in (coef, inv_std, mu,
                                                     y_pars))
                t_loss, t_g, t_m, t_w = kernels.glm_sweep_plain(
                    x, y, w, s * c, yp[1] - torch.dot(m, c),
                    acc_dtype=torch.float64, link=kernels.SQUARED, ys=yp[0],
                    x_scale=s64)
                t_grad = s * t_g - m * t_m
                rel_loss = abs(float(got["loss"]) - float(t_loss)) \
                    / abs(float(t_loss))
                err = float((got["grad"].double() - t_grad).abs().max())
                gmax = float(t_grad.abs().max())
                bitwise = all(torch.equal(got[k], again[k])
                              for k in ("loss", "grad", "count"))
                ok = (rel_loss <= 1e-5 and err <= 1e-4 * gmax
                      and float(got["count"]) == n and float(t_w) == n
                      and bitwise)
                _line("k2_check", n=n, d=d, dtype=_dt(x),
                      x_scale=s32 is not None, centered=centered,
                      rel_loss=rel_loss,
                      max_abs_grad_err=err, max_abs_grad=gmax,
                      count=float(got["count"]), bitwise_equal=bitwise,
                      ok=ok)
                if not ok:
                    raise AssertionError(f"K2 disagrees with its plain "
                                         f"version at n={n} d={d} {dtype}")
                if n == LIN_N and dtype == main_dt:
                    results["max_abs_err"] = max(
                        results.get("max_abs_err", 0.0), err)
            results.update(_k2_times(x, y, w, coef, inv_std, n, d, s32,
                                     main_dt))
            del x
        del x32
        torch.cuda.empty_cache()
    return results


def _k2_times(x, y, w, coef, inv_std, n, d, x_scale, main_dt):
    from cycloneml_tpu_torch.ops import kernels
    beta, off, ys = inv_std * coef, 0.1, 0.4
    sq = kernels.SQUARED
    k_ms = _time_ms(lambda: kernels.glm_sweep(x, y, w, beta, off, link=sq,
                                              ys=ys, x_scale=x_scale), 20, 3)
    p_ms = _time_ms(lambda: kernels.glm_sweep_plain(
        x, y, w, beta, off, link=sq, ys=ys, x_scale=x_scale), 3, 1)
    yard_ms = _gemv_yardstick(x, beta, lambda m: w * (m + off - ys * y))
    n_bytes = n * d * x.element_size() + 2 * n * 4 + d * 4 + (d + 3) * 4
    bound, bound_by = _bound(n_bytes, 4.0 * n * d)
    dt = _dt(x)
    plan = kernels.glm_sweep_plan(x.dtype, sq, d)
    _line("k2_time", n=n, d=d, dtype=dt, kernel_ms=k_ms, plain_ms=p_ms,
          bound_ms=bound, bound_by=bound_by, yardstick_two_gemv_ms=yard_ms,
          achieved_gb_s=n_bytes / k_ms / 1e6, **plan)
    if n == LIN_N and x.dtype == main_dt:
        return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                "bound_by": bound_by, "yardstick_ms": yard_ms, "plan": plan}
    return {}


def phase_linreg():
    """LinearRegression at configuration 2 through K2 and through the
    plain aggregator; returns K2's launches in the K2 fit and that fit's
    final objective."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.random import generate_regression
    from cycloneml_tpu_torch.ml.regression import LinearRegression
    from cycloneml_tpu_torch.ops import kernels

    ctx = _context("chip_smoke_linreg")
    try:
        ds, gen_s = _timed(lambda: generate_regression(
            ctx, LIN_N, LIN_D, seed=11, noise=0.1))

        def fit(mode):
            ctx.conf.set("cyclone.ml.usePallasKernels", mode)
            return _timed(lambda: LinearRegression(
                regParam=0.001, elasticNetParam=0.5, maxIter=100, tol=1e-7,
                solver="l-bfgs").fit(ds))

        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        k_model, k_warm = fit("auto")
        launches = kernels.glm_sweep.launches_by_link[kernels.SQUARED]
        others = _other_launches(kernels, "squared")
        k_again, k_steady = fit("auto")
        p_model, p_warm = fit("false")
        _, p_steady = fit("false")
        peak = torch.cuda.max_memory_allocated()
        ks, ps = k_model.summary, p_model.summary
        kc, pc = k_model.coefficients.values, p_model.coefficients.values
        obj_rel = abs(ks.objective_history[-1] - ps.objective_history[-1]) \
            / abs(ps.objective_history[-1])
        zero_diff = int(np.sum((kc == 0) != (pc == 0)))
        _line("linreg_fit", n=LIN_N, d=LIN_D, data_dtype=str(ds.x.dtype)[6:],
              generate_s=gen_s,
              kernel={"iterations": ks.total_iterations,
                      "evals": ks.total_evals,
                      "row_order_counts": ROW_ORDER_COUNTS["linreg_fit"],
                      "k2_launches": launches,
                      "warm_s": k_warm, "steady_s": k_steady,
                      "final_objective": ks.objective_history[-1],
                      "zero_coefficients": int(np.sum(kc == 0))},
              plain={"iterations": ps.total_iterations,
                     "evals": ps.total_evals, "warm_s": p_warm,
                     "steady_s": p_steady,
                     "final_objective": ps.objective_history[-1],
                     "zero_coefficients": int(np.sum(pc == 0))},
              max_abs_coef_diff=float(np.max(np.abs(kc - pc))),
              intercepts=[k_model.intercept, p_model.intercept],
              objective_rel_diff=obj_rel,
              zero_pattern_differs_at=zero_diff,
              max_memory_allocated=peak)
        _check("linreg fit", {
            "K2 launched once per loss evaluation":
                launches == ks.total_evals,
            "no other kernel launched": others == 0,
            "final objectives agree to 1e-4": obj_rel <= 1e-4,
            "coefficients agree (rtol 5e-3, atol 5e-4)": bool(np.allclose(
                kc, pc, rtol=5e-3, atol=5e-4)) and abs(
                k_model.intercept - p_model.intercept) <=
                5e-4 + 5e-3 * abs(p_model.intercept),
            "finite model": bool(np.all(np.isfinite(kc))),
            "repeat fit reproduces the model": bool(np.array_equal(
                k_again.coefficients.values, kc)),
        })
        return launches, ks.objective_history[-1]
    finally:
        ctx.stop()


# -- the fp8 rung: LogisticRegression and LinearRegression on e4m3 codes ------

def _norm_rel(a, b) -> float:
    """max|a - b| / max|b|: the reference's fp8 envelope metric."""
    import numpy as np
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-9))


def _fp8_fit_phase(tag, name, generate, estimator, link):
    """One fp8 path: data generated on the card (bf16, the rung the
    generators store under the fp8 tiers), a bf16 fit through the kernel
    for the envelope, the same rows quantized on the card
    (``InstanceDataset.quantized``), then the fp8 fit through the kernel
    (the main path: counts zeroed just before, read just after) and
    through the plain aggregator on identical codes. Returns the e4m3
    launches of the kernel fit."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.ops import kernels

    ctx = _context(name)
    ctx.conf.set("cyclone.data.dtype", "float8")
    f8 = torch.float8_e4m3fn
    try:
        ds16, gen_s = _timed(lambda: generate(ctx))

        def fit(ds, mode):
            ctx.conf.set("cyclone.ml.usePallasKernels", mode)
            return _timed(lambda: estimator().fit(ds))

        ref16, ref16_s = fit(ds16, "auto")
        ds8, quant_s = _timed(ds16.quantized)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        k_model, k_warm = fit(ds8, "auto")
        by_dtype = dict(kernels.glm_sweep.launches_by_dtype)
        by_link = dict(kernels.glm_sweep.launches_by_link)
        others = (kernels.kmeans_assign.launches + kernels.gramian.launches
                  + sum(v for k, v in by_link.items() if k != link))
        k_again, k_steady = fit(ds8, "auto")
        p_model, p_warm = fit(ds8, "false")
        _, p_steady = fit(ds8, "false")
        peak = torch.cuda.max_memory_allocated()
        ks, ps = k_model.summary, p_model.summary
        kc, pc = k_model.coefficients.values, p_model.coefficients.values
        obj_rel = abs(ks.objective_history[-1] - ps.objective_history[-1]) \
            / abs(ps.objective_history[-1])
        envelope = _norm_rel(kc, ref16.coefficients.values)
        _line(tag, n=ds8.n_rows, d=ds8.n_features,
              data_dtype=_dt(ds8.x), x_bytes=ds8.x.numel(),
              generate_s=gen_s, quantize_s=quant_s,
              kernel={"iterations": ks.total_iterations,
                      "evals": ks.total_evals,
                      "row_order_counts": ROW_ORDER_COUNTS[tag],
                      "e4m3_launches": by_dtype[f8], "warm_s": k_warm,
                      "steady_s": k_steady,
                      "final_objective": ks.objective_history[-1]},
              plain={"iterations": ps.total_iterations,
                     "evals": ps.total_evals, "warm_s": p_warm,
                     "steady_s": p_steady,
                     "final_objective": ps.objective_history[-1]},
              bf16_kernel_fit={"iterations": ref16.summary.total_iterations,
                               "seconds": ref16_s},
              max_abs_coef_diff=float(np.max(np.abs(kc - pc))),
              intercepts=[k_model.intercept, p_model.intercept],
              objective_rel_diff=obj_rel,
              coef_norm_rel_to_bf16_fit=envelope,
              fallbacks=ctx.precision_fallbacks,
              max_memory_allocated=peak)
        _check(tag, {
            "X is e4m3 codes with a float64 x_scale":
                ds8.x.dtype == f8 and ds8.x_scale is not None
                and ds8.x_scale.dtype == np.float64,
            "e4m3 instance launched once per evaluation":
                by_dtype[f8] == ks.total_evals == by_link[link],
            "no bf16 or f32 instance launched":
                by_dtype[torch.bfloat16] == by_dtype[torch.float32] == 0,
            "no other kernel launched": others == 0,
            "no fp8 fallback fired": not ctx.precision_fallbacks,
            "coefficients agree (rtol 5e-3, atol 5e-4)": bool(np.allclose(
                kc, pc, rtol=5e-3, atol=5e-4)) and abs(
                k_model.intercept - p_model.intercept) <=
                5e-4 + 5e-3 * abs(p_model.intercept),
            "final objectives agree to 1e-4": obj_rel <= 1e-4,
            "within the fp8 envelope (20%) of the bf16 fit":
                envelope < FP8_COEF_NORMREL,
            "finite model": bool(np.all(np.isfinite(kc))),
            "repeat fit reproduces the model": bool(np.array_equal(
                k_again.coefficients.values, kc)),
        })
        return by_dtype[f8]
    finally:
        ctx.stop()


def phase_fp8_fit():
    """LogisticRegression at bench.py's shape on the fp8 rung through K1's
    e4m3 instance and through the plain aggregator."""
    from cycloneml_tpu_torch.dataset.random import generate_classification
    from cycloneml_tpu_torch.ml.classification import LogisticRegression
    from cycloneml_tpu_torch.ops import kernels
    return _fp8_fit_phase(
        "fp8_fit", "chip_smoke_fp8",
        lambda ctx: generate_classification(ctx, FIT_N, FIT_D, seed=0),
        lambda: LogisticRegression(maxIter=25, regParam=0.01, tol=0.0),
        kernels.LOGISTIC)


def phase_fp8_linreg():
    """LinearRegression at configuration 2 on the fp8 rung through K2's
    e4m3 instance and through the plain aggregator."""
    from cycloneml_tpu_torch.dataset.random import generate_regression
    from cycloneml_tpu_torch.ml.regression import LinearRegression
    from cycloneml_tpu_torch.ops import kernels
    return _fp8_fit_phase(
        "fp8_linreg_fit", "chip_smoke_fp8_linreg",
        lambda ctx: generate_regression(ctx, LIN_N, LIN_D, seed=11,
                                        noise=0.1),
        lambda: LinearRegression(regParam=0.001, elasticNetParam=0.5,
                                 maxIter=100, tol=1e-7, solver="l-bfgs"),
        kernels.SQUARED)


# -- K3 and KMeans ------------------------------------------------------------

def _k3_rule(x, c, best, dist, x_scale64):
    """K3's rule against float64 (row chunks) on the same values: the
    count of rows whose argmin differs, the worst pick excess and distance
    error over max(d2, |x|^2), and the largest absolute distance error."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    n = x.shape[0]
    b64, d64 = kernels.kmeans_assign_plain(x, c, torch.float64,
                                           x_scale=x_scale64)
    c64 = c.double()
    differ = worst_pick = worst_dist = max_err = 0.0
    for lo in range(0, n, ROWS):
        xc = x[lo:lo + ROWS].double()
        if x_scale64 is not None:
            xc = xc * x_scale64
        bc, tc = best[lo:lo + ROWS].long(), d64[lo:lo + ROWS]
        scale = torch.maximum(tc, (xc * xc).sum(1))
        picked = ((xc - c64[bc]) ** 2).sum(1)
        differ += int((bc != b64[lo:lo + ROWS]).sum())
        worst_pick = max(worst_pick, float(((picked - tc) / scale).max()))
        e = (dist[lo:lo + ROWS].double() - tc).abs()
        worst_dist = max(worst_dist, float((e / scale).max()))
        max_err = max(max_err, float(e.max()))
    return int(differ), worst_pick, worst_dist, max_err


def phase_k3(fp8=False):
    """K3 against its plain version in float64 (on float32 and bf16 X, or
    with ``fp8`` on e4m3 codes with their x_scale, held on the dequantized
    values), and on bf16 X at the main shape against centers in near-tie
    pairs; returns the main-shape numbers for the kernels line."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    results = {}
    main_dt = _main_dtype(fp8)
    for n, d, k, seed in ((KM_N, KM_D, KM_K, 5), (*KM_RAGGED, 6)):
        g = torch.Generator(device=DEVICE).manual_seed(seed)
        x32 = _randn(n, d, g)
        c = torch.randn(k, d, generator=g, device=DEVICE)
        for x, s32, s64 in _x_forms(x32, fp8):
            dtype = x.dtype
            instance = kernels.INSTANCE[dtype]
            before = kernels.kmeans_assign.launches_by_instance[instance]
            best, dist = kernels.kmeans_assign(x, c, x_scale=s32)
            best2, dist2 = kernels.kmeans_assign(x, c, x_scale=s32)
            torch.cuda.synchronize()
            launched = kernels.kmeans_assign.launches_by_instance[
                instance] - before == 2
            bitwise = torch.equal(best, best2) and torch.equal(dist, dist2)
            differ, worst_pick, worst_dist, max_err = _k3_rule(
                x, c, best, dist, s64)
            ok = (worst_pick <= 1e-5 and worst_dist <= 1e-4 and bitwise
                  and launched
                  and int(best.max()) < k and int(best.min()) >= 0)
            _line("k3_check", n=n, d=d, k=k, dtype=_dt(x),
                  x_scale=s32 is not None, instance=instance,
                  argmin_differs_at=differ,
                  worst_pick_excess_rel=worst_pick,
                  worst_dist_err_rel=worst_dist, max_abs_dist_err=max_err,
                  bitwise_equal=bitwise, ok=ok)
            if not ok:
                raise AssertionError(f"K3 disagrees with its plain version "
                                     f"at n={n} d={d} k={k} {dtype}")
            if n == KM_N and dtype == main_dt:
                results["max_abs_err"] = max_err
                if not fp8:
                    _k3_near_ties(x, c, g)
            results.update(_k3_times(x, c, n, d, k, s32, main_dt))
            del x
        del x32
        torch.cuda.empty_cache()
    return results


def _k3_near_ties(x, c, g):
    """K3 on the same rows against centers in pairs c and c + delta, delta
    ~ 1e-6 per feature: float32 rounding decides which of a pair wins, and
    every pick is held by the same rule (excess <= 1e-5)."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    k, d = c.shape
    half = c[:k // 2]
    pairs = torch.stack([half, half + 1e-6 * torch.randn(
        half.shape, generator=g, device=DEVICE)], 1).reshape(-1, d)
    best, dist = kernels.kmeans_assign(x, pairs)
    best2, dist2 = kernels.kmeans_assign(x, pairs)
    torch.cuda.synchronize()
    bitwise = torch.equal(best, best2) and torch.equal(dist, dist2)
    differ, worst_pick, worst_dist, _ = _k3_rule(x, pairs, best, dist, None)
    # rows whose pick is the other center of its pair than float64's
    _line("k3_near_ties", n=x.shape[0], d=d, k=pairs.shape[0],
          dtype=_dt(x), delta=1e-6, argmin_differs_at=differ,
          worst_pick_excess_rel=worst_pick, worst_dist_err_rel=worst_dist,
          bitwise_equal=bitwise)
    _check("k3 near ties", {
        "picks within 1e-5 of max(d2, |x|^2)": worst_pick <= 1e-5,
        "distances within 1e-4 of it": worst_dist <= 1e-4,
        "two launches bitwise equal": bitwise,
    })


def _k3_times(x, c, n, d, k, x_scale, main_dt):
    import torch
    from cycloneml_tpu_torch.ops import kernels
    k_ms = _time_ms(lambda: kernels.kmeans_assign(x, c, x_scale=x_scale),
                    3, 1)
    p_ms = _time_ms(lambda: kernels.kmeans_assign_plain(x, c,
                                                        x_scale=x_scale),
                    2, 1)
    ct = c.t().contiguous()

    def product():  # the distance product alone, f32 with TF32 off
        for lo in range(0, n, ROWS):
            x[lo:lo + ROWS].float() @ ct
    yard_ms = _time_ms(product, 3, 1)
    n_bytes = n * d * x.element_size() + k * d * 4 + k * 4 + n * 8
    f32_bound, _ = _bound(n_bytes, 2.0 * n * k * d)
    if kernels.INSTANCE[x.dtype] == kernels.TENSOR_CORE:
        # float32-accurate products on the tensor cores: three bf16 passes
        flops, rate, rate_name = (3 * 2.0 * n * k * d, H100_BF16_FLOPS,
                                  "bf16 tensor cores, three passes")
    else:
        flops, rate, rate_name = 2.0 * n * k * d, H100_F32_FLOPS, "f32 FMA"
    bound, bound_by = _bound(n_bytes, flops, rate)
    _line("k3_time", n=n, d=d, k=k, dtype=_dt(x), kernel_ms=k_ms,
          plain_ms=p_ms, bound_ms=bound, bound_by=bound_by,
          bound_rate=rate_name, f32_fma_bound_ms=f32_bound,
          yardstick_f32_product_ms=yard_ms,
          achieved_tflop_s=flops / k_ms / 1e9,
          share_of_bound=bound / k_ms)
    if n == KM_N and x.dtype == main_dt:
        return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                "bound_by": bound_by, "yardstick_ms": yard_ms,
                "f32_fma_bound_ms": f32_bound}
    return {}


def phase_kmeans():
    """KMeans at configuration 3 through K3 and through the plain
    assignment, twice through K3 (bitwise-equal centers), and the center
    sums of one Lloyd step timed alone; returns K3's and the center sums'
    launches in the K3 fit and the center sums' numbers."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.random import RandomDatasets
    from cycloneml_tpu_torch.ml.clustering import KMeans
    from cycloneml_tpu_torch.ops import kernels

    ctx = _context("chip_smoke_kmeans")
    try:
        ds, gen_s = _timed(lambda: RandomDatasets.normal(
            ctx, KM_N, KM_D, seed=12))

        def km(max_iter=10):
            return KMeans(k=KM_K, maxIter=max_iter, tol=1e-5, seed=3)

        def fit(mode):
            ctx.conf.set("cyclone.ml.usePallasKernels", mode)
            return _timed(lambda: km().fit(ds))

        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        k_model, k_s = fit("auto")
        launches = kernels.kmeans_assign.launches
        by_instance = dict(kernels.kmeans_assign.launches_by_instance)
        sum_launches = kernels.center_sums.launches
        others = _other_launches(kernels, "kmeans_assign", "center_sums")
        k_again, k_again_s = fit("auto")
        p_model, p_s = fit("false")
        peak = torch.cuda.max_memory_allocated()
        cost_rel = abs(k_model.training_cost - p_model.training_cost) \
            / abs(p_model.training_cost)
        centers = k_model.cluster_centers_matrix().to_array()
        repeat_equal = bool(np.array_equal(
            centers, k_again.cluster_centers_matrix().to_array())) and \
            k_model.training_cost == k_again.training_cost
        # one Lloyd step from identical initial centers
        one = km(max_iter=1)
        init, _ = one._init_centers(ds, KM_K, False)
        step_k, _, _ = one._lloyd(ds, init, True)
        step_p, _, _ = one._lloyd(ds, init, False)
        step_diff = float(np.max(np.abs(step_k - step_p)))
        step_scale = float(np.max(np.abs(step_p)))
        _line("kmeans_fit", n=KM_N, d=KM_D, k=KM_K,
              data_dtype=str(ds.x.dtype)[6:], generate_s=gen_s,
              kernel={"iterations": k_model.num_iterations,
                      "init_passes": k_model.init_distance_passes,
                      "k3_launches": launches,
                      "k3_launches_by_instance": by_instance,
                      "center_sums_launches": sum_launches, "fit_s": k_s,
                      "repeat_fit_s": k_again_s,
                      "training_cost": k_model.training_cost},
              plain={"iterations": p_model.num_iterations,
                     "init_passes": p_model.init_distance_passes,
                     "fit_s": p_s, "training_cost": p_model.training_cost},
              cost_rel_diff=cost_rel, one_step_max_center_diff=step_diff,
              one_step_max_center=step_scale,
              repeat_fit_bitwise_equal=repeat_equal,
              max_memory_allocated=peak)
        _check("kmeans fit", {
            "K3 launched once per Lloyd step and k-means|| pass":
                launches == k_model.num_iterations
                + k_model.init_distance_passes,
            "center sums launched once per Lloyd step (no attraction pass "
            "at this size)": sum_launches == k_model.num_iterations,
            "no other kernel launched": others == 0,
            "bf16 X launched only the tensor-core instance":
                by_instance[kernels.TENSOR_CORE] == launches
                and kernels.INSTANCE[ds.x.dtype] == kernels.TENSOR_CORE,
            "training costs agree to 1e-4": cost_rel <= 1e-4,
            "one Lloyd step agrees (1e-4 of max|center|)":
                step_diff <= 1e-4 * step_scale,
            "two K3 fits give bitwise-equal centers and costs": repeat_equal,
            "finite centers": bool(np.all(np.isfinite(centers))),
        })
        return launches, sum_launches, _center_sums_phase(ds, centers)
    finally:
        ctx.stop()


def _index_add_center_sums(x, w, best, k):
    """The center update before PR 6 (``index_add_`` over 2^18-row
    chunks, float atomics on CUDA): the library call the kernel is timed
    against."""
    import torch
    sums = torch.zeros((k, x.shape[1]), dtype=w.dtype, device=x.device)
    for lo in range(0, x.shape[0], 1 << 18):
        sums.index_add_(0, best[lo:lo + (1 << 18)],
                        x[lo:lo + (1 << 18)].to(w.dtype)
                        * w[lo:lo + (1 << 18), None])
    counts = torch.zeros(k, dtype=w.dtype, device=x.device).index_add_(
        0, best, w)
    return sums, counts


def _center_sums_phase(ds, centers):
    """The center sums of one Lloyd step at configuration 3, on the
    assignment to the fit's final centers: the kernel against float64
    index_add_ sums, two calls bitwise equal, and its time per Lloyd step
    beside the index_add_ update it replaced and the bound."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    x, w = ds.x, ds.w
    n, d = x.shape
    c = torch.as_tensor(centers, dtype=torch.float32, device=x.device)
    best, _ = kernels.kmeans_assign(x, c)
    sums, counts = kernels.center_sums(x, w, best, KM_K)
    sums2, counts2 = kernels.center_sums(x, w, best, KM_K)
    torch.cuda.synchronize()
    bitwise = torch.equal(sums, sums2) and torch.equal(counts, counts2)
    t_sums, t_counts = kernels.center_sums_plain(x, w, best.long(), KM_K,
                                                 torch.float64)
    err = float((sums.double() - t_sums).abs().max())
    scale = float(t_sums.abs().max())
    counts_exact = torch.equal(counts.double(), t_counts)
    old_a, _ = _index_add_center_sums(x, w, best.long(), KM_K)
    old_b, _ = _index_add_center_sums(x, w, best.long(), KM_K)
    old_bitwise = torch.equal(old_a, old_b)
    del t_sums, old_a, old_b
    k_ms = _time_ms(lambda: kernels.center_sums(x, w, best, KM_K), 5, 1)
    lib_ms = _time_ms(lambda: _index_add_center_sums(x, w, best.long(),
                                                     KM_K), 5, 1)
    p_ms = _time_ms(lambda: kernels.center_sums_plain(x, w, best.long(),
                                                      KM_K), 3, 1)
    n_bytes = n * d * x.element_size() + n * 4 + n * 4 + KM_K * (d + 1) * 4
    bound, bound_by = _bound(n_bytes, float(n) * (d + 1))
    # scratch beyond the inputs: the sort's order and the pieces' partials
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.center_sums(x, w, best, KM_K)
    torch.cuda.synchronize()
    work_mib = (torch.cuda.max_memory_allocated() - held) / 2**20
    _line("center_sums", n=n, d=d, k=KM_K, dtype=_dt(x),
          max_abs_err=err, max_abs_sum=scale, counts_exact=counts_exact,
          bitwise_equal=bitwise, index_add_bitwise_equal=old_bitwise,
          kernel_ms_per_lloyd_step=k_ms,
          index_add_ms_per_lloyd_step=lib_ms, plain_ms=p_ms,
          bound_ms=bound, bound_by=bound_by, working_mem_mib=work_mib,
          x_mib=n * d * x.element_size() / 2**20)
    _check("center sums", {
        "within 1e-6 of max|sum| of the float64 sums": err <= 1e-6 * scale,
        "counts exact": counts_exact,
        "two calls bitwise equal": bitwise,
        "scratch below one copy of X": work_mib * 2**20
        < n * d * x.element_size(),
    })
    return {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms}


# -- K4 and PCA ---------------------------------------------------------------

def phase_k4(fp8=False):
    """K4 against its plain version in float64 (on float32 and bf16 X, or
    with ``fp8`` on e4m3 codes with their x_scale, held on the dequantized
    values); returns the main-shape numbers for the kernels line."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    results = {}
    main_dt = _main_dtype(fp8)
    for n, d, masked, seed in ((GRAM_N, GRAM_D, False, 7),
                               (*GRAM_RAGGED, True, 8)):
        g = torch.Generator(device=DEVICE).manual_seed(seed)
        x32 = _randn(n, d, g)
        w = ((torch.arange(n, device=DEVICE) % 3 != 2).float() if masked
             else torch.ones(n, device=DEVICE))
        for x, s32, s64 in _x_forms(x32, fp8):
            dtype = x.dtype
            instance = kernels.INSTANCE[dtype]
            before = kernels.gramian.launches_by_instance[instance]
            got = kernels.gramian(x, w, x_scale=s32)
            again = kernels.gramian(x, w, x_scale=s32)
            torch.cuda.synchronize()
            launched = kernels.gramian.launches_by_instance[
                instance] - before == 2
            truth = kernels.gramian_plain(x, w, torch.float64, x_scale=s64)
            diag = truth.diagonal().clamp(min=0)
            scale = torch.sqrt(torch.outer(diag, diag))
            err = (got.double() - truth).abs()
            worst = float((err / scale.clamp(min=1e-300)).max())
            plain = kernels.gramian_plain(x, w, x_scale=s32).double()
            plain_worst = float(((plain - truth).abs()
                                 / scale.clamp(min=1e-300)).max())
            # the trace's relative error: a bias on the diagonal shows here
            tr = float(truth.diagonal().sum())
            trace_rel = [float(got.diagonal().double().sum()) / tr - 1,
                         float(plain.diagonal().sum()) / tr - 1]
            del plain
            bitwise = torch.equal(got, again)
            symmetric = torch.equal(got, got.T)
            ok = worst <= 1e-4 and bitwise and symmetric and launched
            _line("k4_check", n=n, d=d, masked=masked, dtype=_dt(x),
                  x_scale=s32 is not None, instance=instance,
                  worst_err_over_sqrt_gii_gjj=worst,
                  plain_f32_worst_err_over_sqrt_gii_gjj=plain_worst,
                  trace_rel_err_kernel_plain=trace_rel,
                  max_abs_err=float(err.max()), bitwise_equal=bitwise,
                  symmetric=symmetric, ok=ok)
            if not ok:
                raise AssertionError(f"K4 disagrees with its plain version "
                                     f"at n={n} d={d} {dtype}")
            if n == GRAM_N and dtype == main_dt:
                results["max_abs_err"] = float(err.max())
            if s32 is not None:
                # the library call's input: the dequantized values in f32
                for lo in range(0, n, ROWS):
                    x32[lo:lo + ROWS] = x[lo:lo + ROWS].float() * s32
            results.update(_k4_times(x, x32, w, n, d, s32, main_dt))
            del x, truth
        del x32
        torch.cuda.empty_cache()
    return results


# bf16 and e4m3 products are exact in f32: the tensor cores' rate for their
# type bounds them; f32 products need the f32 FMA rate
_K4_PEAK = {"bfloat16": H100_BF16_FLOPS, "float8_e4m3fn": H100_FP8_FLOPS}


def _k4_times(x, x32, w, n, d, x_scale, main_dt):
    import torch
    from cycloneml_tpu_torch.ops import kernels
    k_ms = _time_ms(lambda: kernels.gramian(x, w, x_scale=x_scale), 3, 1)
    # the memory one call takes beyond its inputs: the partials' scratch
    # and G
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.gramian(x, w, x_scale=x_scale)
    torch.cuda.synchronize()
    work_mib = (torch.cuda.max_memory_allocated() - held) / 2**20
    extra = {}
    if x.dtype == torch.float8_e4m3fn and d % 16 == 0 and \
            x.data_ptr() % 16 == 0:
        # the same codes at a base 8 bytes off 16: the kernel stages them
        # through registers (its ragged path) instead of its cp.async ring
        flat = torch.empty(n * d + 8, dtype=x.dtype, device=x.device)
        xo = flat[8:].view(n, d)
        xo.copy_(x)
        extra["register_staged_ms"] = _time_ms(
            lambda: kernels.gramian(xo, w, x_scale=x_scale), 3, 1)
        extra["register_staged_bitwise_equal"] = torch.equal(
            kernels.gramian(xo, w, x_scale=x_scale),
            kernels.gramian(x, w, x_scale=x_scale))
        del flat, xo
    p_ms = _time_ms(lambda: kernels.gramian_plain(x, w, x_scale=x_scale),
                    3, 1)
    # the library call on the same values in f32 (TF32 off), unmasked
    lib_ms = _time_ms(lambda: x32.T @ x32, 3, 1)
    # a rate reference, not the same function (its output is bf16):
    # cuBLAS's bf16 x^T x on the same values rounded to bf16
    xb = x if x.dtype == torch.bfloat16 else x32.to(torch.bfloat16)
    rate_ms = _time_ms(lambda: xb.T @ xb, 3, 1)
    del xb
    n_bytes = n * d * x.element_size() + n * 4 + d * d * 4
    dt = _dt(x)
    flops = float(n) * d * (d + 1)
    peak = _K4_PEAK.get(dt, H100_F32_FLOPS)
    bound, bound_by = _bound(n_bytes, flops, peak)
    f32_bound, _ = _bound(n_bytes, flops)
    _line("k4_time", n=n, d=d, dtype=dt, kernel_ms=k_ms, plain_ms=p_ms,
          bound_ms=bound, bound_by=bound_by,
          bound_rate={H100_BF16_FLOPS: "bf16 tensor cores",
                      H100_FP8_FLOPS: "fp8 tensor cores"}.get(peak,
                                                              "f32 FMA"),
          f32_fma_bound_ms=f32_bound, library_f32_xtx_ms=lib_ms,
          library_bf16_rate_ms=rate_ms, working_mem_mib=work_mib, **extra,
          achieved_tflop_s=flops / k_ms / 1e9, share_of_bound=bound / k_ms)
    if n == GRAM_N and x.dtype == main_dt:
        return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                "bound_by": bound_by, "library_ms": lib_ms,
                "f32_fma_bound_ms": f32_bound,
                "library_bf16_rate_ms": rate_ms}
    return {}


def _spectrum_dataset(ctx, n, d, seed):
    """X = (Z diag(s)) Q^T with s_j = (j+1)^-1/2 and Q orthogonal from a
    float64 QR, generated on the card in the data tier; returns the
    dataset and Q."""
    import torch
    from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
    from cycloneml_tpu_torch.dataset.instance import compute_dtype, data_dtype
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    q, _ = torch.linalg.qr(torch.randn((d, d), generator=g, device=DEVICE,
                                       dtype=torch.float64))
    s = (torch.arange(d, device=DEVICE, dtype=torch.float64) + 1) ** -0.5
    m = (s[:, None] * q.T).float()  # diag(s) Q^T
    x = torch.empty((n, d), dtype=data_dtype(ctx.conf), device=DEVICE)
    for lo in range(0, n, ROWS):
        z = torch.randn((min(ROWS, n - lo), d), generator=g, device=DEVICE)
        x[lo:lo + ROWS] = (z @ m).to(x.dtype)
    cdt = compute_dtype(ctx.conf)
    ds = InstanceDataset(ctx, x, torch.zeros(n, dtype=cdt, device=DEVICE),
                         torch.ones(n, dtype=cdt, device=DEVICE), n, d)
    return ds, q.cpu().numpy()


def phase_pca():
    """PCA(k=10) and compute_svd(k=10) on spectrum data through K4 and
    through the plain Gramian; returns K4's launches in the K4 run."""
    import numpy as np
    from cycloneml_tpu_torch.linalg.distributed import RowMatrix
    from cycloneml_tpu_torch.ml.feature import PCA
    from cycloneml_tpu_torch.ops import kernels

    ctx = _context("chip_smoke_pca")
    try:
        (ds, q), gen_s = _timed(lambda: _spectrum_dataset(
            ctx, GRAM_N, GRAM_D, seed=9))

        def run(mode):
            ctx.conf.set("cyclone.ml.usePallasKernels", mode)
            pca, pca_s = _timed(lambda: PCA(k=10).fit(ds))
            svd, svd_s = _timed(lambda: RowMatrix(ds).compute_svd(10))
            return pca, svd, pca_s, svd_s

        kernels.reset_launch_counts()
        k_pca, k_svd, k_pca_s, k_svd_s = run("auto")
        launches = kernels.gramian.launches
        tc_launches = kernels.gramian.launches_by_instance[
            kernels.TENSOR_CORE]
        others = _other_launches(kernels, "gramian")
        p_pca, p_svd, p_pca_s, p_svd_s = run("false")

        def min_cos(a, b):
            return float(np.min(np.abs(np.sum(a * b, axis=0))))

        pca_cos = min_cos(k_pca.pc, p_pca.pc)
        svd_cos = min_cos(k_svd.V.to_array(), p_svd.V.to_array())
        ev_rel = float(np.max(np.abs(k_pca.explained_variance
                                     - p_pca.explained_variance)
                              / p_pca.explained_variance))
        ks, ps = k_svd.s.to_array(), p_svd.s.to_array()
        s_rel = float(np.max(np.abs(ks - ps) / ps))
        truth_cos = [min_cos(k_pca.pc, q[:, :10]), min_cos(p_pca.pc,
                                                           q[:, :10])]
        _line("pca", n=GRAM_N, d=GRAM_D, data_dtype=str(ds.x.dtype)[6:],
              generate_s=gen_s, k4_launches=launches,
              kernel={"pca_s": k_pca_s, "svd_s": k_svd_s,
                      "explained_variance": k_pca.explained_variance.tolist(),
                      "singular_values": ks.tolist()},
              plain={"pca_s": p_pca_s, "svd_s": p_svd_s},
              min_abs_cos_pc=pca_cos, min_abs_cos_v=svd_cos,
              explained_variance_rel_diff=ev_rel,
              singular_value_rel_diff=s_rel,
              min_abs_cos_to_q=truth_cos)
        _check("pca", {
            "K4 launched once per Gramian": launches == 2,
            "bf16 X launched only the tensor-core instance":
                tc_launches == launches,
            "no other kernel launched": others == 0,
            "principal components agree (|cos| >= 1 - 1e-6)":
                pca_cos >= 1 - 1e-6,
            "right singular vectors agree (|cos| >= 1 - 1e-6)":
                svd_cos >= 1 - 1e-6,
            "explained variance agrees to 1e-5": ev_rel <= 1e-5,
            "singular values agree to 1e-5": s_rel <= 1e-5,
            "both find the spectrum's top components (|cos| >= 0.99)":
                min(truth_cos) >= 0.99,
        })
        return launches
    finally:
        ctx.stop()


# -- K1s and the stacked fits (OneVsRest, CrossValidator) ---------------------

def _k1s_inputs(n, d, seed, masked):
    """X (f32), labels for max(K1S_MODELS) models (y_k = 1[x.beta_k +
    eps > 0]), w (a third of the rows at 0 when ``masked``), coefficients
    and standardization vectors, on the card."""
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    k = max(K1S_MODELS)
    x = _randn(n, d, g)
    truth = torch.randn(d, k, generator=g, device=DEVICE) / d ** 0.5
    y = torch.empty((n, k), device=DEVICE)
    for lo in range(0, n, ROWS):
        m = x[lo:lo + ROWS] @ truth
        y[lo:lo + ROWS] = (m + torch.randn(m.shape, generator=g,
                                           device=DEVICE) > 0).float()
    w = ((torch.arange(n, device=DEVICE) % 3 != 2).float() if masked
         else torch.ones(n, device=DEVICE))
    coef = torch.randn(k, d + 1, generator=g, device=DEVICE) / d ** 0.5
    inv_std = torch.rand(d, generator=g, device=DEVICE) + 0.5
    mu = torch.randn(d, generator=g, device=DEVICE) * 0.5
    return x, y, w, coef, inv_std, mu


def _label_dtype(x):
    """The labels' dtype beside X: the data tier, bf16 under fp8."""
    import torch
    return torch.float32 if x.dtype == torch.float32 else torch.bfloat16


def _fold_truth_stacked(x, y, w, inv_std, mu, coef, d, x_scale=None):
    """The scaled stacked sweep in float64 through the plain version."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    c = coef.double()
    b = c[:, :d] * inv_std.double()
    off = c[:, d] - c[:, :d] @ mu.double()
    loss, g, msum, wsum = kernels.glm_sweep_stacked_plain(
        x, y, w, b, off, acc_dtype=torch.float64, x_scale=x_scale)
    grad = torch.cat([g * inv_std.double() - mu.double()[None] * msum[:, None],
                      msum[:, None]], dim=1)
    return loss, grad, wsum


def _k1s_errors(got, t_loss, t_grad):
    """Worst relative loss error and worst grad error over max|grad|,
    across the models."""
    rel_loss = float(((got["loss"].double() - t_loss).abs()
                      / t_loss.abs()).max())
    err = (got["grad"].double() - t_grad).abs().max(dim=1).values
    gmax = t_grad.abs().max(dim=1).values
    return rel_loss, float((err / gmax).max()), float(err.max())


def phase_k1s(fp8=False):
    """K1s against its plain version in float64 (float32 and bf16 X, or
    with ``fp8`` e4m3 codes with their x_scale) at every K of K1S_MODELS,
    with and without centering, at the fit shape and at the ragged shape
    with a third of the rows at w=0; K=1 against K1; returns the
    main-shape numbers at K=OVR_K for the kernels line."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    results = {}
    main_dt = _main_dtype(fp8)
    for n, d, seed, masked in ((FIT_N, FIT_D, 13, False),
                               (RAGGED_N, RAGGED_D, 14, True)):
        x32, y32, w, coef, inv_std, mu = _k1s_inputs(n, d, seed, masked)
        n_w = float(w.sum())
        for x, s32, s64 in _x_forms(x32, fp8):
            dtype = x.dtype
            ys = y32.to(_label_dtype(x))
            instance = kernels.INSTANCE[dtype]
            for k in K1S_MODELS:
                yk = ys[:, :k]
                groups = -(-k // kernels.glm_sweep_stacked_group(dtype, d))
                for centered in (False, True):
                    m = mu if centered else torch.zeros_like(mu)
                    before = kernels.glm_sweep_stacked.launches_by_dtype[
                        dtype]
                    before_i = dict(
                        kernels.glm_sweep_stacked.launches_by_instance)
                    got = kernels.fused_binary_logistic_stacked_scaled(
                        x, yk, w, inv_std, m, coef[:k], d, x_scale=s32)
                    again = kernels.fused_binary_logistic_stacked_scaled(
                        x, yk, w, inv_std, m, coef[:k], d, x_scale=s32)
                    torch.cuda.synchronize()
                    after_i = kernels.glm_sweep_stacked.launches_by_instance
                    launched = (kernels.glm_sweep_stacked.launches_by_dtype[
                        dtype] - before == 2 * groups
                        and after_i[instance] - before_i[instance]
                        == 2 * groups
                        and sum(after_i.values()) - sum(before_i.values())
                        == 2 * groups)
                    t_loss, t_grad, t_w = _fold_truth_stacked(
                        x, yk, w, inv_std, m, coef[:k], d, s64)
                    rel_loss, rel_grad, err = _k1s_errors(got, t_loss,
                                                          t_grad)
                    bitwise = all(torch.equal(got[q], again[q])
                                  for q in ("loss", "grad", "count"))
                    counts = bool((got["count"] == n_w).all())
                    vs_k1 = None
                    if k == 1:
                        # K=1: K1s against K1 under the same bounds
                        one = kernels.fused_binary_logistic_scaled(
                            x, yk[:, 0], w, inv_std, m, coef[0], d,
                            x_scale=s32)
                        torch.cuda.synchronize()
                        vs_k1 = _k1s_errors(
                            got, one["loss"].double().reshape(1),
                            one["grad"].double().reshape(1, -1))[:2]
                    ok = (rel_loss <= 1e-5 and rel_grad <= 1e-4 and counts
                          and float(t_w) == n_w and bitwise and launched
                          and (vs_k1 is None or (vs_k1[0] <= 1e-5
                                                 and vs_k1[1] <= 1e-4)))
                    _line("k1s_check", n=n, d=d, k=k, dtype=_dt(x),
                          instance=instance,
                          label_dtype=_dt(yk), x_scale=s32 is not None,
                          centered=centered, masked_rows=n - int(n_w),
                          rel_loss=rel_loss, grad_err_over_max=rel_grad,
                          max_abs_grad_err=err, count=float(got["count"][0]),
                          launches=2 * groups, bitwise_equal=bitwise,
                          vs_k1=vs_k1, ok=ok)
                    if not ok:
                        raise AssertionError(
                            f"K1s disagrees with its plain version at n={n} "
                            f"d={d} k={k} {dtype}")
                    if n == FIT_N and dtype == main_dt and k == OVR_K:
                        results["max_abs_err"] = max(
                            results.get("max_abs_err", 0.0), err)
                if n == FIT_N:
                    results.update(_k1s_times(x, x32, yk, w, coef[:k],
                                              inv_std, d, n, s32, main_dt))
            del x, ys
        del x32, y32
        torch.cuda.empty_cache()
    return results


def _k1s_times(x, x32, y, w, coef, inv_std, d, n, x_scale, main_dt):
    """K1s's time at K = y.shape[1] beside its plain version, the bound,
    and two yardsticks the port never calls: K serial launches of K1, and
    the two products of the sweep as cuBLAS f32 GEMMs (TF32 off)."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    k = y.shape[1]
    b = coef[:, :d] * inv_std
    off = coef[:, d]
    reps = 10 if k <= 8 else 5
    k_ms = _time_ms(lambda: kernels.glm_sweep_stacked(
        x, y, w, b, off, x_scale=x_scale), reps, 2)
    p_ms = _time_ms(lambda: kernels.glm_sweep_stacked_plain(
        x, y, w, b, off, x_scale=x_scale), 2, 1)
    cols = [y[:, j].float().contiguous() for j in range(k)]

    def serial():
        for j in range(k):
            kernels.glm_sweep(x, cols[j], w, b[j], off[j], x_scale=x_scale)
    serial_ms = _time_ms(serial, 3, 1)
    yf = y.float()
    bt = b.t().contiguous()

    def gemms():  # X.B^T, then M^T.X, on the values in f32
        m = x32 @ bt + off
        mult = w[:, None] * (torch.sigmoid(m) - yf)
        return mult.t() @ x32
    gemm_ms = _time_ms(gemms, 3, 1)
    del cols, yf
    n_bytes = (n * d * x.element_size() + n * k * y.element_size() + n * 4
               + k * (d + 1) * 4 + (k * (d + 2) + 1) * 4)
    # the f32-FMA figure: 4 n d K flops at the FMA rate; the tensor-core
    # instance's: B and the multipliers in three bf16 parts, 12 n d K flops
    # at the bf16 tensor-core rate
    fma_bound, fma_by = _bound(n_bytes, 4.0 * n * d * k)
    tc_bound, tc_by = _bound(n_bytes, 12.0 * n * d * k, H100_BF16_FLOPS)
    instance = kernels.INSTANCE[x.dtype]
    if instance == kernels.TENSOR_CORE:
        bound, bound_by, flops = tc_bound, tc_by, 12.0 * n * d * k
    else:
        bound, bound_by, flops = fma_bound, fma_by, 4.0 * n * d * k
    _line("k1s_time", n=n, d=d, k=k, dtype=_dt(x), instance=instance,
          kernel_ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=bound_by,
          tensor_core_bound_ms=tc_bound, tensor_core_bound_by=tc_by,
          f32_fma_bound_ms=fma_bound, f32_fma_bound_by=fma_by,
          yardstick_serial_k1_ms=serial_ms,
          yardstick_two_f32_gemm_ms=gemm_ms,
          achieved_gb_s=n_bytes / k_ms / 1e6,
          achieved_tflop_s=flops / k_ms / 1e9,
          share_of_bound=bound / k_ms)
    if x.dtype == main_dt and k == OVR_K:
        return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                "bound_by": bound_by, "yardstick_ms": serial_ms,
                "yardstick_two_f32_gemm_ms": gemm_ms,
                "f32_fma_bound_ms": fma_bound, "instance": instance}
    return {}


def _ovr_margins(ds, models):
    """The OvR margins' argmax over the real rows, on the card."""
    import numpy as np
    return _argmax_margins(
        ds, np.stack([m.coefficients.values for m in models]),
        [m.intercept for m in models])


def _argmax_margins(ds, coef_matrix, intercepts):
    """argmax over classes of x.W^T + b for the real rows, on the card."""
    import torch
    w_mat = torch.as_tensor(coef_matrix, dtype=torch.float32,
                            device=ds.x.device).t().contiguous()
    b = torch.as_tensor(intercepts, dtype=torch.float32, device=ds.x.device)
    scale = None if ds.x_scale is None else torch.as_tensor(
        ds.x_scale, dtype=torch.float32, device=ds.x.device)
    out = torch.empty(ds.n_rows, dtype=torch.int64, device=ds.x.device)
    for lo in range(0, ds.n_rows, ROWS):
        hi = min(lo + ROWS, ds.n_rows)
        xc = ds.x[lo:hi].float()
        if scale is not None:
            xc = xc * scale
        out[lo:hi] = (xc @ w_mat + b).argmax(1)
    return out


def _ovr_summary(model):
    return {"iterations": [m.summary.total_iterations for m in model.models],
            "evals": [m.summary.total_evals for m in model.models],
            "stacked_evals": model.models[0].summary.stacked_evals,
            "final_objectives": [m.summary.objective_history[-1]
                                 for m in model.models]}


def _same_models(a, b):
    """Coefficients within the kernel-vs-plain bound (rtol 5e-3, atol
    5e-4), and the worst relative difference of the final objectives."""
    import numpy as np
    coef_ok, obj = True, 0.0
    for ma, mb in zip(a.models, b.models):
        coef_ok &= bool(np.allclose(ma.coefficients.values,
                                    mb.coefficients.values, rtol=5e-3,
                                    atol=5e-4)) and abs(
            ma.intercept - mb.intercept) <= 5e-4 + 5e-3 * abs(mb.intercept)
        fa, fb = (m.summary.objective_history[-1] for m in (ma, mb))
        obj = max(obj, abs(fa - fb) / abs(fb))
    return coef_ok, obj


def phase_ovr():
    """OneVsRest at full width: K=OVR_K classes at 2,000,000 x 1280 (bf16
    tier; bench_ovr_stacked's recipe on the card), LogisticRegression(
    maxIter=25, regParam=0.01, tol=0), parallelism=OVR_K through K1s
    (warm and steady), through the plain stacked aggregator, and serially
    (parallelism=1, OVR_K fits through K1); then the same rows quantized
    on the card, stacked through K1s's e4m3 instance. Returns K1s's bf16
    and e4m3 launches in their stacked fits, and the K1s fit's models."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.random import generate_multiclass
    from cycloneml_tpu_torch.ml.classification import (LogisticRegression,
                                                       OneVsRest)
    from cycloneml_tpu_torch.ops import kernels

    ctx = _context("chip_smoke_ovr")
    try:
        ds, gen_s = _timed(lambda: generate_multiclass(
            ctx, FIT_N, FIT_D, OVR_K, seed=7))
        labels = torch.as_tensor(ds.y_host()[:ds.n_rows],
                                 device=ds.x.device).long()

        def fit(mode, par, data=ds):
            ctx.conf.set("cyclone.ml.usePallasKernels", mode)
            clf = LogisticRegression(maxIter=25, regParam=0.01, tol=0.0)
            return _timed(lambda: OneVsRest(classifier=clf,
                                            parallelism=par).fit(data))

        torch.cuda.reset_peak_memory_stats()
        # the main path: counts zeroed just before, read just after
        kernels.reset_launch_counts()
        k_model, k_warm = fit("auto", OVR_K)
        k1s = dict(kernels.glm_sweep_stacked.launches_by_dtype)
        k1s_tc = kernels.glm_sweep_stacked.launches_by_instance[
            kernels.TENSOR_CORE]
        k1 = kernels.glm_sweep.launches
        others = _other_launches(kernels, "glm_stacked")
        k_again, k_steady = fit("auto", OVR_K)
        p_model, p_s = fit("false", OVR_K)
        kernels.reset_launch_counts()
        s_model, s_s = fit("auto", 1)
        serial_k1 = kernels.glm_sweep.launches
        serial_k1s = kernels.glm_sweep_stacked.launches
        peak = torch.cuda.max_memory_allocated()
        pred_k = _ovr_margins(ds, k_model.models)
        agree_s = float((pred_k == _ovr_margins(ds, s_model.models))
                        .double().mean())
        agree_p = float((pred_k == _ovr_margins(ds, p_model.models))
                        .double().mean())
        acc = float((pred_k == labels).double().mean())
        coef_p, obj_p = _same_models(k_model, p_model)
        coef_s, obj_s = _same_models(k_model, s_model)
        stacked_evals = k_model.models[0].summary.stacked_evals
        groups = -(-OVR_K // kernels.glm_sweep_stacked_group(ds.x.dtype,
                                                             FIT_D))
        serial_evals = sum(m.summary.total_evals for m in s_model.models)
        finite = all(np.all(np.isfinite(m.coefficients.values))
                     for m in k_model.models)
        repeat = all(np.array_equal(a.coefficients.values,
                                    b.coefficients.values)
                     for a, b in zip(k_model.models, k_again.models))

        # the fp8 rung: the same rows as e4m3 codes, stacked through K1s
        ctx.conf.set("cyclone.data.dtype", "float8")
        ds8, quant_s = _timed(ds.quantized)
        kernels.reset_launch_counts()
        f_model, f_s = fit("auto", OVR_K, ds8)
        k1s8 = dict(kernels.glm_sweep_stacked.launches_by_dtype)
        k1s8_tc = kernels.glm_sweep_stacked.launches_by_instance[
            kernels.TENSOR_CORE]
        others8 = _other_launches(kernels, "glm_stacked")
        groups8 = -(-OVR_K // kernels.glm_sweep_stacked_group(ds8.x.dtype,
                                                              FIT_D))
        f_evals = f_model.models[0].summary.stacked_evals
        agree_f = float((pred_k == _ovr_margins(ds8, f_model.models))
                        .double().mean())
        envelope = max(_norm_rel(a.coefficients.values, b.coefficients.values)
                       for a, b in zip(f_model.models, k_model.models))
        _line("ovr_fit", n=FIT_N, d=FIT_D, classes=OVR_K,
              data_dtype=_dt(ds.x), generate_s=gen_s,
              stacked_k1s={**_ovr_summary(k_model), "k1s_launches": k1s[
                  ds.x.dtype], "k1_launches": k1, "warm_s": k_warm,
                  "steady_s": k_steady},
              stacked_plain={**_ovr_summary(p_model), "fit_s": p_s},
              serial_k1={**_ovr_summary(s_model), "k1_launches": serial_k1,
                         "k1s_launches": serial_k1s, "fit_s": s_s},
              fp8_stacked_k1s={**_ovr_summary(f_model),
                               "e4m3_launches": k1s8[torch.float8_e4m3fn],
                               "quantize_s": quant_s, "fit_s": f_s,
                               "coef_norm_rel_to_bf16": envelope,
                               "prediction_agreement": agree_f,
                               "fallbacks": ctx.precision_fallbacks},
              objective_rel_diff={"plain": obj_p, "serial": obj_s},
              prediction_agreement={"plain": agree_p, "serial": agree_s},
              train_accuracy=acc, max_memory_allocated=peak)
        _check("ovr fit", {
            "K1s launched once per stacked evaluation (x groups), all on "
            "the tensor cores":
                k1s[ds.x.dtype] == stacked_evals * groups
                and sum(k1s.values()) == k1s[ds.x.dtype]
                and k1s_tc == k1s[ds.x.dtype],
            "K1 launched 0 times in the stacked fit": k1 == 0,
            "no other kernel launched": others == 0,
            "the serial fits launch K1 once per evaluation, K1s never":
                serial_k1 == serial_evals and serial_k1s == 0,
            "coefficients agree with the plain stacked fit (rtol 5e-3, "
            "atol 5e-4)": coef_p,
            "coefficients agree with the serial fits": coef_s,
            "final objectives agree to 1e-4": max(obj_p, obj_s) <= 1e-4,
            "predictions agree on >= 99.9% of rows":
                min(agree_p, agree_s) >= 0.999,
            "repeat fit reproduces the models": repeat,
            "finite models": finite,
            "fp8: e4m3 K1s launched once per stacked evaluation, no other "
            "dtype, all on the tensor cores":
                k1s8[torch.float8_e4m3fn] == f_evals * groups8
                and sum(k1s8.values()) == k1s8[torch.float8_e4m3fn]
                and k1s8_tc == k1s8[torch.float8_e4m3fn] and others8 == 0,
        })
        return k1s[ds.x.dtype], k1s8[torch.float8_e4m3fn], k_model.models
    finally:
        ctx.stop()


def phase_cv():
    """CrossValidator over regParam in CV_REGS (3 folds, areaUnderROC) on
    phase 4's data cut to CV_N rows (full width), stacked (parallelism=3,
    K1s) and serial (parallelism=1, K1): the same best regParam and
    avgMetrics to 1e-4. Returns K1s's launches in the stacked run."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.frame import MLFrame
    from cycloneml_tpu_torch.dataset.random import generate_classification
    from cycloneml_tpu_torch.ml.classification import LogisticRegression
    from cycloneml_tpu_torch.ml.evaluation import \
        BinaryClassificationEvaluator
    from cycloneml_tpu_torch.ml.tuning import CrossValidator, \
        ParamGridBuilder
    from cycloneml_tpu_torch.ops import kernels

    ctx = _context("chip_smoke_cv")
    try:
        ds = generate_classification(ctx, FIT_N, FIT_D, seed=0)
        # bf16 values are exact in f32: the frame's bf16 tier gets them back
        frame = MLFrame(ctx, {"features": ds.x[:CV_N].float().cpu().numpy(),
                              "label": ds.y_host()[:CV_N]})
        del ds
        torch.cuda.empty_cache()
        lr = LogisticRegression(maxIter=25, tol=0.0)
        grid = ParamGridBuilder().add_grid(lr.regParam, list(CV_REGS)).build()
        # each stacked fit's lockstep evaluations, recorded on the way
        evals = []
        fit_stacked = LogisticRegression.fit_stacked

        def recording(self, *args, **kwargs):
            models = fit_stacked(self, *args, **kwargs)
            evals.append(models[0].summary.stacked_evals)
            return models

        def cv(par):
            return _timed(lambda: CrossValidator(
                estimator=lr, estimator_param_maps=grid,
                evaluator=BinaryClassificationEvaluator(), numFolds=3,
                parallelism=par).fit(frame))

        LogisticRegression.fit_stacked = recording
        try:
            kernels.reset_launch_counts()
            st, st_s = cv(3)
            st_k1s = kernels.glm_sweep_stacked.launches
            st_k1 = kernels.glm_sweep.launches
        finally:
            LogisticRegression.fit_stacked = fit_stacked
        kernels.reset_launch_counts()
        se, se_s = cv(1)
        se_k1s = kernels.glm_sweep_stacked.launches
        se_k1 = kernels.glm_sweep.launches
        diff = float(np.max(np.abs(np.asarray(st.avg_metrics)
                                   - np.asarray(se.avg_metrics))))
        best = [CV_REGS[int(np.argmax(m.avg_metrics))] for m in (st, se)]
        _line("cv_fit", n=CV_N, d=FIT_D, folds=3, grid=list(CV_REGS),
              reduced={"n": f"{FIT_N} -> {CV_N} rows (phase 4's first "
                            f"{CV_N}), so the run stays in its time limit"},
              stacked={"avg_metrics": st.avg_metrics, "fit_s": st_s,
                       "k1s_launches": st_k1s, "k1_launches": st_k1,
                       "stacked_evals_per_fold": evals,
                       "best_reg": best[0]},
              serial={"avg_metrics": se.avg_metrics, "fit_s": se_s,
                      "k1s_launches": se_k1s, "k1_launches": se_k1,
                      "best_reg": best[1]},
              max_avg_metric_diff=diff)
        _check("cv fit", {
            "K1s launched once per stacked evaluation of every fold":
                st_k1s == sum(evals) and len(evals) == 3,
            "the stacked CV ran K1 only in its final refit":
                st_k1 == st.best_model.summary.total_evals,
            "the serial CV launched no K1s": se_k1s == 0 and se_k1 > 0,
            "both choose the same regParam": best[0] == best[1],
            "avgMetrics agree to 1e-4": diff <= 1e-4,
        })
        return st_k1s
    finally:
        ctx.stop()


# -- the dense linear family: WLS, bounds, multinomial, LinearSVC, GLM --------

def _tf32_off():
    import torch
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        raise AssertionError("TF32 must be off for the float32 products")


def _gram_ok(a, truth) -> bool:
    """Phase 19's rule for a (d, d) matrix of weighted sums:
    |dA_ij| <= 1e-4 sqrt(A_ii A_jj)."""
    import numpy as np
    diag = np.diag(truth)
    return bool(np.all(np.abs(a - truth)
                       <= 1e-4 * np.sqrt(np.outer(diag, diag))))


def _rel_max(a, truth) -> float:
    """max|a - truth| / max|truth|."""
    import numpy as np
    a, truth = np.asarray(a), np.asarray(truth)
    return float(np.max(np.abs(a - truth))
                 / max(float(np.max(np.abs(truth))), 1e-300))


def _close(a, b, a_icpt, b_icpt) -> bool:
    """Models within the kernel-vs-plain bound (rtol 5e-3, atol 5e-4)."""
    import numpy as np
    return bool(np.allclose(a, b, rtol=5e-3, atol=5e-4)) and bool(
        np.allclose(a_icpt, b_icpt, rtol=5e-3, atol=5e-4))


def _wls_objective64(m, coef, icpt, reg, alpha) -> float:
    """The normal solver's objective at an original-space solution, from
    float64 moments: 1/2 E_w[(y - x.coef - icpt)^2] / var_y + the elastic
    net on the standardized coefficients coef_j sigma_j / sigma_y, with
    population sigmas (WLS's convention)."""
    import numpy as np
    ws = float(m["w_sum"])
    ybar, yy = float(m["b_sum"]) / ws, float(m["bb_sum"]) / ws
    abar, ab, aa = m["a_sum"] / ws, m["ab_sum"] / ws, m["aa_sum"] / ws
    var_y = yy - ybar * ybar
    sx = np.sqrt(np.maximum(np.diag(aa) - abar * abar, 0.0))
    mse = (yy - 2.0 * coef @ ab - 2.0 * icpt * ybar + coef @ aa @ coef
           + 2.0 * icpt * (coef @ abar) + icpt * icpt)
    eff = reg / np.sqrt(var_y)
    b = coef * sx / np.sqrt(var_y)
    return float(0.5 * mse / var_y + alpha * eff * np.sum(np.abs(b))
                 + 0.5 * (1.0 - alpha) * eff * np.sum(b * b))


def phase_wls(k2_objective):
    """LinearRegression through the WLS component at configuration 2's
    shape: a default fit (auto resolves to normal, Cholesky) and
    solver='normal' with regParam=0.001, elasticNetParam=0.5 (OWL-QN over
    the moments); the moments against float64 sums of the same bf16 rows,
    the coefficients against the float64-moment solve, the elastic-net
    objective beside phase 6's K2 fit's, no kernel launched, and on the
    fp8 rung one fallback and no launch. ``k2_objective`` is phase 6's
    final objective. Times: the moments pass beside its bound, the host
    solve, the fits."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.random import generate_regression
    from cycloneml_tpu_torch.ml.optim import wls
    from cycloneml_tpu_torch.ml.regression import LinearRegression
    from cycloneml_tpu_torch.ops import kernels

    _tf32_off()
    ctx = _context("chip_smoke_wls")
    try:
        ds, gen_s = _timed(lambda: generate_regression(
            ctx, LIN_N, LIN_D, seed=11, noise=0.1))
        enet_kw = dict(regParam=0.001, elasticNetParam=0.5, maxIter=100,
                       tol=1e-7, solver="normal")
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        default, default_s = _timed(lambda: LinearRegression().fit(ds))
        enet, enet_s = _timed(lambda: LinearRegression(**enet_kw).fit(ds))
        launches = _other_launches(kernels)
        _, steady_s = _timed(lambda: LinearRegression().fit(ds))
        peak = torch.cuda.max_memory_allocated()

        m32 = wls._moments(ds.x, ds.y, ds.w)
        mom_ms = _time_ms(lambda: wls._moment_sums(ds.x, ds.y, ds.w),
                          reps=3, warm=1)
        bound, bound_by = _bound(ds.x.numel() * ds.x.element_size(),
                                 2.0 * LIN_N * LIN_D * LIN_D)
        m64 = wls._moments(ds.x, ds.y.double(), ds.w.double(),
                           acc=torch.float64)
        vec_err = max(_rel_max(m32[k], m64[k]) for k in ("a_sum", "ab_sum"))
        scal_err = max(abs(float(m32[k]) - float(m64[k])) / abs(float(m64[k]))
                       for k in ("w_sum", "b_sum", "bb_sum"))

        def solver(**kw):
            return wls.WeightedLeastSquares(
                fit_intercept=True, standardize_label=True,
                solver_type=wls.AUTO, **kw)

        _, solve_s = _timed(lambda: solver()._solve_from_moments(m32, LIN_D))
        t_def = solver()._solve_from_moments(m64, LIN_D)
        t_enet = solver(reg_param=0.001, elastic_net_param=0.5, max_iter=100,
                        tol=1e-7)._solve_from_moments(m64, LIN_D)
        ok_def = _close(default.coefficients.values, t_def.coefficients,
                        default.intercept, t_def.intercept)
        ok_enet = _close(enet.coefficients.values, t_enet.coefficients,
                         enet.intercept, t_enet.intercept)
        # the objective the fit reports is 0.5 bb - atb.c + 0.5 c.ata.c
        # over float32 moments: ~4e-4 left of terms ~0.5, so it carries
        # the moments' rounding times ~1e3 (1% here); the solution's
        # objective is evaluated again on the float64 moments
        obj = enet.summary.objective_history[-1]
        obj64 = _wls_objective64(m64, enet.coefficients.values,
                                 enet.intercept, 0.001, 0.5)
        k2_obj = k2_objective
        obj_rel = abs(obj64 - k2_obj) / abs(k2_obj)

        # the fp8 rung: the normal solver leaves it, once, visibly
        ctx.conf.set("cyclone.data.dtype", "float8")
        ds8 = ds.quantized()
        kernels.reset_launch_counts()
        before = len(ctx.precision_fallbacks)
        m8, fp8_s = _timed(lambda: LinearRegression().fit(ds8))
        fp8_launches = _other_launches(kernels)
        fallbacks = ctx.precision_fallbacks[before:]
        _line("wls_fit", n=LIN_N, d=LIN_D, data_dtype=_dt(ds.x),
              generate_s=gen_s,
              default={"solver": "normal (cholesky)", "warm_s": default_s,
                       "steady_s": steady_s,
                       "max_abs_coef_diff_to_f64": float(np.max(np.abs(
                           default.coefficients.values - t_def.coefficients)))},
              elastic_net={"solver": "normal (OWL-QN over the moments)",
                           "iterations": enet.summary.total_iterations,
                           "fit_s": enet_s,
                           "final_objective_reported": obj,
                           "reported_rel_diff": abs(obj - k2_obj) / k2_obj,
                           "final_objective_on_f64_moments": obj64,
                           "f64_solve_objective":
                               t_enet.objective_history[-1],
                           "k2_fit_final_objective": k2_obj,
                           "objective_rel_diff": obj_rel,
                           "zero_coefficients": int(np.sum(
                               enet.coefficients.values == 0))},
              moments={"ms": mom_ms, "bound_ms": bound, "bound_by": bound_by,
                       "aa_max_rel_to_diag": float(np.max(
                           np.abs(m32["aa_sum"] - m64["aa_sum"]) / np.sqrt(
                               np.outer(np.diag(m64["aa_sum"]),
                                        np.diag(m64["aa_sum"]))))),
                       "vector_rel_err": vec_err, "scalar_rel_err": scal_err},
              host_solve_s=solve_s, kernel_launches=launches,
              fp8={"fit_s": fp8_s, "fallbacks": fallbacks,
                   "kernel_launches": fp8_launches},
              max_memory_allocated=peak)
        _check("wls fit", {
            "XᵀWX within 1e-4 sqrt(A_ii A_jj) of float64":
                _gram_ok(m32["aa_sum"], m64["aa_sum"]),
            "moment vectors and sums within 1e-5 of float64":
                vec_err <= 1e-5 and scal_err <= 1e-5,
            "default fit within rtol 5e-3, atol 5e-4 of the float64-moment "
            "solve": ok_def,
            "elastic-net fit within rtol 5e-3, atol 5e-4 of the "
            "float64-moment solve": ok_enet,
            "elastic-net solution's objective (float64 moments) within "
            "1e-4 of phase 6's K2 fit": obj_rel <= 1e-4,
            "neither fit launched a kernel (K2 included)": launches == 0,
            "fp8: one precision fallback, no kernel launched":
                len(fallbacks) == 1 and fp8_launches == 0,
            "finite models": bool(np.all(np.isfinite(
                default.coefficients.values))) and bool(np.all(np.isfinite(
                    m8.coefficients.values))),
        })
    finally:
        ctx.stop()


def phase_bounded():
    """Bounded binomial LogisticRegression on phase 4's data
    (lowerBoundsOnCoefficients = 0, regParam=0.01, maxIter=25, tol=0):
    L-BFGS-B through K1 and through the plain aggregator. Returns K1's
    launches in the K1 fit."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.random import generate_classification
    from cycloneml_tpu_torch.ml.classification import LogisticRegression
    from cycloneml_tpu_torch.ops import kernels

    _tf32_off()
    ctx = _context("chip_smoke_bounds")
    try:
        ds, gen_s = _timed(lambda: generate_classification(
            ctx, FIT_N, FIT_D, seed=0))

        def fit(mode):
            ctx.conf.set("cyclone.ml.usePallasKernels", mode)
            return _timed(lambda: LogisticRegression(
                regParam=0.01, maxIter=25, tol=0.0,
                lowerBoundsOnCoefficients=np.zeros((1, FIT_D))).fit(ds))

        # the main path: counts zeroed just before, read just after
        kernels.reset_launch_counts()
        k_model, k_s = fit("auto")
        launches = kernels.glm_sweep.launches_by_link[kernels.LOGISTIC]
        others = _other_launches(kernels, "logistic")
        p_model, p_s = fit("false")
        ks, ps = k_model.summary, p_model.summary
        kc, pc = k_model.coefficients.values, p_model.coefficients.values
        obj_rel = abs(ks.objective_history[-1] - ps.objective_history[-1]) \
            / abs(ps.objective_history[-1])
        _line("bounded_fit", n=FIT_N, d=FIT_D, data_dtype=_dt(ds.x),
              generate_s=gen_s,
              kernel={"iterations": ks.total_iterations,
                      "evals": ks.total_evals, "k1_launches": launches,
                      "fit_s": k_s,
                      "final_objective": ks.objective_history[-1],
                      "at_the_bound": int(np.sum(kc == 0.0))},
              plain={"iterations": ps.total_iterations,
                     "evals": ps.total_evals, "fit_s": p_s,
                     "final_objective": ps.objective_history[-1],
                     "at_the_bound": int(np.sum(pc == 0.0))},
              max_abs_coef_diff=float(np.max(np.abs(kc - pc))),
              objective_rel_diff=obj_rel,
              train_accuracy=_train_accuracy(ds, kc, k_model.intercept))
        _check("bounded fit", {
            "K1 launched once per evaluation": launches == ks.total_evals,
            "no other kernel launched": others == 0,
            "every coefficient >= 0 exactly": bool(np.all(kc >= 0.0))
            and bool(np.all(pc >= 0.0)),
            "coefficients agree (rtol 5e-3, atol 5e-4)": _close(
                kc, pc, k_model.intercept, p_model.intercept),
            "final objectives agree to 1e-4": obj_rel <= 1e-4,
            "finite model": bool(np.all(np.isfinite(kc))),
        })
        return launches
    finally:
        ctx.stop()


def phase_multinomial(ovr_models):
    """Multinomial LogisticRegression on phase 16's data (8 classes,
    maxIter=25, regParam=0.01, tol=0, family auto): one aggregator
    evaluation against float64 on the same rows, the fit (warm, steady),
    its predictions beside those of phase 16's OneVsRest ``ovr_models``,
    and the same rows quantized on the card within the fp8 envelope of
    the bf16 fit."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.random import generate_multiclass
    from cycloneml_tpu_torch.ml.classification import LogisticRegression
    from cycloneml_tpu_torch.ml.optim import aggregators
    from cycloneml_tpu_torch.ml.optim.loss import inv_std_vector
    from cycloneml_tpu_torch.ml.stat import Summarizer
    from cycloneml_tpu_torch.ops import kernels

    _tf32_off()
    ctx = _context("chip_smoke_multinomial")
    try:
        ds, gen_s = _timed(lambda: generate_multiclass(
            ctx, FIT_N, FIT_D, OVR_K, seed=7))
        stats = Summarizer.summarize(ds)
        inv = inv_std_vector(stats.std)
        coef = np.random.RandomState(5).randn(FIT_D * OVR_K + OVR_K) * 0.05
        agg = aggregators.multinomial_logistic_scaled(FIT_D, OVR_K, True)
        dev = ds.x.device
        f32, f64 = torch.float32, torch.float64

        def evaluate(dt):
            t = [torch.as_tensor(a, device=dev).to(dt)
                 for a in (inv, stats.mean * inv, coef)]
            return agg(ds.x, ds.y.to(dt), ds.w.to(dt), *t)

        got, truth = evaluate(f32), evaluate(f64)
        loss_rel = abs(float(got["loss"]) - float(truth["loss"])) \
            / abs(float(truth["loss"]))
        grad_err = _rel_max(got["grad"].double().cpu().numpy(),
                            truth["grad"].cpu().numpy())
        agg_ms = _time_ms(lambda: evaluate(f32), reps=3, warm=1)

        def fit(data):
            return _timed(lambda: LogisticRegression(
                maxIter=25, regParam=0.01, tol=0.0).fit(data))

        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        model, warm_s = fit(ds)
        launches = _other_launches(kernels)
        again, steady_s = fit(ds)
        peak = torch.cuda.max_memory_allocated()
        wm = model.coefficient_matrix.to_array()
        pred = _argmax_margins(ds, wm, model.intercept_vector.values)
        labels = torch.as_tensor(ds.y_host()[:ds.n_rows], device=dev).long()
        acc = float((pred == labels).double().mean())
        agree_ovr = float((pred == _ovr_margins(ds, ovr_models))
                          .double().mean())

        ctx.conf.set("cyclone.data.dtype", "float8")
        ds8, quant_s = _timed(ds.quantized)
        kernels.reset_launch_counts()
        m8, fp8_s = fit(ds8)
        fp8_launches = _other_launches(kernels)
        envelope = _norm_rel(m8.coefficient_matrix.to_array(), wm)
        s = model.summary
        _line("multinomial_fit", n=FIT_N, d=FIT_D, classes=OVR_K,
              data_dtype=_dt(ds.x), generate_s=gen_s,
              aggregator={"loss_rel_err": loss_rel,
                          "grad_err_rel_to_max": grad_err,
                          "ms": agg_ms},
              fit={"iterations": s.total_iterations, "evals": s.total_evals,
                   "dispatches": s.total_dispatches, "warm_s": warm_s,
                   "steady_s": steady_s,
                   "final_objective": s.objective_history[-1],
                   "kernel_launches": launches},
              train_accuracy=acc, prediction_agreement_with_ovr=agree_ovr,
              fp8={"iterations": m8.summary.total_iterations,
                   "quantize_s": quant_s, "fit_s": fp8_s,
                   "coef_norm_rel_to_bf16": envelope,
                   "kernel_launches": fp8_launches,
                   "fallbacks": ctx.precision_fallbacks},
              max_memory_allocated=peak)
        _check("multinomial fit", {
            "one evaluation: loss within 1e-5 of float64": loss_rel <= 1e-5,
            "one evaluation: gradient within 1e-4 of its largest entry":
                grad_err <= 1e-4,
            "no kernel launched (the multinomial aggregator is plain)":
                launches == 0 and fp8_launches == 0,
            "ran 25 iterations or stopped on an exact float32 stall":
                _ran_to_stop(s),
            "repeat fit reproduces the model": bool(np.array_equal(
                again.coefficient_matrix.to_array(), wm)),
            "finite model": bool(np.all(np.isfinite(wm))),
            "fp8: X is e4m3 codes, no fp8 fallback fired":
                ds8.x.dtype == torch.float8_e4m3fn
                and not ctx.precision_fallbacks,
            "fp8: within the fp8 envelope (20%) of the bf16 fit":
                envelope < FP8_COEF_NORMREL,
        })
    finally:
        ctx.stop()


def _hinge_sides_differ(ds, coef32, coef64) -> int:
    """Rows whose side of the hinge (1 - y m > 0) differs between the
    float32 and the float64 margins of the same rows."""
    import torch
    d = ds.n_features
    dev = ds.x.device
    c32 = torch.as_tensor(coef32, device=dev)
    c64 = torch.as_tensor(coef64, device=dev)
    differ = 0
    for lo in range(0, ds.n_rows, ROWS64):
        hi = min(lo + ROWS64, ds.n_rows)
        ys = 2.0 * ds.y[lo:hi].double() - 1.0
        m32 = ds.x[lo:hi].float() @ c32[:d] + c32[d]
        m64 = ds.x[lo:hi].double() @ c64[:d] + c64[d]
        differ += int(((1.0 - ys * m32.double() > 0)
                       != (1.0 - ys * m64 > 0)).sum())
    return differ


def phase_svc():
    """LinearSVC on phase 4's data (regParam=0.01, maxIter=25): one hinge
    evaluation on the standardized copy against float64, the rows whose
    side of the hinge differs, the fit's time and its peak memory beside
    X's bytes."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.random import generate_classification
    from cycloneml_tpu_torch.ml.classification import LinearSVC
    from cycloneml_tpu_torch.ml.optim import aggregators
    from cycloneml_tpu_torch.ml.optim.loss import standardize_dataset
    from cycloneml_tpu_torch.ml.stat import Summarizer
    from cycloneml_tpu_torch.ops import kernels

    _tf32_off()
    ctx = _context("chip_smoke_svc")
    try:
        ds, gen_s = _timed(lambda: generate_classification(
            ctx, FIT_N, FIT_D, seed=0))
        x_bytes = ds.x.numel() * ds.x.element_size()
        stats = Summarizer.summarize(ds)
        std_ds, _ = standardize_dataset(ds, stats.std)
        coef = np.random.RandomState(6).randn(FIT_D + 1) * 0.03
        agg = aggregators.hinge(FIT_D, True)
        dev = ds.x.device

        def evaluate(dt):
            return agg(std_ds.x, std_ds.y.to(dt), std_ds.w.to(dt),
                       torch.as_tensor(coef, device=dev).to(dt))

        got, truth = evaluate(torch.float32), evaluate(torch.float64)
        loss_rel = abs(float(got["loss"]) - float(truth["loss"])) \
            / abs(float(truth["loss"]))
        grad_err = _rel_max(got["grad"].double().cpu().numpy(),
                            truth["grad"].cpu().numpy())
        differ = _hinge_sides_differ(std_ds, coef.astype(np.float32), coef)
        agg_ms = _time_ms(lambda: evaluate(torch.float32), reps=3, warm=1)
        del std_ds, got, truth
        torch.cuda.empty_cache()

        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        model, fit_s = _timed(lambda: LinearSVC(regParam=0.01,
                                                maxIter=25).fit(ds))
        launches = _other_launches(kernels)
        peak = torch.cuda.max_memory_allocated()
        coefs = model.coefficients.values
        hist = model.objective_history
        acc = _train_accuracy(ds, coefs, model.intercept)
        _line("svc_fit", n=FIT_N, d=FIT_D, data_dtype=_dt(ds.x),
              generate_s=gen_s,
              hinge={"loss_rel_err": loss_rel,
                     "grad_err_rel_to_max": grad_err,
                     "rows_on_other_side": differ, "ms": agg_ms},
              fit={"iterations": model.total_iterations,
                   "evals": model.total_evals, "fit_s": fit_s,
                   "final_objective": hist[-1], "kernel_launches": launches},
              train_accuracy=acc, x_bytes=x_bytes,
              peak_above_start_bytes=peak - base,
              peak_over_x_bytes=(peak - base) / x_bytes)
        _check("svc fit", {
            "one evaluation: loss within 1e-5 of float64": loss_rel <= 1e-5,
            "one evaluation: gradient within 1e-4 of its largest entry":
                grad_err <= 1e-4,
            "no kernel launched (the hinge aggregator is plain)":
                launches == 0,
            "the objective fell": hist[-1] < hist[0],
            "finite model": bool(np.all(np.isfinite(coefs))),
        })
    finally:
        ctx.stop()


def _poisson_irls64(ds, n_iter):
    """A float64 IRLS for the Poisson family with the log link over the
    same rows, on the card and independent of the port's GLM: returns
    the first pass's XᵀWX and the coefficients after ``n_iter`` passes."""
    import torch
    f64 = torch.float64
    n, d = ds.n_rows, ds.n_features
    dev = ds.x.device
    y = ds.y[:n].to(f64)
    beta, icpt, first = torch.zeros(d, dtype=f64, device=dev), 0.0, None
    for it in range(n_iter):
        xtx = torch.zeros((d, d), dtype=f64, device=dev)
        xty = torch.zeros(d, dtype=f64, device=dev)
        xsum = torch.zeros(d, dtype=f64, device=dev)
        wsum = zsum = 0.0
        for lo in range(0, n, ROWS64):
            xc = ds.x[lo:lo + ROWS64].to(f64)
            yc = y[lo:lo + ROWS64]
            if it == 0:
                mu = yc.clamp(min=0.1)
                eta = mu.log()
            else:
                eta = xc @ beta + icpt
                mu = eta.exp()
            z = eta + (yc - mu) / mu        # d eta / d mu = 1 / mu
            xw = xc * mu[:, None]           # W = 1 / (g^2 V) = mu
            xtx += xw.T @ xc
            xty += xw.T @ z
            xsum += xw.sum(0)
            wsum += float(mu.sum())
            zsum += float((mu * z).sum())
        if it == 0:
            first = xtx.cpu().numpy()
        a = torch.zeros((d + 1, d + 1), dtype=f64, device=dev)
        a[:d, :d], a[:d, d], a[d, :d], a[d, d] = xtx, xsum, xsum, wsum
        b = torch.cat([xty, torch.tensor([zsum], dtype=f64, device=dev)])
        sol = torch.linalg.solve(a, b)
        beta, icpt = sol[:d], float(sol[d])
    return first, beta.cpu().numpy(), icpt


def phase_glm():
    """GeneralizedLinearRegression(family="poisson", link="log") at
    400,000 x 2,000 bf16: x from the seeded generator scaled by 1/sqrt(d),
    y ~ Poisson(exp(x.beta)) with beta from numpy; the first IRLS pass's
    XᵀWX against float64, the coefficients against a float64 IRLS over the
    same rows with as many passes, the pass's time beside its bound, the
    summary's time and the fit's."""
    import math

    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.random import generate_regression
    from cycloneml_tpu_torch.ml.regression import glm
    from cycloneml_tpu_torch.ops import kernels

    _tf32_off()
    ctx = _context("chip_smoke_glm")
    try:
        def make():
            base = generate_regression(ctx, LIN_N, LIN_D, seed=13)
            x, dev = base.x, base.x.device
            beta = torch.as_tensor(
                np.random.RandomState(13).randn(LIN_D) * 0.5,
                dtype=torch.float32, device=dev)
            g = torch.Generator(device=dev).manual_seed(13)
            y = torch.zeros_like(base.y)
            for lo in range(0, base.n_rows, ROWS):
                hi = min(lo + ROWS, base.n_rows)
                xs = x[lo:hi].float() / math.sqrt(LIN_D)
                x[lo:hi] = xs.to(x.dtype)
                y[lo:hi] = torch.poisson(torch.exp(x[lo:hi].float() @ beta),
                                         generator=g).to(y.dtype)
            return base.derive(y=y).attach_host_labels(
                y.cpu().double().numpy(), base.w_host())

        ds, gen_s = _timed(make)
        est = glm.GeneralizedLinearRegression(family="poisson", link="log")
        fam, link = glm._family_link(est)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        model, fit_s = _timed(lambda: est.fit(ds))
        launches = _other_launches(kernels)
        peak = torch.cuda.max_memory_allocated()
        n_iter = model.summary.num_iterations
        off = torch.zeros_like(ds.w)

        first32 = glm._irls_pass(ds.x, ds.y, ds.w, off, np.zeros(LIN_D), 0.0,
                                 True, fam, link)["xtx"].double().cpu().numpy()
        first64, beta64, icpt64 = _poisson_irls64(ds, n_iter)
        pass_ms = _time_ms(lambda: glm._irls_pass(
            ds.x, ds.y, ds.w, off, model._coef, model._icpt, False, fam,
            link), reps=3, warm=1)
        bound, bound_by = _bound(ds.x.numel() * ds.x.element_size(),
                                 2.0 * LIN_N * LIN_D * LIN_D)
        _, summary_s = _timed(lambda: est._summarize(
            model, ds, off, False, fam, link, n_iter))
        coefs = model.coefficients.values
        s = model.summary
        _line("glm_fit", n=LIN_N, d=LIN_D, data_dtype=_dt(ds.x),
              family="poisson", link="log", generate_s=gen_s,
              fit={"iterations": n_iter, "fit_s": fit_s,
                   "deviance_history": s.objective_history,
                   "kernel_launches": launches},
              irls_pass={"ms": pass_ms, "bound_ms": bound,
                         "bound_by": bound_by},
              summary_s=summary_s, deviance=s.deviance,
              null_deviance=s.null_deviance, aic=s.aic,
              max_abs_coef_diff_to_f64=float(np.max(np.abs(coefs - beta64))),
              intercepts=[model.intercept, icpt64],
              first_pass_xtwx_max_rel_to_diag=float(np.max(
                  np.abs(first32 - first64) / np.sqrt(np.outer(
                      np.diag(first64), np.diag(first64))))),
              max_memory_allocated=peak)
        _check("glm fit", {
            "first pass XᵀWX within 1e-4 sqrt(A_ii A_jj) of float64":
                _gram_ok(first32, first64),
            "coefficients within rtol 5e-3, atol 5e-4 of the float64 IRLS "
            "with as many passes": _close(coefs, beta64, model.intercept,
                                          icpt64),
            "no kernel launched": launches == 0,
            "the deviance fell below the null deviance":
                s.deviance < s.null_deviance,
            "finite model and standard errors": bool(np.all(np.isfinite(
                coefs))) and bool(np.all(np.isfinite(
                    s.coefficient_standard_errors))),
        })
    finally:
        ctx.stop()


# -- the sparse tier: S1 and S2, Criteo-class LR, configuration 5 -------------

def _ell_pair(ds, beta, b0, link, scale, columns=None, plain=False):
    """S1 then S2 on the dataset's rows: ``(mult, loss, sum(mult), sum(w),
    grad)``; the kernels, or with ``plain`` their plain versions at
    beta's dtype (the float64 truth for a float64 beta)."""
    from cycloneml_tpu_torch.ops import kernels
    rows = kernels.ell_rows_plain if plain else kernels.ell_rows
    mult, loss, msum, wsum = rows(ds.indices, ds.values, ds.y, ds.w, beta, b0,
                                  link, scale, ds.tail())
    if plain:
        grad = kernels.ell_cols_plain(ds.indices, ds.values, mult,
                                      ds.n_features, scale=scale,
                                      tail=ds.tail())
    else:
        grad = kernels.ell_cols(ds.indices, ds.values, mult, ds.n_features,
                                scale=scale, tail=ds.tail(), columns=columns)
    return mult, loss, msum, wsum, grad


def _abs_sums(ds, scale, beta=None, r=None):
    """Float64 sums of the absolute terms of a pass, a chunk of rows at a
    time (with the tail): per row sum |v s beta| (given ``beta``: the
    scale of the row's margin), or per column sum |r v s| (given ``r``:
    the scale of the column's sum); v s is the float32 product the passes
    form."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    n = ds.indices.shape[0]
    rows_out = beta is not None
    out = torch.zeros(n if rows_out else ds.n_features, dtype=torch.float64,
                      device=ds.device)
    b = None if beta is None else beta.double().abs()
    rr = None if r is None else r.double().abs()

    def av(v, cols):
        return (v if scale is None else v * scale[cols]).abs().double()

    for lo in range(0, n, ROWS):
        hi = min(lo + ROWS, n)
        c = ds.indices[lo:hi].long()
        v = av(ds.values[lo:hi], c)
        if rows_out:
            out[lo:hi] = torch.sum(v * b[c], 1)
        else:
            out.index_add_(0, c.reshape(-1), (v * rr[lo:hi, None]).reshape(-1))
    tail = ds.tail()
    if tail is not None:
        t_rows, c = kernels.tail_row_ids(tail), tail.cols.long()
        v = av(tail.vals, c)
        if rows_out:
            out.index_add_(0, t_rows, v * b[c])
        else:
            out.index_add_(0, c, v * rr[t_rows])
    return out


# S1 forms each slot's product v s beta in float32 (the truth forms it in
# float64 from the same float32 factors) and sums in double, so a row's
# margin is off by at most 2^-24 M_i, M_i = sum |v s beta|; its mult by at
# most L_i 2^-24 M_i plus float32's rounding of mult, L_i the link's slope
# (w/4 logistic, w squared, [w > 0] Gram). S2 forms r v s in float32 as its
# plain version does and sums in double: a column is off by float32's
# rounding of the result and a double rounding of A_j = sum |r v s|. The
# checks below hold every row and every column to these bounds, at twice
# the unit roundoff.
ELL_ROW_RTOL = 1.2e-7     # ~2 * 2^-24
ELL_COL_RTOL = 1e-7       # float32 rounding of each column's sum
ELL_COL_ATOL = 1e-9       # relative to A_j: the two double sums' orders


def _col_excess(got, truth, scale_a):
    """The largest |got - truth| / (ELL_COL_RTOL |truth| + ELL_COL_ATOL
    A_j) over the columns: at most 1 where every column holds."""
    import torch
    err = (got.double() - truth).abs()
    tol = ELL_COL_RTOL * truth.abs() + ELL_COL_ATOL * scale_a
    return float(torch.max(err / torch.clamp(tol, min=1e-300)))


def phase_ell(ds, columns):
    """S1 and S2 against float64 on the Criteo-class rows: one evaluation
    per link (logistic with the fit's standardizing scale; squared, hinge,
    Gram) and the moments mode. Each row's mult and each column's sum is
    held to its own scale (the bounds above): S1's mult against the
    float64 truth, row by row (a hinge row exact unless its margin lies
    within its bound of the hinge); S2 on S1's own mult against its plain
    version summed in float64, column by column; the loss within the
    bound the rows' margins allow, sum(mult) the double sum of mult,
    sum(w) exact; two launches bitwise equal. Then the times of each
    beside its plain version (float32), its bounds and cuSPARSE CSR SpMV
    (X beta, a yardstick for S1; X^T r, the same function as S2's
    gradient). Returns the kernels line's numbers of S1 and S2."""
    import torch
    from cycloneml_tpu_torch.dataset.sparse import sparse_feature_std
    from cycloneml_tpu_torch.ops import kernels

    dev = ds.device
    n, k = ds.indices.shape
    d = ds.n_features
    g = torch.Generator(device=dev).manual_seed(21)
    beta = torch.randn(d, generator=g, device=dev) * 0.1
    inv = torch.as_tensor(sparse_feature_std(ds), device=dev)
    inv = torch.where(inv > 0, 1.0 / torch.where(inv > 0, inv, 1.0),
                      0.0).float()
    w64 = ds.w.double()
    # the float64 margins (for the hinge's rows near its kink) and the
    # rows' margin scales, unscaled and with the standardizing scale
    margin_t = kernels.ell_rows_plain(
        ds.indices, ds.values, ds.y, torch.ones_like(ds.w), beta.double(),
        -1.0, kernels.GRAM, None, ds.tail())[0]
    m_scale = {None: _abs_sums(ds, None, beta=beta),
               "inv": _abs_sums(ds, inv, beta=beta)}
    slope = {kernels.LOGISTIC: w64 / 4, kernels.SQUARED: w64,
             kernels.HINGE: w64, kernels.GRAM: (w64 > 0).double()}
    errs, checks = {}, {}
    for link, scale in ((kernels.LOGISTIC, inv), (kernels.SQUARED, None),
                        (kernels.HINGE, None), (kernels.GRAM, None)):
        big_m = m_scale["inv" if scale is not None else None]
        a = _ell_pair(ds, beta, -1.0, link, scale, columns)
        b = _ell_pair(ds, beta, -1.0, link, scale, columns)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(u, v) for u, v in zip(a, b))
        del b
        t = _ell_pair(ds, beta.double(), -1.0, link, scale, plain=True)
        # S1, row by row
        dmult = (a[0].double() - t[0]).abs()
        if link == kernels.HINGE:
            near = (1.0 - (2.0 * ds.y.double() - 1.0) * margin_t).abs() \
                <= ELL_ROW_RTOL * big_m
            mult_excess = float(torch.max(torch.where(near, 0.0, dmult)))
            n_near = int(near.sum())
            deriv = w64
        else:
            tol = ELL_ROW_RTOL * (slope[link] * big_m + t[0].abs())
            mult_excess = float(torch.max(dmult / torch.clamp(tol,
                                                              min=1e-300)))
            n_near = 0
            deriv = t[0].abs() if link != kernels.GRAM else 0.0 * w64
        del dmult
        loss_tol = ELL_ROW_RTOL * float(torch.sum(deriv * big_m)) \
            + 1e-12 * abs(float(t[1]))
        loss_err = abs(float(a[1]) - float(t[1]))
        msum_err = abs(float(a[2]) - float(torch.sum(a[0].double())))
        msum_tol = 1e-12 * float(torch.sum(a[0].double().abs()))
        # S2 on S1's own mult, column by column
        g_t = kernels.ell_cols_plain(ds.indices, ds.values, a[0], d,
                                     scale=scale, tail=ds.tail(),
                                     acc_dtype=torch.float64)
        col_excess = _col_excess(a[4], g_t, _abs_sums(ds, scale, r=a[0]))
        del g_t
        errs[link] = {"loss_err": loss_err, "loss_bound": loss_tol,
                      "loss_rel": loss_err / max(abs(float(t[1])), 1e-300),
                      "mult_max_abs_err": float((a[0].double() - t[0])
                                                .abs().max()),
                      "mult_worst_over_row_bound": mult_excess,
                      "hinge_rows_near_kink": n_near,
                      "grad_worst_over_column_bound": col_excess,
                      "max_abs_grad_err_vs_float64_chain": float(
                          (a[4].double() - t[4]).abs().max()),
                      "max_abs_grad": float(t[4].abs().max()),
                      "sum_mult_err": msum_err, "bitwise_equal": bitwise,
                      "sum_w": float(a[3])}
        checks.update({
            f"{link}: |dloss| <= 1e-5 |loss|": errs[link]["loss_rel"] <= 1e-5
            or float(t[1]) == 0.0,
            f"{link}: max|dgrad| <= 1e-4 max|grad| (S1 then S2, float64)":
                errs[link]["max_abs_grad_err_vs_float64_chain"]
                <= 1e-4 * errs[link]["max_abs_grad"],
            f"{link}: every row's mult within its bound"
            + (" (exact off the kink)" if link == kernels.HINGE else ""):
                mult_excess <= 1.0,
            f"{link}: |dloss| within the rows' margin bound":
                loss_err <= loss_tol,
            f"{link}: sum(mult) is the double sum of mult":
                msum_err <= msum_tol,
            f"{link}: S2 on S1's mult, every column within its bound":
                col_excess <= 1.0,
            f"{link}: sum(w) exact": float(a[3]) == float(t[3]),
            f"{link}: two launches bitwise equal": bitwise,
        })
        del a, t
    del margin_t, m_scale
    m1 = kernels.ell_cols(ds.indices, ds.values, ds.w, d, moments=True,
                          columns=columns)
    m2 = kernels.ell_cols(ds.indices, ds.values, ds.w, d, moments=True,
                          columns=columns)
    tm = kernels.ell_cols_plain(ds.indices, ds.values, ds.w, d, moments=True,
                                acc_dtype=torch.float64)
    # sum w v is held to sum |w v|; the other two have no negative term
    a0 = _abs_sums(ds, None, r=ds.w)
    mom_excess = [_col_excess(m1[q], tm[q], a0 if q == 0 else tm[q].abs())
                  for q in range(3)]
    mom_err = [float((m1[q].double() - tm[q]).abs().max()
                     / tm[q].abs().max()) for q in range(3)]
    checks["moments: max|d| <= 1e-4 max|moment|"] = max(mom_err) <= 1e-4
    checks["moments: every column within its bound"] = max(mom_excess) <= 1.0
    checks["moments: two launches bitwise equal"] = torch.equal(m1, m2)
    del m1, m2, tm, a0

    # times at the fit's form: the logistic link with the scale
    mult = kernels.ell_rows(ds.indices, ds.values, ds.y, ds.w, beta, -1.0,
                            kernels.LOGISTIC, inv)[0]
    s1_ms = _time_ms(lambda: kernels.ell_rows(
        ds.indices, ds.values, ds.y, ds.w, beta, -1.0, kernels.LOGISTIC,
        inv), 5, 1)
    s2_ms = _time_ms(lambda: kernels.ell_cols(
        ds.indices, ds.values, mult, d, scale=inv, columns=columns), 5, 1)
    mom_ms = _time_ms(lambda: kernels.ell_cols(
        ds.indices, ds.values, ds.w, d, moments=True, columns=columns), 3, 1)
    s1_plain = _time_ms(lambda: kernels.ell_rows_plain(
        ds.indices, ds.values, ds.y, ds.w, beta, -1.0, kernels.LOGISTIC,
        inv), 2, 1)
    s2_plain = _time_ms(lambda: kernels.ell_cols_plain(
        ds.indices, ds.values, mult, d, scale=inv), 2, 1)
    # cuSPARSE yardsticks over the same buffers (no copy of the nonzeros):
    # the ELL as CSR rows of k slots, the column copy as CSR rows of X^T
    crow = torch.arange(0, n * k + 1, k, dtype=torch.int32, device=dev)
    x_csr = torch.sparse_csr_tensor(crow, ds.indices.view(-1),
                                    ds.values.view(-1), size=(n, d),
                                    check_invariants=False)
    xt_csr = torch.sparse_csr_tensor(columns.col_ptr.int(), columns.rows,
                                     columns.vals, size=(d, n),
                                     check_invariants=False)
    spmv_x = _time_ms(lambda: torch.mv(x_csr, beta), 5, 1)
    spmv_xt = _time_ms(lambda: torch.mv(xt_csr, mult), 5, 1)
    del x_csr, xt_csr, crow
    nnz = int(columns.col_ptr[-1])
    n_pieces = columns.piece_col.shape[0]
    s1_bytes = n * k * 8 + n * 12 + d * 8
    s2_bytes = nnz * 8 + n * 4 + d * 4 + (d + 1) * 16 + n_pieces * 4
    s1_bound, s1_by = _bound(s1_bytes, 2.0 * n * k)
    s2_bound, s2_by = _bound(s2_bytes, 2.0 * nnz)
    gather = {"s1_with_beta_sector_gathers_ms":
              (s1_bytes + n * k * 32) / H100_BYTES_PER_S * 1e3,
              "s2_with_mult_sector_gathers_ms":
              (s2_bytes + nnz * 32) / H100_BYTES_PER_S * 1e3}
    _line("ell_check", n=n, k=k, d=d, nnz=nnz, pieces=n_pieces, links=errs,
          moments_rel_err=mom_err, moments_worst_over_column_bound=mom_excess,
          row_rtol=ELL_ROW_RTOL, column_rtol=ELL_COL_RTOL,
          column_atol_of_abs_sum=ELL_COL_ATOL)
    _line("ell_time", s1_ms=s1_ms, s2_ms=s2_ms, s2_moments_ms=mom_ms,
          s1_plain_ms=s1_plain, s2_plain_ms=s2_plain, s1_bound_ms=s1_bound,
          s2_bound_ms=s2_bound, bound_by=[s1_by, s2_by],
          spmv_x_beta_ms=spmv_x, spmv_xt_r_ms=spmv_xt, **gather)
    _check("ell", checks)
    s1 = {"max_abs_err": errs[kernels.LOGISTIC]["mult_max_abs_err"],
          "ms": s1_ms, "plain_ms": s1_plain, "bound_ms": s1_bound,
          "bound_by": s1_by, "library_ms": None, "yardstick_ms": spmv_x,
          "bound_with_sector_gathers_ms":
              gather["s1_with_beta_sector_gathers_ms"]}
    s2 = {"max_abs_err":
          errs[kernels.LOGISTIC]["max_abs_grad_err_vs_float64_chain"],
          "ms": s2_ms, "plain_ms": s2_plain, "bound_ms": s2_bound,
          "bound_by": s2_by, "library_ms": spmv_xt, "moments_ms": mom_ms,
          "bound_with_sector_gathers_ms":
              gather["s2_with_mult_sector_gathers_ms"]}
    return s1, s2


def _sparse_margins(ds, coef, intercept):
    """X coef + intercept of the real rows, float32, on the card."""
    import torch
    c = torch.as_tensor(coef, dtype=torch.float32, device=ds.device)
    out = torch.empty(ds.n_rows, dtype=torch.float32, device=ds.device)
    for lo in range(0, ds.n_rows, ROWS):
        hi = min(lo + ROWS, ds.n_rows)
        out[lo:hi] = torch.sum(ds.values[lo:hi] * c[ds.indices[lo:hi].long()],
                               1) + intercept
    return out


def _auc(scores, labels) -> float:
    """Area under the ROC curve by the rank sum (ties have probability 0
    for continuous scores), on the card in float64."""
    import torch
    n = scores.shape[0]
    ranks = torch.empty(n, dtype=torch.float64, device=scores.device)
    ranks[torch.argsort(scores)] = torch.arange(
        1, n + 1, dtype=torch.float64, device=scores.device)
    pos = labels > 0.5
    p = float(pos.sum())
    return (float(ranks[pos].sum()) - p * (p + 1) / 2) / (p * (n - p))


def _sparse_fit(ctx, ds, mode):
    from cycloneml_tpu_torch.ml.classification import LogisticRegression
    ctx.conf.set("cyclone.ml.usePallasKernels", mode)
    return _timed(lambda: LogisticRegression(maxIter=25, regParam=0.01)
                  .fit(ds))


def _split_fit(ctx, ds):
    """One kernel fit, as :func:`_sparse_fit`, with its host time taken
    apart by wrapping the fit's own calls (each wrapper synchronizes the
    card on both sides of what it times, where the fit reads back anyway):

    - ``std_s``: the feature std, the moments launch and its readback;
    - ``setup_other_s``: the rest before the first evaluation (the label
      mask and histogram over the rows, the standardized view, the L2
      term);
    - ``evals_device_s``: every evaluation's S1 and S2 with their sums;
    - ``evals_host_s``: the rest of the loss function's calls (the
      coefficients to the card, the gradient back, the scalar readbacks
      of the line searches, the normalizing and L2 arithmetic);
    - ``optimizer_s``: the host optimizer between its calls (the two-loop
      and the line search's bookkeeping in numpy);
    - ``finish_s``: after the last evaluation (unscaling, the model).

    Returns ``(model, seconds, split)``."""
    import torch
    from cycloneml_tpu_torch.dataset import sparse as sp
    from cycloneml_tpu_torch.ml.optim.loss import DistributedLossFunction

    clock = time.perf_counter
    split = {"std_s": 0.0, "evals_device_s": 0.0, "loss_calls_s": 0.0,
             "evaluations": 0}
    marks = {"in_std": False, "first": None, "last": None}
    cls = sp.SparseInstanceDataset
    std0, agg0 = sp.sparse_feature_std, cls.tree_aggregate_fn
    call0 = DistributedLossFunction.__call__
    search0 = DistributedLossFunction.device_line_search

    def synced(fn, *args):
        torch.cuda.synchronize()
        t = clock()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, t, clock()

    def std(d):
        marks["in_std"] = True
        out, t, u = synced(std0, d)
        marks["in_std"] = False
        split["std_s"] += u - t
        return out

    def tree_aggregate_fn(self, fn, auto_psum=True):
        inner = agg0(self, fn, auto_psum)

        def call(*extras):
            out, t, u = synced(inner, *extras)
            if not marks["in_std"]:
                split["evals_device_s"] += u - t
                split["evaluations"] += 1
            return out

        call.compiled, call.arrays = inner.compiled, inner.arrays
        return call

    def loss_call(fn):
        def wrapped(self, *args):
            out, t, u = synced(fn, self, *args)
            marks["first"] = t if marks["first"] is None else marks["first"]
            marks["last"] = u
            split["loss_calls_s"] += u - t
            return out
        return wrapped

    sp.sparse_feature_std = std
    cls.tree_aggregate_fn = tree_aggregate_fn
    DistributedLossFunction.__call__ = loss_call(call0)
    DistributedLossFunction.device_line_search = loss_call(search0)
    try:
        torch.cuda.synchronize()
        t0 = clock()
        model, _ = _sparse_fit(ctx, ds, "auto")
        torch.cuda.synchronize()
        end = clock()
    finally:
        sp.sparse_feature_std = std0
        cls.tree_aggregate_fn = agg0
        DistributedLossFunction.__call__ = call0
        DistributedLossFunction.device_line_search = search0
    first, last = marks["first"], marks["last"]
    out = {"std_s": split["std_s"],
           "setup_other_s": first - t0 - split["std_s"],
           "evals_device_s": split["evals_device_s"],
           "evals_host_s": split["loss_calls_s"] - split["evals_device_s"],
           "optimizer_s": last - first - split["loss_calls_s"],
           "finish_s": end - last, "evaluations": split["evaluations"]}
    return model, end - t0, out


def phase_criteo():
    """Criteo-class sparse LogisticRegression at full size: the rows drawn
    on the card, the column copy built, phase_ell's checks on them, then
    ``LogisticRegression(maxIter=25, regParam=0.01).fit`` through S1 and
    S2 (three times: bitwise-equal models, the third with its host time
    taken apart by :func:`_split_fit`) and through the plain aggregator,
    on the card's float32 accumulator tier and again on the float64 tier.
    After 25 iterations short of convergence on these ill-conditioned
    hashed columns, float32 line searches that round differently part by
    ~4e-3 in single coefficients (two plain fits alone, float32 and
    float64 sums, do), so the coefficients are held to rtol 5e-3 / atol
    5e-4 on the float64 tier, and the float32 tier's kernel coefficients
    to 1e-2 absolute of the float64 plain fit's (a deterministic
    reference; the float32 plain fit's index_add_ order changes from run
    to run). The intercept, unregularized and tied to the uncentered
    dense columns, parts further on the float32 tier (1.2e-2): it is
    printed, and held on the float64 tier. The objectives are held on
    both. Returns S1's and S2's numbers and launches."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.random import generate_criteo_like
    from cycloneml_tpu_torch.ops import kernels

    ctx = _context("chip_smoke_criteo")
    try:
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ds, gen_s = _timed(lambda: generate_criteo_like(
            ctx, CRITEO_N, seed=0, hash_dim=CRITEO_D))
        ell_bytes = ds.indices.numel() * 8
        columns, sort_s = _timed(ds.columns)
        setup_peak = torch.cuda.max_memory_allocated() - base
        _, labels_s = _timed(ds.y_host)
        nnz = int(columns.col_ptr[-1])
        counts = columns.col_ptr.diff()
        _line("criteo_data", n=CRITEO_N, k=ds.k_max, d=CRITEO_D, nnz=nnz,
              ell_bytes=ell_bytes, column_copy_bytes=nnz * 8,
              largest_column=int(counts.max()),
              empty_columns=int((counts == 0).sum()),
              positive_share=float(ds.y[:CRITEO_N].mean()),
              generate_s=gen_s, column_copy_s=sort_s,
              label_readback_s=labels_s,
              setup_peak_bytes=setup_peak)
        s1, s2 = phase_ell(ds, columns)

        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        k_model, k_warm = _sparse_fit(ctx, ds, "auto")
        s1_launches = kernels.ell_rows.launches
        s2_launches = kernels.ell_cols.launches
        others = _other_launches(kernels, "ell_rows", "ell_cols")
        k_again, k_steady = _sparse_fit(ctx, ds, "auto")
        peak = torch.cuda.max_memory_allocated() - base
        k_split, split_s, split = _split_fit(ctx, ds)
        p_model, p_s = _sparse_fit(ctx, ds, "false")
        # the same two fits on the float64 accumulator tier (float64
        # coefficients, line search and plain sums; the kernels as ever)
        ctx.conf.set("cyclone.compute.dtype", "float64")
        k64, k64_s = _sparse_fit(ctx, ds, "auto")
        p64, p64_s = _sparse_fit(ctx, ds, "false")
        ks, ps = k_model.summary, p_model.summary
        kc, pc = k_model.coefficients.values, p_model.coefficients.values

        def coef_close(a, b):
            return bool(np.allclose(a.coefficients.values,
                                    b.coefficients.values, rtol=5e-3,
                                    atol=5e-4)) and \
                abs(a.intercept - b.intercept) <= 5e-4 + 5e-3 * abs(
                    b.intercept)

        def max_dcoef(a, b):
            return float(np.max(np.abs(a.coefficients.values
                                       - b.coefficients.values)))

        def obj_rel(a, b):
            fa = a.summary.objective_history[-1]
            fb = b.summary.objective_history[-1]
            return abs(fa - fb) / abs(fb)

        bitwise = all(bool(np.array_equal(kc, m.coefficients.values))
                      and k_model.intercept == m.intercept
                      for m in (k_again, k_split))
        evals = ks.total_evals
        kernel_s = evals * (s1["ms"] + s2["ms"]) / 1e3 + s2["moments_ms"] / 1e3
        margins = _sparse_margins(ds, kc, k_model.intercept)
        auc = _auc(margins, ds.y[:CRITEO_N])
        del margins
        _line("criteo_fit", iterations=ks.total_iterations, evals=evals,
              dispatches=ks.total_dispatches, s1_launches=s1_launches,
              s2_launches=s2_launches, warm_s=k_warm, steady_s=k_steady,
              kernels_s=kernel_s, host_s=k_steady - kernel_s,
              split_fit_s=split_s, split=split,
              final_objective=ks.objective_history[-1],
              plain={"iterations": ps.total_iterations,
                     "evals": ps.total_evals, "fit_s": p_s,
                     "final_objective": ps.objective_history[-1]},
              float64_tier={"kernel_fit_s": k64_s, "plain_fit_s": p64_s,
                            "kernel_evals": k64.summary.total_evals,
                            "plain_evals": p64.summary.total_evals,
                            "objective_rel_diff": obj_rel(k64, p64),
                            "max_abs_coef_diff": max_dcoef(k64, p64)},
              objective_rel_diff=obj_rel(k_model, p_model),
              max_abs_coef_diff=max_dcoef(k_model, p_model),
              max_abs_coef=float(np.max(np.abs(pc))),
              plain_f32_to_f64_max_abs_coef_diff=max_dcoef(p_model, p64),
              kernel_f32_to_plain_f64_max_abs_coef_diff=max_dcoef(k_model,
                                                                  p64),
              kernel_f32_to_plain_f64_intercept_diff=abs(
                  k_model.intercept - p64.intercept),
              plain_f32_to_f64_intercept_diff=abs(p_model.intercept
                                                  - p64.intercept),
              bitwise_equal_refit=bitwise, train_auc=auc,
              max_memory_allocated=peak, ell_bytes=ell_bytes,
              peak_over_ell=peak / ell_bytes)
        _check("criteo fit", {
            "S1 launched once per evaluation": s1_launches == evals,
            "S2 launched once per evaluation and once for the summary":
                s2_launches == evals + 1,
            "no other kernel launched": others == 0,
            "final objectives agree to 1e-4 (float32 tier)":
                obj_rel(k_model, p_model) <= 1e-4,
            "final objectives agree to 1e-4 (float64 tier)":
                obj_rel(k64, p64) <= 1e-4,
            "coefficients agree, rtol 5e-3, atol 5e-4 (float64 tier)":
                coef_close(k64, p64),
            "float32-tier kernel fit's coefficients within 1e-2 absolute "
            "of the float64 plain fit's": max_dcoef(k_model, p64) <= 1e-2,
            "the split fit's evaluations are the fit's":
                split["evaluations"] == evals,
            "three kernel fits bitwise equal": bitwise,
            "finite model": bool(np.all(np.isfinite(kc))),
            "training AUC above 0.5": auc > 0.5,
        })
        return {"s1": s1, "s2": s2, "s1_launches": s1_launches,
                "s2_launches": s2_launches}
    finally:
        ctx.stop()


def phase_config5():
    """BASELINE configuration 5: RowMatrix.compute_svd(20) by Lanczos over
    the NYTimes-shape bag of words (the reference's numpy recipe), the
    matvec S1 (Gram link) then S2; one matvec against float64, then all 20
    singular values against scipy's svds in float64 on the same CSR.
    Returns the launches."""
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    import torch
    from cycloneml_tpu_torch.dataset.random import nytimes_like
    from cycloneml_tpu_torch.dataset.sparse import SparseInstanceDataset
    from cycloneml_tpu_torch.linalg.distributed import RowMatrix
    from cycloneml_tpu_torch.ops import kernels

    ctx = _context("chip_smoke_config5")
    try:
        (idx, val), gen_s = _timed(lambda: nytimes_like(NYT_N, NYT_D, NYT_K))
        ds, ingest_s = _timed(lambda: SparseInstanceDataset.from_ell(
            ctx, idx, val, n_features=NYT_D))
        columns, sort_s = _timed(ds.columns)
        g = torch.Generator(device=ds.device).manual_seed(5)
        q = torch.randn(NYT_D, generator=g, device=ds.device)
        a = _ell_pair(ds, q, 0.0, kernels.GRAM, None, columns)
        b = _ell_pair(ds, q, 0.0, kernels.GRAM, None, columns)
        t = _ell_pair(ds, q.double(), 0.0, kernels.GRAM, None, plain=True)
        mv_err = float((a[4].double() - t[4]).abs().max() / t[4].abs().max())
        mv_bitwise = all(torch.equal(u, v) for u, v in zip(a, b))
        del a, b, t

        kernels.reset_launch_counts()
        res, svd_s = _timed(lambda: RowMatrix(ds).compute_svd(
            NYT_SV, max_gram_dim=4096, tol=1e-9, max_iter=300))
        steps = kernels.ell_rows.launches_by_link[kernels.GRAM]
        s1, s2 = kernels.ell_rows.launches, kernels.ell_cols.launches
        others = _other_launches(kernels, "ell_rows", "ell_cols")
        sig = res.s.to_array()
        rows = np.repeat(np.arange(NYT_N), NYT_K)
        csr = sp.csr_matrix((val.reshape(-1).astype(np.float64),
                             (rows, idx.reshape(-1))), shape=(NYT_N, NYT_D))
        t0 = time.perf_counter()
        ref = np.sort(spla.svds(csr, k=NYT_SV,
                                return_singular_vectors=False))[::-1]
        scipy_s = time.perf_counter() - t0
        rel = np.abs(sig[:NYT_SV] - ref) / ref if sig.size == NYT_SV \
            else np.full(NYT_SV, np.inf)
        _line("config5", n=NYT_N, d=NYT_D, k_slots=NYT_K, nnz=NYT_N * NYT_K,
              singular_values=NYT_SV, reduced=None, generate_s=gen_s,
              ingest_s=ingest_s, column_copy_s=sort_s,
              matvec_rel_err=mv_err, matvec_bitwise_equal=mv_bitwise,
              lanczos_steps=steps, s1_launches=s1, s2_launches=s2,
              svd_s=svd_s, scipy_s=scipy_s, sigma_top5=sig[:5].tolist(),
              rel_err_by_index=rel.tolist(), max_rel_err=float(rel.max()))
        _check("config5", {
            "one matvec within 1e-4 of float64": mv_err <= 1e-4,
            "two matvecs bitwise equal": mv_bitwise,
            "S1 (Gram link) and S2 launched once per Lanczos step":
                s1 == steps and s2 == steps and steps > 0,
            "no other kernel launched": others == 0,
            "20 singular values within 5e-3 of scipy's": bool(
                rel.max() <= 5e-3),
        })
        return {"s1_launches": s1, "s2_launches": s2}
    finally:
        ctx.stop()


def phase_rowmatrix():
    """The rest of RowMatrix on phase 10's spectrum data: Lanczos
    (compute_svd(10, max_gram_dim=1024)) against the Gramian branch,
    multiply by a seeded 2,000 x 64 matrix against float64, and
    column_similarities against the float64 Gramian's cosines."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.linalg.distributed import RowMatrix
    from cycloneml_tpu_torch.linalg.matrices import Matrices
    from cycloneml_tpu_torch.ops import kernels

    ctx = _context("chip_smoke_rowmatrix")
    try:
        ds, _ = _spectrum_dataset(ctx, GRAM_N, GRAM_D, seed=9)
        rm = RowMatrix(ds)
        kernels.reset_launch_counts()
        gram, gram_s = _timed(lambda: rm.compute_svd(10))
        steps = []
        base_fn = rm._gram_matvec_fn

        def counted():
            matvec, dt = base_fn()

            def mv(q):
                steps.append(1)
                return matvec(q)
            return mv, dt

        rm._gram_matvec_fn = counted
        lan, lan_s = _timed(lambda: rm.compute_svd(10, max_gram_dim=1024))
        s_rel = float(np.max(np.abs(lan.s.to_array() - gram.s.to_array())
                             / gram.s.to_array()))
        b = np.random.RandomState(64).randn(GRAM_D, MULTIPLY_COLS)
        prod, mult_s = _timed(lambda: rm.multiply(Matrices.from_array(b)))
        bt = torch.as_tensor(b, device=ds.x.device)
        err = scale = 0.0
        g64 = torch.zeros((GRAM_D, GRAM_D), dtype=torch.float64,
                          device=ds.x.device)
        for lo in range(0, GRAM_N, ROWS64):
            x64 = ds.x[lo:lo + ROWS64].double()
            t = x64 @ bt
            err = max(err, float((prod.dataset.x[lo:lo + ROWS64].double()
                                  - t).abs().max()))
            scale = max(scale, float(t.abs().max()))
            g64 += x64.T @ x64
        del x64, t
        sims, sim_s = _timed(rm.column_similarities)
        g64 = g64.cpu().numpy()
        norms = np.sqrt(np.diag(g64))
        cos64 = np.triu(g64 / norms[:, None] / norms[None, :], 1)
        sim_err = float(np.max(np.abs(sims.to_array() - cos64)))
        k4 = kernels.gramian.launches
        others = _other_launches(kernels, "gramian")
        _line("rowmatrix", n=GRAM_N, d=GRAM_D, gramian_svd_s=gram_s,
              lanczos_svd_s=lan_s, lanczos_steps=len(steps),
              sigma_rel_diff=s_rel, multiply_s=mult_s,
              multiply_max_abs_err=err, multiply_max_abs=scale,
              column_similarities_s=sim_s, similarity_max_abs_err=sim_err,
              k4_launches=k4)
        _check("rowmatrix", {
            "Lanczos singular values within 1e-4 of the Gramian branch's":
                s_rel <= 1e-4,
            "multiply within 1e-5 of max|X B| of float64":
                err <= 1e-5 * scale,
            "column similarities within 1e-5 of float64": sim_err <= 1e-5,
            "K4 launched once per Gramian (SVD, similarities)": k4 == 2,
            "no other kernel launched": others == 0,
        })
    finally:
        ctx.stop()


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import cycloneml_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run it from a checkout: the cycloneml_tpu_torch "
              "package is not beside this script", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    card, kind = phase_card()
    ptxas = phase_build()
    entries = []

    def entry(name, source, replaces, numbers, launches, **extra):
        entries.append({
            "name": name, "route": "cuda",
            "source": f"cycloneml_tpu_torch/csrc/{source}.cu",
            "replaces": replaces if isinstance(replaces, str)
            else f"cycloneml_tpu/ops/kernels.py:{replaces}",
            "launches": launches, "max_abs_err": numbers["max_abs_err"],
            "ms": numbers["ms"], "plain_ms": numbers["plain_ms"],
            "bound_ms": numbers["bound_ms"],
            "bound_by": numbers["bound_by"],
            "library_ms": numbers.get("library_ms"),
            "yardstick_ms": numbers.get("yardstick_ms"), "card": card,
            **extra})

    def redesigned(numbers, *kernels_run, how="tensor cores, wgmma"):
        """The fields of a kernel redesigned for the tensor cores: the
        redesign, its f32-FMA bound and rate reference, and ptxas's lines
        for the kernels it runs."""
        keep = ("f32_fma_bound_ms", "library_bf16_rate_ms", "instance")
        return {"redesigned": how,
                **{k: numbers[k] for k in keep if k in numbers},
                "ptxas": {f: ptxas.get(f) for f in ptxas
                          if f.startswith(kernels_run)}}

    def sweep(numbers, dtype, d, link, how=None):
        """The fields of a GLM sweep entry: the main shape's instance, its
        ring plan and ptxas's lines, and the redesign where it was one."""
        inst = f"glm_sweep_kernel<{dtype}, E={8 * -(-d // 256)}, {link}>"
        out = {"instance": inst, **numbers["plan"],
               "ptxas": {f: ptxas.get(f) for f in ptxas if f == inst}}
        return {**out, "redesigned": how} if how else out

    ring = "per-lane cp.async row ring, gradient summed in row blocks"
    k1 = phase_kernel()
    entry("glm_sweep (logistic, K1)", "glm_sweep", 270, k1, phase_fit(),
          **sweep(k1, "bf16", FIT_D, "logistic"))
    k2 = phase_k2()
    k2_launches, k2_objective = phase_linreg()
    entry("glm_sweep (squared, K2)", "glm_sweep", 226, k2, k2_launches,
          **sweep(k2, "bf16", LIN_D, "squared", ring))
    k3 = phase_k3()
    km_launches, sum_launches, sums = phase_kmeans()
    entry("kmeans_assign (K3)", "kmeans_assign", 384, k3, km_launches,
          **redesigned(k3, "kmeans_assign_tc_kernel<bf16",
                       "kmeans_redecide_kernel<bf16"))
    k4 = phase_k4()
    entry("gramian (K4)", "gramian", 461, k4, phase_pca(),
          **redesigned(k4, "gramian_tc_kernel<bf16",
                       "gramian_reduce_kernel"))
    # the fp8 rung: e4m3 codes with the x_scale operand (:309, :422, :501)
    k1 = phase_kernel(fp8=True)
    entry("glm_sweep (logistic, K1, e4m3)", "glm_sweep", 309, k1,
          phase_fp8_fit(), **sweep(k1, "e4m3", FIT_D, "logistic", ring))
    k2 = phase_k2(fp8=True)
    entry("glm_sweep (squared, K2, e4m3)", "glm_sweep", 309, k2,
          phase_fp8_linreg(), **sweep(k2, "e4m3", LIN_D, "squared", ring))
    # KMeans and PCA are not fp8-capable (they take the bf16 rung under the
    # fp8 tiers), so no fit launches these two instances: their wrappers
    # are held at the fits' shapes above, and their launches are 0
    no_path = {"main_path": "none: KMeans and RowMatrix/PCA take the bf16 "
               "rung under the fp8 tiers"}
    k3 = phase_k3(fp8=True)
    entry("kmeans_assign (K3, e4m3)", "kmeans_assign", 422, k3, 0,
          **no_path, **redesigned(k3, "kmeans_assign_tc_kernel<e4m3",
                                  "kmeans_redecide_kernel<e4m3"))
    k4 = phase_k4(fp8=True)
    entry("gramian (K4, e4m3)", "gramian", 501, k4, 0, **no_path,
          **redesigned(k4, "gramian_tc_kernel<e4m3",
                       "gramian_reduce_kernel"))
    # the stacked slice: K1s, OneVsRest and CrossValidator through it
    k1s = phase_k1s()
    ovr_launches, ovr8_launches, ovr_models = phase_ovr()
    entry("glm_sweep_stacked (logistic, K models, K1s)", "glm_stacked", 270,
          k1s, ovr_launches, models=OVR_K,
          vmapped_by="cycloneml_tpu/ml/optim/aggregators.py:394",
          cv_fit_launches=phase_cv(),
          yardstick="K serial launches of K1",
          yardstick_two_f32_gemm_ms=k1s["yardstick_two_f32_gemm_ms"],
          **redesigned(k1s, "glm_stacked_tc_kernel<bf16",
                       how="tensor cores, mma.sync"))
    k1s8 = phase_k1s(fp8=True)
    entry("glm_sweep_stacked (K1s, e4m3)", "glm_stacked", 309, k1s8,
          ovr8_launches, models=OVR_K,
          yardstick="K serial launches of K1 (e4m3)",
          yardstick_two_f32_gemm_ms=k1s8["yardstick_two_f32_gemm_ms"],
          **redesigned(k1s8, "glm_stacked_tc_kernel<e4m3",
                       how="tensor cores, mma.sync"))
    entry("center_sums (KMeans center update)", "center_sums",
          "cycloneml_tpu/ml/clustering/kmeans.py:122", sums, sum_launches,
          note="jax.ops.segment_sum of the Lloyd step, not a Pallas "
               "kernel; library_ms is the index_add_ update it replaced")
    # the rest of the dense linear family: no new kernel; K1 carries the
    # bounded fit, the other four paths launch none
    phase_wls(k2_objective)
    entries[0]["bounded_fit_launches"] = phase_bounded()   # K1's entry
    phase_multinomial(ovr_models)
    phase_svc()
    phase_glm()
    # the sparse tier: S1 and S2 carry the Criteo-class fit (the main
    # path) and configuration 5's Lanczos matvec
    crit = phase_criteo()
    nyt = phase_config5()
    phase_rowmatrix()
    sparse = "cycloneml_tpu/ml/optim/sparse_aggregators.py"
    ell_ptxas = {f: ptxas.get(f) for f in ptxas if f.startswith("ell_")}
    entry("ell_rows (S1, the sparse row pass)", "ell_sweep",
          f"{sparse}:34", crit["s1"], crit["s1_launches"],
          config5_launches=nyt["s1_launches"], ptxas=ell_ptxas,
          bound_with_sector_gathers_ms=crit["s1"][
              "bound_with_sector_gathers_ms"],
          yardstick="cuSPARSE CSR SpMV X beta (the margins alone)",
          note="jnp.take gathers and the link, not a Pallas kernel")
    entry("ell_cols (S2, the sparse column pass)", "ell_sweep",
          f"{sparse}:40", crit["s2"], crit["s2_launches"],
          config5_launches=nyt["s2_launches"],
          moments_ms=crit["s2"]["moments_ms"],
          bound_with_sector_gathers_ms=crit["s2"][
              "bound_with_sector_gathers_ms"],
          note="jax.ops.segment_sum, not a Pallas kernel; library_ms is "
               "cuSPARSE CSR SpMV X^T r over the column copy")
    print(json.dumps({"kernels": entries}), flush=True)
    _line("wall", seconds=time.perf_counter() - t_start)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
