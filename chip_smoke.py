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
   bound, and a yardstick of two cuBLAS gemvs the port never calls;
4. LogisticRegression: ``LogisticRegression(maxIter=25, regParam=0.01,
   tol=0.0).fit`` on data generated on the card at bench.py's shape (bf16
   tier, seed 0), through K1 (usePallasKernels=auto) and through the plain
   aggregator (false). K1 must be launched exactly ``total_evals`` times;
   each fit runs 25 iterations or stops on an exact float32 stall; the
   models agree within the reference's kernel-vs-plain bound (rtol 5e-3,
   atol 5e-4) and their final objectives to 1e-4;
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
   dtype, and at K=1 K1s against K1 under the same bounds; times at
   every K beside the plain version, the bound and two yardsticks the
   port never calls (K serial K1 launches, two cuBLAS f32 GEMMs);
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
19. a ``{"kernels": [...]}`` JSON line with K1-K4, K1s, their e4m3
   instances and the center sums (K3 and K4 marked as redesigned for the
   tensor cores, with their f32 FMA bounds and ptxas lines), the total
   wall time; the last line is ``{"ok": true, "device": {...}}``.

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
                  "center_sums"]
K1S_MODELS = (1, 3, 8, 16, 20)   # 20 > K_MAX: two launches of K1s
OVR_K = 8                        # OneVsRest's classes (bench_ovr_stacked)
CV_N = 500_000                   # CrossValidator's rows (the cut of FIT_N)
CV_REGS = (0.001, 0.01, 0.1)
DEVICE = "cuda"
ROWS = 1 << 18               # rows generated or checked at a time


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
    columns per thread and models per launch; center_piece_kernel: w's
    dtype; gramian_tc_kernel: the staging; kmeans_assign_tc_kernel:
    whether X is resident)."""
    m = re.search(r"([a-z_]+_kernel)(I(13__nv_bfloat16|13__nv_fp8_e4m3|f|d)"
                  r"(f|d)?((?:L[ib]\d+E)*))?", mangled)
    if m is None:
        return mangled
    if m.group(2) is None:
        return m.group(1)
    names = {"f": "f32", "d": "f64", "13__nv_bfloat16": "bf16",
             "13__nv_fp8_e4m3": "e4m3"}
    args = [names[m.group(3)]]
    if m.group(4):  # a second type: the center sums' w
        args.append("w " + names[m.group(4)])
    ints = re.findall(r"Li(\d+)E", m.group(5))
    if len(ints) == 2 and m.group(1) == "glm_stacked_kernel":
        args += [f"C={ints[0]}", f"KG={ints[1]}"]
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
    _line("k1_time", n=n, d=d, dtype=dt, kernel_ms=k_ms, plain_ms=p_ms,
          bound_ms=bound, bound_by=bound_by, yardstick_two_gemv_ms=yard_ms,
          achieved_gb_s=n_bytes / k_ms / 1e6)
    if n == FIT_N and x.dtype == main_dt:
        return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                "bound_by": bound_by, "yardstick_ms": yard_ms}
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
              "center_sums": kernels.center_sums.launches}
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
    _line("k2_time", n=n, d=d, dtype=dt, kernel_ms=k_ms, plain_ms=p_ms,
          bound_ms=bound, bound_by=bound_by, yardstick_two_gemv_ms=yard_ms,
          achieved_gb_s=n_bytes / k_ms / 1e6)
    if n == LIN_N and x.dtype == main_dt:
        return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                "bound_by": bound_by, "yardstick_ms": yard_ms}
    return {}


def phase_linreg():
    """LinearRegression at configuration 2 through K2 and through the
    plain aggregator; returns K2's launches in the K2 fit."""
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
                      "evals": ks.total_evals, "k2_launches": launches,
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
        return launches
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
            for k in K1S_MODELS:
                yk = ys[:, :k]
                groups = -(-k // kernels.K_MAX)
                for centered in (False, True):
                    m = mu if centered else torch.zeros_like(mu)
                    before = kernels.glm_sweep_stacked.launches_by_dtype[
                        dtype]
                    got = kernels.fused_binary_logistic_stacked_scaled(
                        x, yk, w, inv_std, m, coef[:k], d, x_scale=s32)
                    again = kernels.fused_binary_logistic_stacked_scaled(
                        x, yk, w, inv_std, m, coef[:k], d, x_scale=s32)
                    torch.cuda.synchronize()
                    launched = kernels.glm_sweep_stacked.launches_by_dtype[
                        dtype] - before == 2 * groups
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
    bound, bound_by = _bound(n_bytes, 4.0 * n * d * k)
    _line("k1s_time", n=n, d=d, k=k, dtype=_dt(x), kernel_ms=k_ms,
          plain_ms=p_ms, bound_ms=bound, bound_by=bound_by,
          yardstick_serial_k1_ms=serial_ms,
          yardstick_two_f32_gemm_ms=gemm_ms,
          achieved_gb_s=n_bytes / k_ms / 1e6,
          achieved_tflop_s=4.0 * n * d * k / k_ms / 1e9,
          share_of_bound=bound / k_ms)
    if x.dtype == main_dt and k == OVR_K:
        return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                "bound_by": bound_by, "yardstick_ms": serial_ms,
                "yardstick_two_f32_gemm_ms": gemm_ms}
    return {}


def _ovr_margins(ds, models):
    """The OvR margins' argmax over the real rows, on the card."""
    import numpy as np
    import torch
    w_mat = torch.as_tensor(
        np.stack([m.coefficients.values for m in models]),
        dtype=torch.float32, device=ds.x.device).t().contiguous()
    b = torch.as_tensor([m.intercept for m in models], dtype=torch.float32,
                        device=ds.x.device)
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
    and e4m3 launches in their stacked fits."""
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
        groups = -(-OVR_K // kernels.K_MAX)
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
        others8 = _other_launches(kernels, "glm_stacked")
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
            "K1s launched once per stacked evaluation (x groups)":
                k1s[ds.x.dtype] == stacked_evals * groups
                and sum(k1s.values()) == k1s[ds.x.dtype],
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
            "instance": k1s8[torch.float8_e4m3fn] == f_evals * groups
                and sum(k1s8.values()) == k1s8[torch.float8_e4m3fn]
                and others8 == 0,
        })
        return k1s[ds.x.dtype], k1s8[torch.float8_e4m3fn]
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

    def redesigned(numbers, *kernels_run):
        """The fields of a kernel redesigned for the tensor cores: the
        redesign, its f32-FMA bound and rate reference, and ptxas's lines
        for the kernels it runs."""
        keep = ("f32_fma_bound_ms", "library_bf16_rate_ms")
        return {"redesigned": "PR 4",
                **{k: numbers[k] for k in keep if k in numbers},
                "ptxas": {f: ptxas.get(f) for f in ptxas
                          if f.startswith(kernels_run)}}

    k1 = phase_kernel()
    entry("glm_sweep (logistic, K1)", "glm_sweep", 270, k1, phase_fit())
    k2 = phase_k2()
    entry("glm_sweep (squared, K2)", "glm_sweep", 226, k2, phase_linreg())
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
          phase_fp8_fit())
    k2 = phase_k2(fp8=True)
    entry("glm_sweep (squared, K2, e4m3)", "glm_sweep", 309, k2,
          phase_fp8_linreg())
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
    ovr_launches, ovr8_launches = phase_ovr()
    entry("glm_sweep_stacked (logistic, K models, K1s)", "glm_stacked", 270,
          k1s, ovr_launches, models=OVR_K,
          vmapped_by="cycloneml_tpu/ml/optim/aggregators.py:394",
          cv_fit_launches=phase_cv(),
          yardstick="K serial launches of K1",
          yardstick_two_f32_gemm_ms=k1s["yardstick_two_f32_gemm_ms"])
    k1s8 = phase_k1s(fp8=True)
    entry("glm_sweep_stacked (K1s, e4m3)", "glm_stacked", 309, k1s8,
          ovr8_launches, models=OVR_K,
          yardstick="K serial launches of K1 (e4m3)",
          yardstick_two_f32_gemm_ms=k1s8["yardstick_two_f32_gemm_ms"])
    entry("center_sums (KMeans center update)", "center_sums",
          "cycloneml_tpu/ml/clustering/kmeans.py:122", sums, sum_launches,
          note="jax.ops.segment_sum of the Lloyd step, not a Pallas "
               "kernel; library_ms is the index_add_ update it replaced")
    print(json.dumps({"kernels": entries}), flush=True)
    _line("wall", seconds=time.perf_counter() - t_start)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
