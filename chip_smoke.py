#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cycloneml_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing lines of its own; any failure exits non-zero without
the final result line:

1. the card: name and power limit (nvidia-smi), torch device name, count;
2. the build of every kernel from ``cycloneml_tpu_torch/csrc`` (one nvcc per
   source, started together), with each kernel's registers, shared memory
   and spills from ``-Xptxas -v``;
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
   same scale, two launches bitwise equal; times beside the plain f32
   version, the bound, and a yardstick of the chunked f32 product x c^T
   with TF32 off;
8. KMeans at configuration 3 (``RandomDatasets.normal(seed=12)``, 10M x
   128, bf16 tier; ``k=1000, maxIter=10, tol=1e-5, seed=3``) through K3 and
   through the plain assignment: K3 launched exactly Lloyd steps +
   k-means|| passes times, training costs to 1e-4 relative; and one Lloyd
   step from identical initial centers, max|dcenter| <= 1e-4 max|center|;
9. K4 (the Gramian) against its plain version in float64 (row chunks) at
   400,000 x 2,000 (bf16 and f32) and at a ragged shape with a third of the
   rows masked by w = 0: |dG_ij| <= 1e-4 sqrt(G_ii G_jj), G == G^T
   bitwise, two launches bitwise equal; times beside the plain f32
   version, the bound and the library call x^T x (f32, TF32 off);
10. PCA: ``PCA(k=10).fit`` and ``RowMatrix.compute_svd(k=10)`` on data
   with a known spectrum, X = (Z diag(s)) Q^T at 400,000 x 2,000 (bf16 tier,
   s_j = (j+1)^-1/2, Q orthogonal from a float64 QR), through K4 and
   through the plain Gramian: K4 launched once per Gramian, |cos| between
   matched components >= 1 - 1e-6, explained variance and singular values
   to 1e-5 relative; both against Q[:, :10] (min |cos| printed, >= 0.99);
11. a ``{"kernels": [...]}`` JSON line with K1-K4, the total wall time;
   the last line is ``{"ok": true, "device": {...}}``.

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
KERNEL_SOURCES = ["glm_sweep", "kmeans_assign", "gramian"]
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
    """A readable name for a mangled kernel instance: its X dtype and
    integer template arguments (glm_sweep_kernel: elements per lane and
    the link, 0 logistic, 1 squared)."""
    m = re.search(r"([a-z_]+_kernel)(I(13__nv_bfloat16|f)((?:Li\d+E)*))?",
                  mangled)
    if m is None:
        return mangled
    if m.group(2) is None:
        return m.group(1)
    args = ["f32" if m.group(3) == "f" else "bf16"]
    ints = re.findall(r"Li(\d+)E", m.group(4))
    if len(ints) == 2:
        args += [f"E={ints[0]}", ("logistic", "squared")[int(ints[1])]]
    return f"{m.group(1)}<{', '.join(args)}>"


def phase_build():
    from cycloneml_tpu_torch.ops import build
    t0 = time.perf_counter()
    build.build_all(KERNEL_SOURCES)
    secs = time.perf_counter() - t0
    for name in KERNEL_SOURCES:
        report = build.ptxas_report(name)
        func = None
        # the report of the build that made the library
        text = report.read_text() if report.exists() else ""
        for ln in text.splitlines():
            if "Compiling entry function" in ln:
                func = _kernel_name(ln.split("'")[1] if "'" in ln else ln)
            elif func and ("registers" in ln or "spill" in ln):
                print(f"ptxas {name} {func}: {ln.split(':')[-1].strip()}")
    _line("build", sources=KERNEL_SOURCES, seconds=round(secs, 2))


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


def _fold_truth(x, y, w, inv_std, mu, coef, d):
    """The scaled sweep in float64 through the plain version."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    c = coef.double()
    beta = inv_std.double() * c[:d]
    off = c[d] - torch.dot(mu.double(), c[:d])
    loss, g, msum, wsum = kernels.glm_sweep_plain(
        x, y, w, beta, off, acc_dtype=torch.float64)
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


def _bound(n_bytes, flops, peak_flops=H100_F32_FLOPS):
    """(bound ms, what bounds it): the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    t_b, t_o = n_bytes / H100_BYTES_PER_S, flops / peak_flops
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def phase_kernel():
    """K1 against its plain version; returns the main-shape (bf16)
    numbers for the kernels line."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    results = {}
    for n, d, seed in ((FIT_N, FIT_D, 1), (RAGGED_N, RAGGED_D, 2)):
        x32, y, w, coef, inv_std, mu = _k1_inputs(n, d, seed)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32 if dtype == torch.float32 else x32.to(torch.bfloat16)
            for centered in (False, True):
                m = mu if centered else torch.zeros_like(mu)
                got = kernels.fused_binary_logistic_scaled(
                    x, y, w, inv_std, m, coef, d)
                again = kernels.fused_binary_logistic_scaled(
                    x, y, w, inv_std, m, coef, d)
                torch.cuda.synchronize()
                t_loss, t_grad, t_w = _fold_truth(x, y, w, inv_std, m,
                                                  coef, d)
                rel_loss = abs(float(got["loss"]) - float(t_loss)) \
                    / abs(float(t_loss))
                err = float((got["grad"].double() - t_grad).abs().max())
                gmax = float(t_grad.abs().max())
                bitwise = all(torch.equal(got[k], again[k])
                              for k in ("loss", "grad", "count"))
                ok = (rel_loss <= 1e-5 and err <= 1e-4 * gmax
                      and float(got["count"]) == n and float(t_w) == n
                      and bitwise)
                _line("k1_check", n=n, d=d, dtype=str(dtype)[6:],
                      centered=centered, rel_loss=rel_loss,
                      max_abs_grad_err=err, max_abs_grad=gmax,
                      count=float(got["count"]), bitwise_equal=bitwise,
                      ok=ok)
                if not ok:
                    raise AssertionError(f"K1 disagrees with its plain "
                                         f"version at n={n} d={d} {dtype}")
                if n == FIT_N and dtype == torch.bfloat16:
                    results["max_abs_err"] = max(
                        results.get("max_abs_err", 0.0), err)
            results.update(_k1_times(x, y, w, coef, inv_std, d, n))
            del x
        del x32
        torch.cuda.empty_cache()
    return results


def _k1_times(x, y, w, coef, inv_std, d, n):
    import torch
    from cycloneml_tpu_torch.ops import kernels
    beta = inv_std * coef[:d]
    off = coef[d]
    dt = str(x.dtype)[6:]
    k_ms = _time_ms(lambda: kernels.glm_sweep(x, y, w, beta, off), 20, 3)
    p_ms = _time_ms(lambda: kernels.glm_sweep_plain(x, y, w, beta, off),
                    3, 1)
    # yardstick: the sweep's two gemvs in cuBLAS at X's dtype
    xb = beta.to(x.dtype)
    mult = (w * (torch.sigmoid(torch.mv(x, xb).float() + off) - y)).to(x.dtype)
    yard_ms = _time_ms(lambda: (torch.mv(x, xb), torch.mv(x.t(), mult)),
                       10, 2)
    n_bytes = n * d * x.element_size() + 2 * n * 4 + d * 4 + (d + 3) * 4
    bound, bound_by = _bound(n_bytes, 4.0 * n * d)
    _line("k1_time", n=n, d=d, dtype=dt, kernel_ms=k_ms, plain_ms=p_ms,
          bound_ms=bound, bound_by=bound_by, yardstick_two_gemv_ms=yard_ms,
          achieved_gb_s=n_bytes / k_ms / 1e6)
    if n == FIT_N and dt == "bfloat16":
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


def _other_launches(kernels, own: str) -> int:
    """Launches of every kernel but ``own`` since the last reset."""
    counts = {"logistic": kernels.glm_sweep.launches_by_link["logistic"],
              "squared": kernels.glm_sweep.launches_by_link["squared"],
              "kmeans_assign": kernels.kmeans_assign.launches,
              "gramian": kernels.gramian.launches}
    return sum(v for k, v in counts.items() if k != own)


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


# -- K2 and LinearRegression ---------------------------------------------------

def phase_k2():
    """K2 against its plain version in float64; returns the main-shape
    (bf16) numbers for the kernels line."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    results = {}
    for n, d, seed in ((LIN_N, LIN_D, 3), (RAGGED_N, RAGGED_D, 4)):
        g = torch.Generator(device=DEVICE).manual_seed(seed)
        x32 = _randn(n, d, g)
        y = torch.randn(n, generator=g, device=DEVICE) * 3 + 1
        w = torch.ones(n, device=DEVICE)
        coef = torch.randn(d, generator=g, device=DEVICE) / d ** 0.5
        inv_std = torch.rand(d, generator=g, device=DEVICE) + 0.5
        for dtype in (torch.float32, torch.bfloat16):
            x = x32 if dtype == torch.float32 else x32.to(torch.bfloat16)
            for centered in (False, True):
                mu = (torch.randn(d, generator=g, device=DEVICE) * 0.5
                      if centered else torch.zeros(d, device=DEVICE))
                y_pars = torch.tensor([0.4, 0.3 if centered else 0.0],
                                      device=DEVICE)
                got = kernels.fused_least_squares_scaled(
                    x, y, w, inv_std, mu, y_pars, coef, d)
                again = kernels.fused_least_squares_scaled(
                    x, y, w, inv_std, mu, y_pars, coef, d)
                torch.cuda.synchronize()
                c, s, m, yp = (t.double() for t in (coef, inv_std, mu,
                                                     y_pars))
                t_loss, t_g, t_m, t_w = kernels.glm_sweep_plain(
                    x, y, w, s * c, yp[1] - torch.dot(m, c),
                    acc_dtype=torch.float64, link=kernels.SQUARED, ys=yp[0])
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
                _line("k2_check", n=n, d=d, dtype=str(dtype)[6:],
                      centered=centered, rel_loss=rel_loss,
                      max_abs_grad_err=err, max_abs_grad=gmax,
                      count=float(got["count"]), bitwise_equal=bitwise,
                      ok=ok)
                if not ok:
                    raise AssertionError(f"K2 disagrees with its plain "
                                         f"version at n={n} d={d} {dtype}")
                if n == LIN_N and dtype == torch.bfloat16:
                    results["max_abs_err"] = max(
                        results.get("max_abs_err", 0.0), err)
            results.update(_k2_times(x, y, w, coef, inv_std, n, d))
            del x
        del x32
        torch.cuda.empty_cache()
    return results


def _k2_times(x, y, w, coef, inv_std, n, d):
    import torch
    from cycloneml_tpu_torch.ops import kernels
    beta, off, ys = inv_std * coef, 0.1, 0.4
    sq = kernels.SQUARED
    k_ms = _time_ms(lambda: kernels.glm_sweep(x, y, w, beta, off, link=sq,
                                              ys=ys), 20, 3)
    p_ms = _time_ms(lambda: kernels.glm_sweep_plain(x, y, w, beta, off,
                                                    link=sq, ys=ys), 3, 1)
    xb = beta.to(x.dtype)
    mult = (w * (torch.mv(x, xb).float() + off - ys * y)).to(x.dtype)
    yard_ms = _time_ms(lambda: (torch.mv(x, xb), torch.mv(x.t(), mult)),
                       10, 2)
    n_bytes = n * d * x.element_size() + 2 * n * 4 + d * 4 + (d + 3) * 4
    bound, bound_by = _bound(n_bytes, 4.0 * n * d)
    dt = str(x.dtype)[6:]
    _line("k2_time", n=n, d=d, dtype=dt, kernel_ms=k_ms, plain_ms=p_ms,
          bound_ms=bound, bound_by=bound_by, yardstick_two_gemv_ms=yard_ms,
          achieved_gb_s=n_bytes / k_ms / 1e6)
    if n == LIN_N and dt == "bfloat16":
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


# -- K3 and KMeans -------------------------------------------------------------

def phase_k3():
    """K3 against its plain version in float64; returns the main-shape
    (bf16) numbers for the kernels line."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    results = {}
    for n, d, k, seed in ((KM_N, KM_D, KM_K, 5), (*KM_RAGGED, 6)):
        g = torch.Generator(device=DEVICE).manual_seed(seed)
        x32 = _randn(n, d, g)
        c = torch.randn(k, d, generator=g, device=DEVICE)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32 if dtype == torch.float32 else x32.to(torch.bfloat16)
            best, dist = kernels.kmeans_assign(x, c)
            best2, dist2 = kernels.kmeans_assign(x, c)
            torch.cuda.synchronize()
            bitwise = torch.equal(best, best2) and torch.equal(dist, dist2)
            b64, d64 = kernels.kmeans_assign_plain(x, c, torch.float64)
            c64 = c.double()
            differ = worst_pick = worst_dist = max_err = 0.0
            for lo in range(0, n, ROWS):
                xc = x[lo:lo + ROWS].double()
                bc, tc = best[lo:lo + ROWS].long(), d64[lo:lo + ROWS]
                scale = torch.maximum(tc, (xc * xc).sum(1))
                picked = ((xc - c64[bc]) ** 2).sum(1)
                differ += int((bc != b64[lo:lo + ROWS]).sum())
                worst_pick = max(worst_pick,
                                 float(((picked - tc) / scale).max()))
                e = (dist[lo:lo + ROWS].double() - tc).abs()
                worst_dist = max(worst_dist, float((e / scale).max()))
                max_err = max(max_err, float(e.max()))
            ok = (worst_pick <= 1e-5 and worst_dist <= 1e-4 and bitwise
                  and int(best.max()) < k and int(best.min()) >= 0)
            _line("k3_check", n=n, d=d, k=k, dtype=str(dtype)[6:],
                  argmin_differs_at=int(differ),
                  worst_pick_excess_rel=worst_pick,
                  worst_dist_err_rel=worst_dist, max_abs_dist_err=max_err,
                  bitwise_equal=bitwise, ok=ok)
            if not ok:
                raise AssertionError(f"K3 disagrees with its plain version "
                                     f"at n={n} d={d} k={k} {dtype}")
            del b64, d64
            if n == KM_N and dtype == torch.bfloat16:
                results["max_abs_err"] = max_err
            results.update(_k3_times(x, c, n, d, k))
            del x
        del x32
        torch.cuda.empty_cache()
    return results


def _k3_times(x, c, n, d, k):
    import torch
    from cycloneml_tpu_torch.ops import kernels
    k_ms = _time_ms(lambda: kernels.kmeans_assign(x, c), 3, 1)
    p_ms = _time_ms(lambda: kernels.kmeans_assign_plain(x, c), 2, 1)
    ct = c.t().contiguous()

    def product():  # the distance product alone, f32 with TF32 off
        for lo in range(0, n, ROWS):
            x[lo:lo + ROWS].float() @ ct
    yard_ms = _time_ms(product, 3, 1)
    n_bytes = n * d * x.element_size() + k * d * 4 + k * 4 + n * 8
    bound, bound_by = _bound(n_bytes, 2.0 * n * k * d)
    dt = str(x.dtype)[6:]
    _line("k3_time", n=n, d=d, k=k, dtype=dt, kernel_ms=k_ms,
          plain_ms=p_ms, bound_ms=bound, bound_by=bound_by,
          yardstick_f32_product_ms=yard_ms,
          achieved_tflop_s=2.0 * n * k * d / k_ms / 1e9)
    if n == KM_N and dt == "bfloat16":
        return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                "bound_by": bound_by, "yardstick_ms": yard_ms}
    return {}


def phase_kmeans():
    """KMeans at configuration 3 through K3 and through the plain
    assignment; returns K3's launches in the K3 fit."""
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
        others = _other_launches(kernels, "kmeans_assign")
        p_model, p_s = fit("false")
        peak = torch.cuda.max_memory_allocated()
        cost_rel = abs(k_model.training_cost - p_model.training_cost) \
            / abs(p_model.training_cost)
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
                      "k3_launches": launches, "fit_s": k_s,
                      "training_cost": k_model.training_cost},
              plain={"iterations": p_model.num_iterations,
                     "init_passes": p_model.init_distance_passes,
                     "fit_s": p_s, "training_cost": p_model.training_cost},
              cost_rel_diff=cost_rel, one_step_max_center_diff=step_diff,
              one_step_max_center=step_scale, max_memory_allocated=peak)
        _check("kmeans fit", {
            "K3 launched once per Lloyd step and k-means|| pass":
                launches == k_model.num_iterations
                + k_model.init_distance_passes,
            "no other kernel launched": others == 0,
            "training costs agree to 1e-4": cost_rel <= 1e-4,
            "one Lloyd step agrees (1e-4 of max|center|)":
                step_diff <= 1e-4 * step_scale,
            "finite centers": bool(np.all(np.isfinite(
                k_model.cluster_centers_matrix().to_array()))),
        })
        return launches
    finally:
        ctx.stop()


# -- K4 and PCA ----------------------------------------------------------------

def phase_k4():
    """K4 against its plain version in float64; returns the main-shape
    (bf16) numbers for the kernels line."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    results = {}
    for n, d, masked, seed in ((GRAM_N, GRAM_D, False, 7),
                               (*GRAM_RAGGED, True, 8)):
        g = torch.Generator(device=DEVICE).manual_seed(seed)
        x32 = _randn(n, d, g)
        w = ((torch.arange(n, device=DEVICE) % 3 != 2).float() if masked
             else torch.ones(n, device=DEVICE))
        for dtype in (torch.float32, torch.bfloat16):
            x = x32 if dtype == torch.float32 else x32.to(torch.bfloat16)
            got = kernels.gramian(x, w)
            again = kernels.gramian(x, w)
            torch.cuda.synchronize()
            truth = kernels.gramian_plain(x, w, torch.float64)
            diag = truth.diagonal().clamp(min=0)
            scale = torch.sqrt(torch.outer(diag, diag))
            err = (got.double() - truth).abs()
            worst = float((err / scale.clamp(min=1e-300)).max())
            plain = kernels.gramian_plain(x, w).double()
            plain_worst = float(((plain - truth).abs()
                                 / scale.clamp(min=1e-300)).max())
            # the trace's relative error: a bias on the diagonal shows here
            tr = float(truth.diagonal().sum())
            trace_rel = [float(got.diagonal().double().sum()) / tr - 1,
                         float(plain.diagonal().sum()) / tr - 1]
            del plain
            bitwise = torch.equal(got, again)
            symmetric = torch.equal(got, got.T)
            ok = worst <= 1e-4 and bitwise and symmetric
            _line("k4_check", n=n, d=d, masked=masked, dtype=str(dtype)[6:],
                  worst_err_over_sqrt_gii_gjj=worst,
                  plain_f32_worst_err_over_sqrt_gii_gjj=plain_worst,
                  trace_rel_err_kernel_plain=trace_rel,
                  max_abs_err=float(err.max()), bitwise_equal=bitwise,
                  symmetric=symmetric, ok=ok)
            if not ok:
                raise AssertionError(f"K4 disagrees with its plain version "
                                     f"at n={n} d={d} {dtype}")
            if n == GRAM_N and dtype == torch.bfloat16:
                results["max_abs_err"] = float(err.max())
            results.update(_k4_times(x, x32, w, n, d))
            del x, truth
        del x32
        torch.cuda.empty_cache()
    return results


def _k4_times(x, x32, w, n, d):
    from cycloneml_tpu_torch.ops import kernels
    k_ms = _time_ms(lambda: kernels.gramian(x, w), 3, 1)
    p_ms = _time_ms(lambda: kernels.gramian_plain(x, w), 3, 1)
    # the library call on the same values in f32 (TF32 off), unmasked
    lib_ms = _time_ms(lambda: x32.T @ x32, 3, 1)
    n_bytes = n * d * x.element_size() + n * 4 + d * d * 4
    dt = str(x.dtype)[6:]
    # bf16 products are exact in f32: the tensor cores' bf16 rate bounds
    # them; f32 products need the f32 FMA rate
    bound, bound_by = _bound(n_bytes, float(n) * d * (d + 1),
                             H100_BF16_FLOPS if dt == "bfloat16"
                             else H100_F32_FLOPS)
    f32_bound, _ = _bound(n_bytes, float(n) * d * (d + 1))
    _line("k4_time", n=n, d=d, dtype=dt, kernel_ms=k_ms, plain_ms=p_ms,
          bound_ms=bound, bound_by=bound_by, f32_fma_bound_ms=f32_bound,
          library_f32_xtx_ms=lib_ms,
          achieved_tflop_s=float(n) * d * (d + 1) / k_ms / 1e9)
    if n == GRAM_N and dt == "bfloat16":
        return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                "bound_by": bound_by, "library_ms": lib_ms}
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
    phase_build()
    entries = []

    def entry(name, source, replaces, numbers, launches):
        entries.append({
            "name": name, "route": "cuda",
            "source": f"cycloneml_tpu_torch/csrc/{source}.cu",
            "replaces": f"cycloneml_tpu/ops/kernels.py:{replaces}",
            "launches": launches, "max_abs_err": numbers["max_abs_err"],
            "ms": numbers["ms"], "plain_ms": numbers["plain_ms"],
            "bound_ms": numbers["bound_ms"],
            "bound_by": numbers["bound_by"],
            "library_ms": numbers.get("library_ms"),
            "yardstick_ms": numbers.get("yardstick_ms"), "card": card})

    k1 = phase_kernel()
    entry("glm_sweep (logistic, K1)", "glm_sweep", 270, k1, phase_fit())
    k2 = phase_k2()
    entry("glm_sweep (squared, K2)", "glm_sweep", 226, k2, phase_linreg())
    k3 = phase_k3()
    entry("kmeans_assign (K3)", "kmeans_assign", 384, k3, phase_kmeans())
    k4 = phase_k4()
    entry("gramian (K4)", "gramian", 461, k4, phase_pca())
    print(json.dumps({"kernels": entries}), flush=True)
    _line("wall", seconds=time.perf_counter() - t_start)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
