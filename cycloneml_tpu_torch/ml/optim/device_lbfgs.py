"""Device-resident chunked L-BFGS.

The port's counterpart of ``cycloneml_tpu/ml/optim/device_lbfgs.py:
DeviceLBFGS``. The reference runs each chunk of K iterations — two-loop
recursion over an (m, n) curvature ring buffer, the strong-Wolfe search,
the curvature test and the convergence tests — inside one jitted
``while_loop``. PyTorch has no device while-loop, so here a chunk is a host
loop over device-resident state: the coefficients, the ring buffers S and
Y and the gradient stay torch tensors on the device, and only the scalars
the loop branches on come back (the value and directional derivative per
evaluation, the descent test, the curvature test and the convergence
norms per iteration). The decisions, the evaluation and dispatch counts,
the first-iteration and restart step rule and the convergence-code
precedence are the reference's, so a fit takes the same path.

:class:`StackedDeviceLBFGS` is the model-axis twin (the reference's
``StackedDeviceLBFGS``): K models over one X advance together, each with
its own curvature history, line search and convergence code, and a model
that converged stays frozen while the others go on.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from cycloneml_tpu_torch.ml.optim.lbfgs import LBFGS, OptimState, _reopen
from cycloneml_tpu_torch.ml.optim.loss import wolfe_search


def _read(*scalars: torch.Tensor, t=np.float64):
    """Read 0-d device tensors back in one transfer, as numpy scalars."""
    return [t(v) for v in torch.stack(scalars).tolist()]


def _two_loop(S: torch.Tensor, Y: torch.Tensor, k: int,
              g: torch.Tensor) -> torch.Tensor:
    """L-BFGS direction from the newest ``k`` pairs of the ring buffers
    (slot m-1 is the newest): the reference's masked two-loop, with the
    masked-out slots skipped (they leave q and r unchanged there)."""
    m = S.shape[0]
    q = g
    coeffs = {}
    for i in range(m - 1, m - k - 1, -1):
        rho = 1.0 / torch.dot(Y[i], S[i])
        a = rho * torch.dot(S[i], q)
        q = q - a * Y[i]
        coeffs[i] = (a, rho)
    if k > 0:
        gamma = torch.dot(S[m - 1], Y[m - 1]) / torch.clamp(
            torch.dot(Y[m - 1], Y[m - 1]), min=1e-300)
        r = gamma * q
    else:
        r = q
    for i in range(m - k, m):
        a, rho = coeffs[i]
        r = r + (a - rho * torch.dot(Y[i], r)) * S[i]
    return -r


class DeviceLBFGS(LBFGS):
    """L-BFGS running ``chunk`` iterations per device-resident chunk.

    Works with a :class:`DistributedLossFunction` whose L2 term (if any)
    has a device twin (``l2_regularization(...).traceable``); the
    estimator checks that before choosing it (``cyclone.ml.lbfgs.
    deviceChunk`` sizes or disables it)."""

    def __init__(self, max_iter: int = 100, m: int = 10, tol: float = 1e-6,
                 grad_tol: Optional[float] = None, chunk: int = 8,
                 c1: float = 1e-4, c2: float = 0.9, max_ls: int = 30):
        super().__init__(max_iter, m, tol, grad_tol)
        self.chunk = max(int(chunk), 1)
        self.c1, self.c2, self.max_ls = c1, c2, max_ls

    def iterations(self, f, x0: np.ndarray,
                   resume: Optional[OptimState] = None):
        cdt, dev, m = f.cdt, f.device, self.m
        t = np.float64 if cdt == torch.float64 else np.float32
        if f.l2_reg_fn is not None and \
                not hasattr(f.l2_reg_fn, "traceable"):
            raise ValueError(
                "DeviceLBFGS needs a regularizer with a device twin; use "
                "the host LBFGS otherwise")

        def as_dev(a):
            return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a)
                                   else a, device=dev).to(cdt).clone()

        n = len(np.asarray(x0)) if resume is None else len(resume.x)
        S = torch.zeros((m, n), dtype=cdt, device=dev)
        Y = torch.zeros((m, n), dtype=cdt, device=dev)
        if resume is not None:
            state = _reopen(resume, self.max_iter)
            k = min(len(resume.hist_s), m)
            for i, (s_, y_) in enumerate(zip(resume.hist_s[-m:],
                                             resume.hist_y[-m:])):
                S[m - k + i] = as_dev(s_)
                Y[m - k + i] = as_dev(y_)
            # an iteration-0 resume keeps the scaled first step
            first = state.iteration == 0
            need_init = False
            yield state
            if state.converged:
                return
            coef = as_dev(state.x)
            f_val = t(state.value)
            g = as_dev(state.grad)
        else:
            state = None
            k = 0
            first = True
            need_init = True
            coef = as_dev(x0)
            f_val, g = t(0.0), None

        while True:
            base_iter = state.iteration if state is not None else 0
            it_limit = min(self.chunk, max(self.max_iter - base_iter, 0))
            evals = 0
            if need_init:
                # a fresh fit evaluates f(x0) as part of its first chunk
                f_d, g = f.f_and_g(coef)
                f_val, = _read(f_d, t=t)
                f0, g0 = f_val, g
                evals = 1
            losses, it, code = [], 0, 0
            while it < it_limit and code == 0:
                d = _two_loop(S, Y, k, g)
                gg_d = torch.dot(g, g)
                dg0, gg = _read(torch.dot(d, g), gg_d, t=t)
                # non-descent: reset the history, steepest descent
                bad = dg0 >= 0
                if bad:
                    d, k, dg0 = -g, 0, -gg
                gnorm = np.sqrt(max(gg, t(1e-300)))
                # the scaled step min(1, 1/||g||) on the very first
                # iteration and on every steepest-descent restart
                init_alpha = min(t(1.0), t(1.0) / gnorm) \
                    if (first and it == 0) or bad else t(1.0)

                def phi(alpha):
                    v, grad = f.f_and_g(coef + float(alpha) * d)
                    return v, grad, torch.dot(d, grad)

                alpha, f_new, g_new, ev = wolfe_search(
                    phi, torch.zeros_like(g), f_val, dg0, init_alpha,
                    self.c1, self.c2, self.max_ls, cdt)
                s = float(alpha) * d
                y = g_new - g
                x_new = coef + s
                sy, yy, gn2, xn2 = _read(torch.dot(s, y), torch.dot(y, y),
                                         torch.dot(g_new, g_new),
                                         torch.dot(x_new, x_new), t=t)
                # curvature condition (host _History.update)
                if sy > t(1e-10) * yy:
                    S = torch.roll(S, -1, dims=0)
                    Y = torch.roll(Y, -1, dims=0)
                    S[-1] = s
                    Y[-1] = y
                    k = min(k + 1, m)
                # Breeze-style convergence (host LBFGS._converged)
                denom = max(abs(f_new), abs(f_val), t(1e-6))
                f_conv = abs(f_val - f_new) <= t(self.tol) * denom
                g_conv = np.sqrt(max(gn2, t(0.0))) <= \
                    t(self.grad_tol) * max(np.sqrt(max(xn2, t(0.0))), t(1.0))
                code = 1 if f_conv else (2 if g_conv else 0)
                losses.append(float(f_new))
                coef, f_val, g = x_new, f_new, g_new
                it += 1
                evals += ev
            first = False
            f.n_evals += evals
            f.n_dispatches += 1
            if need_init:
                state = OptimState(x=np.asarray(x0, np.float64).copy(),
                                   value=float(f0), grad=g0,
                                   loss_history=[float(f0)])
                need_init = False
                yield state
            state = OptimState(
                x=coef, value=float(f_val), grad=g,
                iteration=state.iteration + it,
                loss_history=state.loss_history + losses,
                hist_s=[S[i] for i in range(m - k, m)],
                hist_y=[Y[i] for i in range(m - k, m)])
            if hasattr(f, "_record"):
                f._record({"loss": state.value, "chunk_iterations": it})
            # precedence as the host _converged: the budget stop outranks
            # the value and gradient tests
            if state.iteration >= self.max_iter:
                state.converged = True
                state.converged_reason = "max iterations reached"
            elif code == 1:
                state.converged = True
                state.converged_reason = "function value converged"
            elif code == 2:
                state.converged = True
                state.converged_reason = "gradient converged"
            if state.converged:
                # the terminal state in host float64, as the host optimizer
                state.x = coef.cpu().double().numpy()
                state.grad = g.cpu().double().numpy()
            yield state
            if state.converged:
                return


def _two_loop_stacked(S: torch.Tensor, Y: torch.Tensor, k: torch.Tensor,
                      g: torch.Tensor) -> torch.Tensor:
    """The L-BFGS directions ``(K, n)`` of K models from their ring buffers
    ``(K, m, n)`` (slot m-1 newest), model i using its newest ``k[i]``
    pairs: the reference's masked two-loop, batched over the model axis (a
    masked slot has rho = 0 and leaves q and r unchanged)."""
    m = S.shape[1]
    q = g
    coeffs = {}
    for i in range(m - 1, -1, -1):
        valid = i >= m - k
        sy = torch.sum(Y[:, i] * S[:, i], dim=1)
        rho = torch.where(valid, 1.0 / torch.where(valid, sy, 1.0),
                          torch.zeros_like(sy))
        a = rho * torch.sum(S[:, i] * q, dim=1)
        q = q - a[:, None] * Y[:, i]
        coeffs[i] = (a, rho)
    last_sy = torch.sum(S[:, m - 1] * Y[:, m - 1], dim=1)
    last_yy = torch.sum(Y[:, m - 1] * Y[:, m - 1], dim=1)
    gamma = torch.where(k > 0, last_sy / torch.clamp(last_yy, min=1e-300),
                        torch.ones_like(last_sy))
    r = gamma[:, None] * q
    for i in range(m):
        a, rho = coeffs[i]
        beta = rho * torch.sum(Y[:, i] * r, dim=1)
        r = r + (a - beta)[:, None] * S[:, i]
    return -r


@dataclass
class StackedOptimResult:
    """Terminal state of a stacked fit, every field per model."""

    x: np.ndarray                       # (K, n) float64
    values: np.ndarray                  # (K,)
    iterations: np.ndarray              # (K,) live iterations per model
    converged_reasons: List[str] = field(default_factory=list)
    loss_histories: List[List[float]] = field(default_factory=list)
    evals: Optional[np.ndarray] = None  # (K,) evaluations per model


class StackedDeviceLBFGS:
    """Chunked L-BFGS over a stack of K models sharing one X (the
    reference's ``StackedDeviceLBFGS``, as a host loop over device-resident
    ``(K, ...)`` state).

    Each iteration runs the masked two-loop for every model, one batched
    strong-Wolfe search (:func:`loss.wolfe_search`, every model its own
    bracket+zoom in lockstep evaluations of all K), the curvature test and
    the convergence tests per model; a model whose convergence code fired
    is frozen (its state selected through unchanged) and starts every later
    chunk frozen, so the result does not depend on ``chunk``. A chunk ends
    when every model converged, after ``chunk`` iterations, or when the
    budget is spent; one chunk is one dispatch. The host reads back per
    evaluation the K values and directional derivatives, and per iteration
    the K descent, curvature and norm scalars. ``f`` is a
    ``StackedDistributedLossFunction``.
    """

    def __init__(self, max_iter: int = 100, m: int = 10, tol: float = 1e-6,
                 grad_tol: Optional[float] = None, chunk: int = 8,
                 c1: float = 1e-4, c2: float = 0.9, max_ls: int = 30):
        self.max_iter = max_iter
        self.m = m
        self.tol = tol
        self.grad_tol = grad_tol if grad_tol is not None else tol
        self.chunk = max(int(chunk), 1)
        self.c1, self.c2, self.max_ls = c1, c2, max_ls

    def minimize(self, f, x0: np.ndarray) -> StackedOptimResult:
        x0 = np.asarray(x0, dtype=np.float64)
        n_models, n = x0.shape
        if n_models != f.n_models:
            raise ValueError(f"x0 stacks {n_models} models but the loss "
                             f"carries {f.n_models}")
        cdt, dev, m = f.cdt, f.device, self.m
        t = np.float64 if cdt == torch.float64 else np.float32
        where = np.where

        def read(*vectors: torch.Tensor):
            # (K,) device vectors back in one transfer
            return list(torch.stack([v.to(cdt) for v in vectors])
                        .cpu().numpy().astype(t))

        def dev_mask(mask):
            return torch.as_tensor(mask, device=dev)

        coef = torch.as_tensor(x0, device=dev).to(cdt)
        S = torch.zeros((n_models, m, n), dtype=cdt, device=dev)
        Y = torch.zeros((n_models, m, n), dtype=cdt, device=dev)
        k = np.zeros(n_models, dtype=np.int64)
        f_val = np.zeros(n_models, dtype=t)
        g = torch.zeros((n_models, n), dtype=cdt, device=dev)
        code = np.zeros(n_models, dtype=np.int64)
        iters = np.zeros(n_models, dtype=np.int64)
        evals = np.zeros(n_models, dtype=np.int64)
        histories: List[List[float]] = [[] for _ in range(n_models)]
        first, need_init, total_iter = True, True, 0
        while True:
            it_limit = min(self.chunk, max(self.max_iter - total_iter, 0))
            ev_global, steps, chunk_losses = 0, 0, []
            if need_init:
                f_d, g = f.f_and_g(coef)
                f_val, = read(f_d)
                for kk in range(n_models):
                    histories[kk].append(float(f_val[kk]))
                evals += 1
                ev_global = 1
            while steps < it_limit and (code == 0).any():
                live = code == 0
                k_d = torch.as_tensor(k, device=dev)
                d = _two_loop_stacked(S, Y, k_d, g)
                dg0, gg = read(torch.sum(d * g, dim=1),
                               torch.sum(g * g, dim=1))
                # non-descent: reset the history, steepest descent
                bad = dg0 >= 0
                d = torch.where(dev_mask(bad)[:, None], -g, d)
                k = where(bad, 0, k)
                dg0 = where(bad, -gg, dg0)
                gnorm = np.sqrt(np.maximum(gg, t(1e-300)))
                # the scaled first step on the very first iteration and on
                # every steepest-descent restart
                init_alpha = where((first and steps == 0) | bad,
                                   np.minimum(t(1.0), t(1.0) / gnorm),
                                   t(1.0)).astype(t)

                def phi(alpha):
                    a = torch.as_tensor(alpha, device=dev).to(cdt)
                    v, grad = f.f_and_g(coef + a[:, None] * d)
                    return v, grad, torch.sum(d * grad, dim=1)

                alpha, f_new, g_new, ev = wolfe_search(
                    phi, torch.zeros_like(g), f_val, dg0, init_alpha,
                    self.c1, self.c2, self.max_ls, cdt, active=live)
                s = torch.as_tensor(alpha, device=dev).to(cdt)[:, None] * d
                y = g_new - g
                x_new = coef + s
                sy, yy, gn2, xn2 = read(
                    torch.sum(s * y, dim=1), torch.sum(y * y, dim=1),
                    torch.sum(g_new * g_new, dim=1),
                    torch.sum(x_new * x_new, dim=1))
                # curvature condition, per model
                keep = live & (sy > t(1e-10) * yy)
                keep_d = dev_mask(keep)[:, None, None]
                S = torch.where(keep_d, torch.cat(
                    [S[:, 1:], s[:, None]], dim=1), S)
                Y = torch.where(keep_d, torch.cat(
                    [Y[:, 1:], y[:, None]], dim=1), Y)
                k = where(keep, np.minimum(k + 1, m), k)
                # Breeze-style convergence, per model
                denom = np.maximum(np.maximum(np.abs(f_new), np.abs(f_val)),
                                   t(1e-6))
                f_conv = np.abs(f_val - f_new) <= t(self.tol) * denom
                g_conv = np.sqrt(np.maximum(gn2, t(0.0))) <= \
                    t(self.grad_tol) * np.maximum(
                        np.sqrt(np.maximum(xn2, t(0.0))), t(1.0))
                code_new = where(f_conv, 1, where(g_conv, 2, 0))
                for kk in np.nonzero(live)[0]:
                    if not np.isnan(f_new[kk]):
                        histories[kk].append(float(f_new[kk]))
                chunk_losses.append(float(np.nanmean(f_new[live])))
                live_d = dev_mask(live)[:, None]
                coef = torch.where(live_d, x_new, coef)
                g = torch.where(live_d, g_new, g)
                f_val = where(live, f_new, f_val).astype(t)
                iters += live
                evals += ev
                ev_global += int(ev.max())
                code = where(live, code_new, code)
                steps += 1
            f.n_evals += ev_global
            f.n_dispatches += 1
            need_init = first = False
            total_iter += steps
            if hasattr(f, "_ctx") and hasattr(f._ctx, "record_step"):
                f._ctx.record_step({
                    "loss": chunk_losses[-1] if chunk_losses
                    else float(np.mean(f_val)),
                    "chunk_iterations": steps, "n_models": n_models})
            if (code != 0).all() or total_iter >= self.max_iter:
                break
        # the budget stop outranks the value and gradient tests, as in the
        # serial paths
        reasons = ["function value converged" if c == 1 else
                   "gradient converged" if c == 2 else
                   "max iterations reached" for c in code]
        return StackedOptimResult(
            x=coef.cpu().double().numpy(),
            values=np.asarray(f_val, dtype=np.float64),
            iterations=iters, converged_reasons=reasons,
            loss_histories=histories, evals=evals)
