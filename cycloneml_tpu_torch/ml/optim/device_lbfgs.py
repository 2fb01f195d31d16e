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
"""

from __future__ import annotations

from typing import Optional

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
