"""Driver-side L-BFGS.

The port's counterpart of ``cycloneml_tpu/ml/optim/lbfgs.py`` (L-BFGS and
OWL-QN; L-BFGS-B is ROADMAP slice 2): a Nocedal-Wright L-BFGS with a
strong-Wolfe line search, two-loop recursion over m=10 curvature pairs,
initial Hessian scaling gamma = s.y / y.y, and Breeze-compatible convergence
tests; OWL-QN adds the L1 pseudo-gradient and the orthant projection.
Optimizer state is host float64; a loss function with a
``device_line_search`` runs each whole L-BFGS search on the device (OWL-QN
projects every trial point, so its searches run on the host).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np

LossGrad = Callable[[np.ndarray], Tuple[float, np.ndarray]]


@dataclass
class OptimState:
    x: np.ndarray
    value: float
    grad: np.ndarray
    iteration: int = 0
    converged: bool = False
    converged_reason: str = ""
    loss_history: List[float] = field(default_factory=list)
    # curvature memory, so a run can resume exactly where it stopped
    hist_s: List[np.ndarray] = field(default_factory=list)
    hist_y: List[np.ndarray] = field(default_factory=list)
    raw_grad: Optional[np.ndarray] = None  # OWL-QN: grad before pseudo-grad

    def to_pytree(self) -> dict:
        return {"x": self.x, "value": self.value, "grad": self.grad,
                "iteration": self.iteration,
                "converged": self.converged,
                "converged_reason": self.converged_reason,
                "loss_history": list(self.loss_history),
                "hist_s": list(self.hist_s), "hist_y": list(self.hist_y),
                "raw_grad": self.raw_grad}

    @classmethod
    def from_pytree(cls, t: dict) -> "OptimState":
        return cls(x=np.asarray(t["x"]), value=float(t["value"]),
                   grad=np.asarray(t["grad"]), iteration=int(t["iteration"]),
                   converged=bool(t.get("converged", False)),
                   converged_reason=str(t.get("converged_reason", "")),
                   loss_history=[float(v) for v in t["loss_history"]],
                   hist_s=[np.asarray(s) for s in t["hist_s"]],
                   hist_y=[np.asarray(y) for y in t["hist_y"]],
                   raw_grad=(np.asarray(t["raw_grad"])
                             if t.get("raw_grad") is not None else None))


class _History:
    """L-BFGS curvature-pair memory (two-loop recursion)."""

    def __init__(self, m: int):
        self.m = m
        self.s: List[np.ndarray] = []
        self.y: List[np.ndarray] = []

    def update(self, s: np.ndarray, y: np.ndarray) -> None:
        # curvature condition: keep the pair only if s.y is safely positive
        if float(np.dot(s, y)) > 1e-10 * float(np.dot(y, y)):
            self.s.append(s)
            self.y.append(y)
            if len(self.s) > self.m:
                self.s.pop(0)
                self.y.pop(0)

    def direction(self, grad: np.ndarray) -> np.ndarray:
        q = grad.copy()
        k = len(self.s)
        alpha = np.empty(k)
        rho = np.empty(k)
        for i in range(k - 1, -1, -1):
            rho[i] = 1.0 / np.dot(self.y[i], self.s[i])
            alpha[i] = rho[i] * np.dot(self.s[i], q)
            q -= alpha[i] * self.y[i]
        if k > 0:
            gamma = np.dot(self.s[-1], self.y[-1]) / np.dot(self.y[-1], self.y[-1])
            q *= gamma
        for i in range(k):
            beta = rho[i] * np.dot(self.y[i], q)
            q += (alpha[i] - beta) * self.s[i]
        return -q


def _strong_wolfe(f: LossGrad, x: np.ndarray, value: float, grad: np.ndarray,
                  direction: np.ndarray, init_alpha: float = 1.0,
                  c1: float = 1e-4, c2: float = 0.9,
                  max_evals: int = 30) -> Tuple[float, float, np.ndarray]:
    """Strong-Wolfe line search (Nocedal & Wright alg. 3.5/3.6). Returns
    (alpha, f(x + alpha d), g)."""
    d_dot_g0 = float(np.dot(direction, grad))
    if d_dot_g0 >= 0:
        raise ValueError("direction is not a descent direction")

    fused = getattr(f, "device_line_search", None)
    if fused is not None:
        out = fused(x, direction, value, d_dot_g0, init_alpha,
                    c1, c2, max_evals)
        if out is not None:
            return out

    def phi(alpha: float):
        v, g = f(x + alpha * direction)
        return v, g, float(np.dot(direction, g))

    def zoom(lo, hi, v_lo, d_lo, v_hi):
        best = None
        for _ in range(max_evals):
            alpha = 0.5 * (lo + hi)
            v, g, dg = phi(alpha)
            if v > value + c1 * alpha * d_dot_g0 or v >= v_lo:
                hi, v_hi = alpha, v
            else:
                if abs(dg) <= -c2 * d_dot_g0:
                    return alpha, v, g
                if dg * (hi - lo) >= 0:
                    hi, v_hi = lo, v_lo
                lo, v_lo, d_lo = alpha, v, dg
            best = (alpha, v, g)
            if abs(hi - lo) < 1e-12:
                break
        return best

    alpha_prev, v_prev, d_prev = 0.0, value, d_dot_g0
    alpha = init_alpha
    for i in range(max_evals):
        v, g, dg = phi(alpha)
        if v > value + c1 * alpha * d_dot_g0 or (i > 0 and v >= v_prev):
            out = zoom(alpha_prev, alpha, v_prev, d_prev, v)
            if out is None:
                break
            return out
        if abs(dg) <= -c2 * d_dot_g0:
            return alpha, v, g
        if dg >= 0:
            out = zoom(alpha, alpha_prev, v, dg, v_prev)
            if out is None:
                break
            return out
        alpha_prev, v_prev, d_prev = alpha, v, dg
        alpha *= 2.0
    # the last evaluated point when Wolfe could not be satisfied
    v, g, _ = phi(alpha)
    return alpha, v, g


def _reopen(resume: OptimState, max_iter: int) -> OptimState:
    """'max iterations reached' is a budget stop, not convergence: a resumed
    run with a larger budget continues (real convergence reasons hold)."""
    if (resume.converged
            and resume.converged_reason == "max iterations reached"
            and resume.iteration < max_iter):
        return dataclasses.replace(resume, converged=False,
                                   converged_reason="")
    return resume


class LBFGS:
    """Limited-memory BFGS (Breeze-LBFGS semantics). Convergence: maxIter;
    |df| <= tol max(|f|, |f'|, 1e-6); ||g|| <= grad_tol max(||x||, 1)."""

    def __init__(self, max_iter: int = 100, m: int = 10, tol: float = 1e-6,
                 grad_tol: Optional[float] = None):
        self.max_iter = max_iter
        self.m = m
        self.tol = tol
        self.grad_tol = grad_tol if grad_tol is not None else tol

    def _converged(self, state: OptimState, f_old: float) -> Optional[str]:
        if state.iteration >= self.max_iter:
            return "max iterations reached"
        denom = max(abs(state.value), abs(f_old), 1e-6)
        if abs(f_old - state.value) <= self.tol * denom:
            return "function value converged"
        gnorm = float(np.linalg.norm(state.grad))
        if gnorm <= self.grad_tol * max(float(np.linalg.norm(state.x)), 1.0):
            return "gradient converged"
        return None

    def iterations(self, f: LossGrad, x0: np.ndarray,
                   resume: Optional[OptimState] = None):
        """Generator of one OptimState per iteration. A ``resume`` state
        continues exactly where a previous run stopped."""
        hist = _History(self.m)
        if resume is not None:
            state = _reopen(resume, self.max_iter)
            hist.s = [np.asarray(s) for s in resume.hist_s]
            hist.y = [np.asarray(y) for y in resume.hist_y]
        else:
            x = np.asarray(x0, dtype=np.float64).copy()
            value, grad = f(x)
            state = OptimState(x=x, value=float(value),
                               grad=np.asarray(grad, dtype=np.float64))
            state.loss_history.append(state.value)
        yield state
        if state.converged:
            return
        while True:
            d = hist.direction(state.grad)
            init_alpha = 1.0 if state.iteration > 0 else \
                min(1.0, 1.0 / max(float(np.linalg.norm(state.grad)), 1e-12))
            try:
                alpha, v_new, g_new = _strong_wolfe(
                    f, state.x, state.value, state.grad, d, init_alpha)
            except ValueError:
                hist = _History(self.m)  # reset on non-descent
                d = -state.grad
                alpha, v_new, g_new = _strong_wolfe(
                    f, state.x, state.value, state.grad, d,
                    min(1.0, 1.0 / max(float(np.linalg.norm(state.grad)),
                                       1e-12)))
            x_new = state.x + alpha * d
            g_new = np.asarray(g_new, dtype=np.float64)
            hist.update(x_new - state.x, g_new - state.grad)
            f_old = state.value
            state = OptimState(
                x=x_new, value=float(v_new), grad=g_new,
                iteration=state.iteration + 1,
                loss_history=state.loss_history + [float(v_new)],
                hist_s=list(hist.s), hist_y=list(hist.y))
            reason = self._converged(state, f_old)
            if reason is not None:
                state.converged = True
                state.converged_reason = reason
            yield state
            if state.converged:
                return

    def minimize(self, f: LossGrad, x0: np.ndarray,
                 resume: Optional[OptimState] = None) -> OptimState:
        state = None
        for state in self.iterations(f, x0, resume=resume):
            pass
        return state


class OWLQN(LBFGS):
    """Orthant-wise limited-memory quasi-Newton for an L1 penalty
    (Breeze-OWLQN semantics; the reference selects it when elastic net
    has an L1 part). ``l1_reg`` is a scalar or a per-coordinate array (0
    for an intercept, per-feature values under standardization=false).
    The objective and the states it reports include the L1 term; a state's
    ``grad`` is the pseudo-gradient and ``raw_grad`` the smooth gradient,
    so a run resumes exactly."""

    def __init__(self, max_iter: int = 100, m: int = 10, tol: float = 1e-6,
                 l1_reg=0.0):
        super().__init__(max_iter, m, tol)
        self.l1_reg = l1_reg

    def _l1(self, x: np.ndarray) -> float:
        return float(np.sum(np.abs(x) * self.l1_reg))

    def _has_l1(self) -> bool:
        return bool(np.any(np.asarray(self.l1_reg) > 0))

    def _pseudo_grad(self, x: np.ndarray, grad: np.ndarray) -> np.ndarray:
        """The sub-gradient of f + l1|x| that is the steepest descent
        element: grad +- l1 off zero; at zero, grad + l1 where that is
        negative, grad - l1 where that is positive, else 0."""
        lam = np.broadcast_to(np.asarray(self.l1_reg, dtype=np.float64),
                              x.shape)
        pg = np.where(x > 0, grad + lam, np.where(x < 0, grad - lam, 0.0))
        at_zero = x == 0
        pg = np.where(at_zero & (grad + lam < 0), grad + lam, pg)
        pg = np.where(at_zero & (grad - lam > 0), grad - lam, pg)
        return pg

    def iterations(self, f: LossGrad, x0: np.ndarray,
                   resume: Optional[OptimState] = None):
        hist = _History(self.m)
        if resume is not None:
            state = _reopen(resume, self.max_iter)
            x = np.asarray(resume.x, dtype=np.float64)
            hist.s = [np.asarray(s) for s in resume.hist_s]
            hist.y = [np.asarray(y) for y in resume.hist_y]
            raw_grad = (np.asarray(resume.raw_grad)
                        if resume.raw_grad is not None else resume.grad)
        else:
            x = np.asarray(x0, dtype=np.float64).copy()
            value, grad = f(x)
            value = float(value) + self._l1(x)
            grad = np.asarray(grad, dtype=np.float64)
            state = OptimState(x=x, value=value,
                               grad=self._pseudo_grad(x, grad),
                               raw_grad=grad)
            state.loss_history.append(state.value)
            raw_grad = grad
        yield state
        if state.converged:
            return
        while True:
            d = hist.direction(state.grad)
            # keep the direction in the pseudo-gradient's descent orthant
            if self._has_l1():
                d = np.where(d * state.grad >= 0, 0.0, d)
            if not np.any(d):
                d = -state.grad
            orthant = np.where(x != 0, np.sign(x), -np.sign(state.grad))

            def f_projected(xt: np.ndarray):
                xt = np.where(xt * orthant >= 0, xt, 0.0)
                v, g = f(xt)
                return float(v) + self._l1(xt), np.asarray(g, np.float64)

            init_alpha = 1.0 if state.iteration > 0 else \
                min(1.0, 1.0 / max(float(np.linalg.norm(state.grad)), 1e-12))
            try:
                # Breeze's OWL-QN relaxes the curvature condition
                alpha, v_new, g_new = _strong_wolfe(
                    f_projected, state.x, state.value, state.grad, d,
                    init_alpha, c2=0.99)
            except ValueError:
                d = -state.grad
                alpha, v_new, g_new = _strong_wolfe(
                    f_projected, state.x, state.value, state.grad, d,
                    min(1.0, 1.0 / max(float(np.linalg.norm(state.grad)),
                                       1e-12)), c2=0.99)
            x_new = state.x + alpha * d
            x_new = np.where(x_new * orthant >= 0, x_new, 0.0)
            raw_grad_new = g_new
            pg_new = self._pseudo_grad(x_new, raw_grad_new)
            hist.update(x_new - state.x, raw_grad_new - raw_grad)
            f_old = state.value
            x = x_new
            raw_grad = raw_grad_new
            state = OptimState(
                x=x_new, value=float(v_new), grad=pg_new,
                iteration=state.iteration + 1,
                loss_history=state.loss_history + [float(v_new)],
                hist_s=list(hist.s), hist_y=list(hist.y),
                raw_grad=raw_grad_new)
            reason = self._converged(state, f_old)
            if reason is not None:
                state.converged = True
                state.converged_reason = reason
            yield state
            if state.converged:
                return
