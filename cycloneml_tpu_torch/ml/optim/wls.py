"""WeightedLeastSquares — the normal-equation solver component.

The port's counterpart of ``cycloneml_tpu/ml/optim/wls.py`` (ref
WeightedLeastSquares.scala:101-326 and NormalEquationSolver.scala:59-153):
one pass over the rows for the moments {Σw, Σwy, Σwy², Σw·x, Σwy·x, XᵀWX}
(:func:`_moments`), then the standardized (d+1)-sized normal system solved
on the host in float64, by Cholesky or by quasi-Newton.

What it shares with the reference, and what differs from the
LinearRegression l-bfgs path:

- the moments are POPULATION-weighted (aVar = aaBar − aBar², divided by
  Σw), glmnet's convention, not the Summarizer's unbiased one;
- the intercept is an APPENDED column of the standardized system, and the
  quasi-Newton cost pins it to bBar − aBar·β at every evaluation;
- zero-variance features get zero coefficients;
- a constant label short-circuits with an intercept (or an all-zero
  label), refuses regularization when the label is standardized, and
  otherwise trains with bStd = |bBar|;
- ``auto`` falls back from a singular Cholesky to quasi-Newton, and an L1
  part always takes quasi-Newton (OWL-QN over the moments).

The moments pass weights every row by w (padding rows, w = 0, vanish);
it is not the Gramian kernel K4, which masks rows by w > 0 and does not
weight them. It is no kernel in the reference either (one ``einsum`` at
HIGHEST precision): here X is widened ``ROW_CHUNK`` rows at a time to the
accumulator width and multiplied by ``torch.matmul`` (TF32 off, as the
mesh sets it), the chunk products summed in row order, so X stays the
only buffer the size of the data.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from cycloneml_tpu_torch.ml.optim.aggregators import ROW_CHUNK

AUTO = "auto"
CHOLESKY = "cholesky"
QUASI_NEWTON = "quasi-newton"

MAX_NUM_FEATURES = 4096  # ref WeightedLeastSquares.MAX_NUM_FEATURES:335


class WeightedLeastSquaresModel:
    def __init__(self, coefficients: np.ndarray, intercept: float,
                 diag_inv_atwa: np.ndarray, objective_history):
        self.coefficients = coefficients
        self.intercept = intercept
        self.diag_inv_atwa = diag_inv_atwa
        self.objective_history = list(objective_history)

    def predict(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(x) @ self.coefficients + self.intercept


def _moment_sums(x, y, w, acc: Optional[torch.dtype] = None
                 ) -> Dict[str, torch.Tensor]:
    """The summary moments in one pass over the rows (the reference's
    Aggregator.add/merge), left on x's device: ``w_sum``, ``b_sum`` (Σwy),
    ``bb_sum`` (Σwy²), ``a_sum`` (Σw·x), ``ab_sum`` (Σwy·x) and ``aa_sum``
    (XᵀWX). ``x`` (n, d) at any storage width, ``y`` and ``w`` (n,),
    tensors on one device or numpy; the sums run at ``acc`` (default w's
    dtype, the accumulator tier)."""
    x, y, w = (torch.as_tensor(a) for a in (x, y, w))
    if acc is None:
        acc = w.dtype if w.is_floating_point() else torch.float64
    y, w = y.to(device=x.device, dtype=acc), w.to(device=x.device, dtype=acc)
    n, d = x.shape
    wy = w * y
    a_sum = torch.zeros(d, dtype=acc, device=x.device)
    ab_sum = torch.zeros(d, dtype=acc, device=x.device)
    aa_sum = torch.zeros((d, d), dtype=acc, device=x.device)
    for lo in range(0, n, ROW_CHUNK):
        xc = x[lo:lo + ROW_CHUNK].to(acc)
        wc = w[lo:lo + ROW_CHUNK]
        a_sum += wc @ xc
        ab_sum += wy[lo:lo + ROW_CHUNK] @ xc
        aa_sum += (xc * wc[:, None]).T @ xc
    return {"w_sum": torch.sum(w), "b_sum": torch.sum(wy),
            "bb_sum": torch.sum(wy * y), "a_sum": a_sum, "ab_sum": ab_sum,
            "aa_sum": aa_sum}


def _moments(x, y, w, acc: Optional[torch.dtype] = None
             ) -> Dict[str, np.ndarray]:
    """:func:`_moment_sums` read back as float64 host arrays."""
    return {k: v.cpu().double().numpy()
            for k, v in _moment_sums(x, y, w, acc).items()}


class WeightedLeastSquares:
    """Normal-equation WLS with the reference's solver semantics."""

    def __init__(self, fit_intercept: bool, reg_param: float = 0.0,
                 elastic_net_param: float = 0.0,
                 standardize_features: bool = True,
                 standardize_label: bool = True,
                 solver_type: str = AUTO,
                 max_iter: int = 100, tol: float = 1e-6):
        if reg_param < 0:
            raise ValueError("regParam must be >= 0")
        if not 0.0 <= elastic_net_param <= 1.0:
            raise ValueError("elasticNetParam must be in [0, 1]")
        if solver_type not in (AUTO, CHOLESKY, QUASI_NEWTON):
            raise ValueError(f"unknown solver {solver_type!r}")
        self.fit_intercept = fit_intercept
        self.reg_param = float(reg_param)
        self.elastic_net_param = float(elastic_net_param)
        self.standardize_features = standardize_features
        self.standardize_label = standardize_label
        self.solver_type = solver_type
        self.max_iter = max_iter
        self.tol = tol

    def fit(self, x, y, w=None) -> WeightedLeastSquaresModel:
        """``x``/``y``/``w``: tensors on the data's device (an
        ``InstanceDataset``'s, padding rows at w = 0) or numpy; only the
        O(d²) moments come back to the host."""
        n, d = x.shape
        if d > MAX_NUM_FEATURES:
            raise ValueError(
                f"WeightedLeastSquares supports at most {MAX_NUM_FEATURES} "
                f"features, got {d}")
        if w is None:
            w = np.ones(n)
        return self._solve_from_moments(_moments(x, y, w), d)

    # -- the reference algorithm, on the host in float64 ------------------
    def _solve_from_moments(self, m, d: int) -> WeightedLeastSquaresModel:
        w_sum = m["w_sum"]
        if w_sum <= 0:
            raise ValueError("sum of weights must be positive")
        raw_b_bar = m["b_sum"] / w_sum
        raw_bb_bar = m["bb_sum"] / w_sum
        raw_b_std = float(np.sqrt(max(raw_bb_bar - raw_b_bar ** 2, 0.0)))

        if raw_b_std == 0.0:
            if self.fit_intercept or raw_b_bar == 0.0:
                # ref :121-136: a constant label needs no training
                return WeightedLeastSquaresModel(
                    np.zeros(d), float(raw_b_bar) if self.fit_intercept
                    else 0.0, np.zeros(1), [0.0])
            if self.reg_param > 0.0 and self.standardize_label:
                raise ValueError(
                    "The standard deviation of the label is zero. Model "
                    "cannot be regularized when labels are standardized")
        b_std = abs(float(raw_b_bar)) if raw_b_std == 0.0 else raw_b_std
        b_bar = float(raw_b_bar) / b_std
        bb_bar = float(raw_bb_bar) / (b_std * b_std)

        raw_a_bar = m["a_sum"] / w_sum
        raw_aa_bar = m["aa_sum"] / w_sum
        raw_ab_bar = m["ab_sum"] / w_sum
        a_var = np.maximum(np.diag(raw_aa_bar) - raw_a_bar ** 2, 0.0)
        a_std = np.sqrt(a_var)
        live = a_std > 0
        inv_std = np.where(live, 1.0 / np.where(live, a_std, 1.0), 0.0)

        a_bar = raw_a_bar * inv_std
        ab_bar = raw_ab_bar * inv_std / b_std
        aa_bar = raw_aa_bar * np.outer(inv_std, inv_std)

        eff_reg = self.reg_param / b_std
        eff_l1 = self.elastic_net_param * eff_reg
        eff_l2 = (1.0 - self.elastic_net_param) * eff_reg

        # L2 onto the standardized diagonal (ref :213-231)
        lam = np.full(d, eff_l2)
        if not self.standardize_features:
            lam = np.where(live, lam * inv_std * inv_std, 0.0)
        if not self.standardize_label:
            lam = lam * b_std
        aa_bar = aa_bar + np.diag(lam)

        # the intercept rides as an appended bias column
        if self.fit_intercept:
            ata = np.block([[aa_bar, a_bar[:, None]],
                            [a_bar[None, :], np.ones((1, 1))]])
            atb = np.concatenate([ab_bar, [b_bar]])
        else:
            ata = aa_bar
            atb = ab_bar

        use_qn = (self.solver_type == QUASI_NEWTON
                  or (self.solver_type == AUTO
                      and self.elastic_net_param != 0.0
                      and self.reg_param != 0.0))
        if use_qn:
            sol, history, aa_inv = self._quasi_newton(
                ata, atb, a_bar, b_bar, bb_bar, a_std, eff_l1, d)
        else:
            try:
                sol, history, aa_inv = self._cholesky(ata, atb)
            except np.linalg.LinAlgError:
                if self.solver_type != AUTO:
                    raise
                # ref :266-273: auto falls back to QN on a singular AtA
                sol, history, aa_inv = self._quasi_newton(
                    ata, atb, a_bar, b_bar, bb_bar, a_std, None, d)

        if self.fit_intercept:
            coef_std, intercept = sol[:d], float(sol[d]) * b_std
        else:
            coef_std, intercept = sol, 0.0
        coef = coef_std * np.where(live, b_std * inv_std, 0.0)

        if aa_inv is not None:
            mult = np.concatenate([a_var, [1.0]]) if self.fit_intercept \
                else a_var
            with np.errstate(divide="ignore"):
                diag = np.where(mult > 0,
                                np.diag(aa_inv) / (w_sum * mult), np.inf)
        else:
            diag = np.zeros(1)
        return WeightedLeastSquaresModel(coef, intercept, diag, history)

    def _cholesky(self, ata, atb):
        # LinAlgError on a matrix that is not positive definite: the
        # reference's SingularMatrixException
        chol = np.linalg.cholesky(ata)
        sol = np.linalg.solve(chol.T, np.linalg.solve(chol, atb))
        return sol, [0.0], np.linalg.inv(ata)

    def _quasi_newton(self, ata, atb, a_bar, b_bar, bb_bar, a_std,
                      eff_l1, d: int):
        from cycloneml_tpu_torch.ml.optim.lbfgs import LBFGS, OWLQN

        k = ata.shape[0]

        def f(coef):
            coef = np.asarray(coef, dtype=np.float64).copy()
            if self.fit_intercept:
                # ref NormalEquationCostFun:134-144: the bias coordinate
                # is pinned to its optimum given the features
                coef[d] = b_bar - float(coef[:d] @ a_bar)
            aax = ata @ coef
            loss = 0.5 * bb_bar - float(atb @ coef) + 0.5 * float(coef @ aax)
            return loss, aax - atb

        x0 = np.zeros(k)
        if self.fit_intercept:
            x0[d] = b_bar
        if eff_l1:
            l1_vec = np.zeros(k)
            for i in range(d):
                if self.standardize_features:
                    l1_vec[i] = eff_l1
                else:
                    l1_vec[i] = eff_l1 / a_std[i] if a_std[i] != 0 else 0.0
            opt = OWLQN(max_iter=self.max_iter, tol=self.tol, l1_reg=l1_vec)
        else:
            opt = LBFGS(max_iter=self.max_iter, tol=self.tol)
        state = opt.minimize(f, x0)
        sol = np.asarray(state.x, dtype=np.float64).copy()
        if self.fit_intercept:
            sol[d] = b_bar - float(sol[:d] @ a_bar)
        return sol, list(state.loss_history), None
