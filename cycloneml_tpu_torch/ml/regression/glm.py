"""Generalized linear regression via IRLS.

The port's counterpart of ``cycloneml_tpu/ml/regression/glm.py`` (ref
GeneralizedLinearRegression.scala:246, IterativelyReweightedLeastSquares):
each IRLS iteration is one pass over the rows (:func:`_irls_pass`) that
makes eta, mu, the working response z and weights W, and sums XᵀWX, XᵀWz,
ΣW·x, ΣW, ΣWz and the deviance; the (d+1)-sized augmented normal system,
the L2 step and the convergence test run on the host in float64.

Families: gaussian, binomial, poisson, gamma, tweedie(variancePower).
Links: identity, log, logit, inverse, sqrt, probit, cloglog, power(p).
The family and link functions are PyTorch, used on the device by the pass
and on float64 host vectors by the summary; probit uses
``torch.special.ndtri``/``ndtr`` where the reference uses ``jax.scipy``.

The pass widens X ``ROW_CHUNK`` rows at a time to the accumulator width
and multiplies with ``torch.matmul`` (TF32 off), the chunk products summed
in row order; it is no kernel in the reference either. The offset is an
(n,) vector in the accumulator tier beside X (the reference packs it as
column 0 of its device block, in the data tier). Rows with w = 0 (the
padding) add nothing, whatever X holds there.

The summary (standard errors, t- and p-values through scipy, AIC,
deviances, residuals) takes eta, mu and XᵀWX at the solution from one
more pass on the device and does the rest on the host over (n,) vectors.
"""

from __future__ import annotations

import logging
import math
from typing import Optional

import numpy as np
import torch

from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
from cycloneml_tpu_torch.linalg.vectors import DenseVector, Vectors
from cycloneml_tpu_torch.ml.base import PredictionModel, Predictor
from cycloneml_tpu_torch.ml.optim.aggregators import ROW_CHUNK
from cycloneml_tpu_torch.ml.param import ParamValidators as V
from cycloneml_tpu_torch.ml.util_io import MLReadable, MLWritable, load_arrays, save_arrays
from cycloneml_tpu_torch.ml.shared import (
    HasAggregationDepth, HasFitIntercept, HasLabelCol, HasMaxIter,
    HasRegParam, HasSolver, HasTol,
)

logger = logging.getLogger(__name__)

_EPS = 1e-16


def _f64(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _host(fn, *arrays) -> np.ndarray:
    """A family or link function on float64 host arrays."""
    return fn(*(_f64(a) for a in arrays)).numpy()


def _clip_pos(x):
    return torch.where(x.abs() > _EPS, x,
                       torch.sign(x) * _EPS + (x == 0).to(x.dtype) * _EPS)


# -- families (ref GeneralizedLinearRegression.scala:557-848) -----------------

class Family:
    """Variance and deviance of the response distribution; ``deviance``
    sums w * unit deviance over the rows with w > 0."""

    name = "family"
    default_link = "identity"

    def initialize(self, y, w):
        raise NotImplementedError

    def variance(self, mu):
        raise NotImplementedError

    def unit_deviance(self, y, mu):
        raise NotImplementedError

    def deviance(self, y, mu, w):
        return torch.sum(torch.where(w > 0, w * self.unit_deviance(y, mu),
                                     torch.zeros_like(w)))

    def aic(self, y, mu, w, w_sum, deviance, rank):  # host numpy
        return float("nan")

    def clean_mu(self, mu):
        return mu

    def validate_label(self, y_host: np.ndarray) -> None:
        """Host-side label-domain check before training."""


class Tweedie(Family):
    def __init__(self, variance_power: float):
        self.variance_power = float(variance_power)
        self.name = "tweedie"
        self.default_link = "log" if variance_power != 0 else "identity"

    def initialize(self, y, w):
        if self.variance_power >= 1.0:
            return torch.clamp(y, min=0.1)
        return y

    def validate_label(self, y_host: np.ndarray) -> None:
        # ref Tweedie.initialize:624-632: y = 0 is legal for 1 <= p < 2,
        # p >= 2 needs positive labels
        p = self.variance_power
        if 1.0 <= p < 2.0:
            if np.any(y_host < 0):
                raise ValueError(f"tweedie({p}) labels must be non-negative")
        elif p >= 2.0:
            if np.any(y_host <= 0):
                raise ValueError(f"tweedie({p}) labels must be positive")

    def variance(self, mu):
        return torch.pow(torch.clamp(mu, min=_EPS), self.variance_power)

    def unit_deviance(self, y, mu):
        # ref :646; y floors to 0.1 in the first term only, and only for
        # 1 <= p < 2 (the second term keeps the raw y)
        p = self.variance_power
        y1 = torch.clamp(y, min=0.1) if 1.0 <= p < 2.0 else y
        return 2.0 * (y * (torch.pow(y1, 1 - p) - torch.pow(mu, 1 - p))
                      / (1 - p)
                      - (torch.pow(y, 2 - p) - torch.pow(mu, 2 - p)) / (2 - p))

    def clean_mu(self, mu):
        return torch.clamp(mu, min=_EPS) if self.variance_power >= 1 else mu


class Gaussian(Tweedie):
    def __init__(self):
        super().__init__(0.0)
        self.name = "gaussian"
        self.default_link = "identity"

    def initialize(self, y, w):
        return y

    def variance(self, mu):
        return torch.ones_like(mu)

    def unit_deviance(self, y, mu):
        return (y - mu) ** 2

    def aic(self, y, mu, w, w_sum, deviance, rank):
        # ref :704-711 plus the summary's 2 rank: the row COUNT scales the
        # log-likelihood term, and sum(log w) subtracts
        n = float(len(np.atleast_1d(y)))
        return (n * (math.log(deviance / n * 2.0 * math.pi) + 1.0) + 2.0
                - float(np.sum(np.log(np.maximum(w, _EPS))))
                + 2.0 * rank)

    def clean_mu(self, mu):
        return mu


class Binomial(Family):
    name = "binomial"
    default_link = "logit"

    def initialize(self, y, w):
        return (w * y + 0.5) / (w + 1.0)

    def variance(self, mu):
        return mu * (1.0 - mu)

    def unit_deviance(self, y, mu):
        def ylogy(yy, m):
            return torch.where(yy > 0, yy * torch.log(
                torch.clamp(yy / m, min=_EPS)), torch.zeros_like(yy))
        return 2.0 * (ylogy(y, mu) + ylogy(1.0 - y, 1.0 - mu))

    def aic(self, y, mu, w, w_sum, deviance, rank):
        # ref :745-759: round(w) trials, successes round(y w) with the raw
        # weight; Java's round is half-up, floor(x + 0.5)
        from scipy import stats as sps
        wt = np.floor(w + 0.5).astype(np.int64)
        ok = wt > 0
        ll = sps.binom.logpmf(np.floor(y[ok] * w[ok] + 0.5), wt[ok],
                              np.clip(mu[ok], _EPS, 1 - _EPS))
        return -2.0 * float(ll.sum()) + 2.0 * rank

    def clean_mu(self, mu):
        return torch.clamp(mu, _EPS, 1.0 - _EPS)


class Poisson(Tweedie):
    def __init__(self):
        super().__init__(1.0)
        self.name = "poisson"
        self.default_link = "log"

    def initialize(self, y, w):
        return torch.clamp(y, min=0.1)

    def variance(self, mu):
        return mu

    def unit_deviance(self, y, mu):
        t = torch.where(y > 0, y * torch.log(torch.clamp(y, min=_EPS) / mu),
                        torch.zeros_like(y))
        return 2.0 * (t - (y - mu))

    def aic(self, y, mu, w, w_sum, deviance, rank):
        from scipy import stats as sps
        ll = w * sps.poisson.logpmf(np.round(y), mu)
        return -2.0 * float(ll.sum()) + 2.0 * rank


class Gamma(Tweedie):
    def __init__(self):
        super().__init__(2.0)
        self.name = "gamma"
        self.default_link = "inverse"

    def initialize(self, y, w):
        return torch.clamp(y, min=0.1)

    def variance(self, mu):
        return mu * mu

    def unit_deviance(self, y, mu):
        return -2.0 * (torch.log(torch.clamp(y, min=_EPS) / mu)
                       - (y - mu) / mu)

    def aic(self, y, mu, w, w_sum, deviance, rank):
        from scipy import stats as sps
        disp = deviance / w_sum
        ll = (w * sps.gamma.logpdf(y, 1.0 / disp, scale=mu * disp)).sum()
        return -2.0 * float(ll) + 2.0 * rank + 2.0  # +2: the dispersion


def _make_family(name: str, variance_power: float) -> Family:
    name = name.lower()
    simple = {"gaussian": Gaussian, "binomial": Binomial,
              "poisson": Poisson, "gamma": Gamma}
    if name in simple:
        return simple[name]()
    if name == "tweedie":
        if variance_power in (0.0, 1.0, 2.0):
            return {0.0: Gaussian, 1.0: Poisson,
                    2.0: Gamma}[variance_power]()
        if variance_power < 0 or 0 < variance_power < 1:
            raise ValueError("variancePower must be 0 or >= 1")
        return Tweedie(variance_power)
    raise ValueError(f"unknown family {name}")


# -- links (ref :850-990) -----------------------------------------------------

class Link:
    name = "link"

    def link(self, mu):
        raise NotImplementedError

    def unlink(self, eta):
        raise NotImplementedError

    def deriv(self, mu):
        """d eta / d mu."""
        raise NotImplementedError


class Identity(Link):
    name = "identity"

    def link(self, mu):
        return mu

    def unlink(self, eta):
        return eta

    def deriv(self, mu):
        return torch.ones_like(mu)


class Log(Link):
    name = "log"

    def link(self, mu):
        return torch.log(torch.clamp(mu, min=_EPS))

    def unlink(self, eta):
        return torch.exp(eta)

    def deriv(self, mu):
        return 1.0 / _clip_pos(mu)


class Logit(Link):
    name = "logit"

    def link(self, mu):
        return torch.log(mu / (1.0 - mu))

    def unlink(self, eta):
        return torch.sigmoid(eta)

    def deriv(self, mu):
        return 1.0 / _clip_pos(mu * (1.0 - mu))


class Inverse(Link):
    name = "inverse"

    def link(self, mu):
        return 1.0 / _clip_pos(mu)

    def unlink(self, eta):
        return 1.0 / _clip_pos(eta)

    def deriv(self, mu):
        return -1.0 / _clip_pos(mu * mu)


class Sqrt(Link):
    name = "sqrt"

    def link(self, mu):
        return torch.sqrt(torch.clamp(mu, min=0.0))

    def unlink(self, eta):
        return eta * eta

    def deriv(self, mu):
        return 0.5 / torch.sqrt(_clip_pos(mu))


class Probit(Link):
    name = "probit"

    def link(self, mu):
        return torch.special.ndtri(mu)

    def unlink(self, eta):
        return torch.special.ndtr(eta)

    def deriv(self, mu):
        q = torch.special.ndtri(mu)
        # 1 / max(pdf(q), eps), pdf through its log as the reference's
        logpdf = -0.5 * q * q - 0.5 * math.log(2.0 * math.pi)
        return 1.0 / torch.clamp(torch.exp(logpdf), min=_EPS)


class CLogLog(Link):
    name = "cloglog"

    def link(self, mu):
        return torch.log(-torch.log(torch.clamp(1.0 - mu, min=_EPS)))

    def unlink(self, eta):
        return 1.0 - torch.exp(-torch.exp(eta))

    def deriv(self, mu):
        om = _clip_pos(1.0 - mu)
        return 1.0 / _clip_pos(-om * torch.log(om))


class Power(Link):
    def __init__(self, p: float):
        self.p = float(p)
        self.name = f"power({p})"

    def link(self, mu):
        if self.p == 0.0:
            return torch.log(_clip_pos(mu))
        return torch.pow(_clip_pos(mu), self.p)

    def unlink(self, eta):
        if self.p == 0.0:
            return torch.exp(eta)
        return torch.pow(_clip_pos(eta), 1.0 / self.p)

    def deriv(self, mu):
        if self.p == 0.0:
            return 1.0 / _clip_pos(mu)
        return self.p * torch.pow(_clip_pos(mu), self.p - 1.0)


def _make_link(name: str) -> Link:
    table = {"identity": Identity, "log": Log, "logit": Logit,
             "inverse": Inverse, "sqrt": Sqrt, "probit": Probit,
             "cloglog": CLogLog}
    name = name.lower()
    if name not in table:
        raise ValueError(f"unknown link {name}")
    return table[name]()


_SUPPORTED = {  # ref FamilyAndLink supported combos :532
    "gaussian": {"identity", "log", "inverse"},
    "binomial": {"logit", "probit", "cloglog"},
    "poisson": {"log", "identity", "sqrt"},
    "gamma": {"inverse", "identity", "log"},
}


def _family_link(params):
    """The (Family, Link) of an estimator's or model's params."""
    fam = _make_family(params.get("family"), params.get("variancePower"))
    link_name = params.get("link")
    if params.get("family") == "tweedie":
        if link_name:
            raise ValueError("use linkPower with the tweedie family")
        lp = params.get("linkPower")
        if lp != lp:  # NaN: the canonical power 1 - variancePower
            lp = 1.0 - params.get("variancePower")
        link = {1.0: Identity, 0.0: Log, -1.0: Inverse,
                0.5: Sqrt}.get(lp, lambda: Power(lp))()
    elif link_name:
        if link_name not in _SUPPORTED.get(fam.name, set()):
            raise ValueError(f"link {link_name} unsupported for {fam.name}")
        link = _make_link(link_name)
    else:
        link = _make_link(fam.default_link)
    return fam, link


# -- the device passes --------------------------------------------------------

def _irls_pass(x, y, w, off, beta, icpt, first: bool, fam: Family,
               link: Link, acc: Optional[torch.dtype] = None) -> dict:
    """One IRLS pass over the rows, a chunk of ``ROW_CHUNK`` rows at a
    time: eta (from the family's start values on the ``first`` pass, else
    x.beta + icpt + off), mu, the working response z and weights W, and
    the sums ``xtx`` (XᵀWX), ``xty`` (XᵀWz), ``xsum`` (ΣW·x), ``wsum``,
    ``zsum`` (ΣWz), ``dev`` and ``xsq`` (the diagonal of XᵀWX), as
    device tensors at ``acc`` (default w's dtype)."""
    acc = acc or w.dtype
    dev = x.device
    n, d = x.shape
    beta = torch.as_tensor(beta, device=dev).to(acc)
    icpt = float(icpt)
    xtx = torch.zeros((d, d), dtype=acc, device=dev)
    xty = torch.zeros(d, dtype=acc, device=dev)
    xsum = torch.zeros(d, dtype=acc, device=dev)
    sums = torch.zeros(3, dtype=acc, device=dev)  # wsum, zsum, dev
    for lo in range(0, n, ROW_CHUNK):
        sl = slice(lo, lo + ROW_CHUNK)
        xc = x[sl].to(acc)
        yc, wc, oc = y[sl].to(acc), w[sl].to(acc), off[sl].to(acc)
        if first:
            eta = link.link(fam.clean_mu(fam.initialize(
                yc, torch.clamp(wc, min=_EPS))))
        else:
            eta = xc @ beta + icpt + oc
        mu = fam.clean_mu(link.unlink(eta))
        g = link.deriv(mu)
        z = (eta - oc) + (yc - mu) * g
        wi = torch.where(wc > 0, wc / torch.clamp(g * g * fam.variance(mu),
                                                  min=_EPS),
                         torch.zeros_like(wc))
        z = torch.where(wc > 0, z, torch.zeros_like(z))
        xtx += (xc * wi[:, None]).T @ xc
        xty += (wi * z) @ xc
        xsum += wi @ xc
        sums += torch.stack([torch.sum(wi), torch.sum(wi * z),
                             fam.deviance(yc, mu, wc)])
    return {"xtx": xtx, "xty": xty, "xsum": xsum, "wsum": sums[0],
            "zsum": sums[1], "dev": sums[2], "xsq": torch.diagonal(xtx)}


def _predict_eta(x, beta, icpt, off, acc) -> torch.Tensor:
    """x.beta + icpt + off over the rows, a chunk at a time."""
    b = torch.as_tensor(beta, device=x.device).to(acc)
    return torch.cat([x[lo:lo + ROW_CHUNK].to(acc) @ b
                      for lo in range(0, x.shape[0], ROW_CHUNK)]) \
        + float(icpt) + off.to(acc)


def _weighted_gram(x, wi, fit_intercept: bool, acc) -> np.ndarray:
    """[X, 1]ᵀ diag(wi) [X, 1] (or XᵀWX without the intercept column) in
    float64 on the host, from one chunked pass over X."""
    n, d = x.shape
    xtx = torch.zeros((d, d), dtype=acc, device=x.device)
    xsum = torch.zeros(d, dtype=acc, device=x.device)
    for lo in range(0, n, ROW_CHUNK):
        xc = x[lo:lo + ROW_CHUNK].to(acc)
        wc = wi[lo:lo + ROW_CHUNK]
        xtx += (xc * wc[:, None]).T @ xc
        xsum += wc @ xc
    xtx = xtx.cpu().double().numpy()
    if not fit_intercept:
        return xtx
    xsum = xsum.cpu().double().numpy()
    return np.block([[xtx, xsum[:, None]],
                     [xsum[None, :],
                      np.array([[float(wi.sum())]], dtype=np.float64)]])


class _GLRParams(HasMaxIter, HasRegParam, HasTol, HasFitIntercept,
                 HasSolver, HasAggregationDepth, HasLabelCol):
    def _declare_glr_params(self):
        self._p_label_col()
        self._p_max_iter(25)
        self._p_reg_param(0.0)
        self._p_tol(1e-6)
        self._p_fit_intercept(True)
        self._p_solver(["irls"], "irls")
        self._p_aggregation_depth(2)
        self._param("family", "response distribution",
                    V.in_array(["gaussian", "binomial", "poisson", "gamma",
                                "tweedie"]), default="gaussian")
        self._param("link", "link function name", default="")
        self._param("variancePower", "tweedie variance power", default=0.0)
        self._param("linkPower", "tweedie link power", default=float("nan"))
        self._param("offsetCol", "offset column", default="")
        self._param("linkPredictionCol", "eta output column", default="")


class GeneralizedLinearRegression(Predictor, _GLRParams, MLWritable,
                                  MLReadable):
    """IRLS-trained GLM (ref GeneralizedLinearRegression.scala:246)."""

    MAX_FEATURES = 4096  # ref: WeightedLeastSquares.MAX_NUM_FEATURES

    def __init__(self, uid=None, **kwargs):
        super().__init__(uid)
        self._declare_glr_params()
        for k, v in kwargs.items():
            self.set(k, v)

    def set_family(self, v):
        return self.set("family", v)

    def set_link(self, v):
        return self.set("link", v)

    def set_variance_power(self, v):
        return self.set("variancePower", v)

    def set_link_power(self, v):
        return self.set("linkPower", v)

    def set_reg_param(self, v):
        return self.set("regParam", v)

    def set_max_iter(self, v):
        return self.set("maxIter", v)

    def set_offset_col(self, v):
        return self.set("offsetCol", v)

    def _fit(self, frame) -> "GeneralizedLinearRegressionModel":
        ds = frame.to_instance_dataset(
            self.get("featuresCol"), self.get("labelCol"),
            self.get("weightCol") or None)
        ocol = self.get("offsetCol")
        offset = np.asarray(frame[ocol], dtype=np.float64) \
            if ocol and not isinstance(frame, InstanceDataset) else None
        return self._fit_dataset(ds, offset)

    def _fit_dataset(self, ds: InstanceDataset, offset=None
                     ) -> "GeneralizedLinearRegressionModel":
        """IRLS over a dataset; ``offset`` is an (n,) array of the real
        rows (numpy or a tensor), or None."""
        fam, link = _family_link(self)
        n, d = ds.n_rows, ds.n_features
        y_host = np.asarray(ds.y_host()[:n], dtype=np.float64)
        fam.validate_label(y_host)
        if d > self.MAX_FEATURES:
            raise ValueError(
                f"GLM supports at most {self.MAX_FEATURES} features")
        fit_icpt = self.get("fitIntercept")
        reg = self.get("regParam")
        tol = self.get("tol")
        acc = ds.w.dtype
        dev = ds.x.device
        off = torch.zeros(ds.x.shape[0], dtype=acc, device=dev)
        if offset is not None:
            off[:n] = torch.as_tensor(offset, device=dev).to(acc)

        beta = np.zeros(d)
        icpt = 0.0
        history = []
        for it in range(max(self.get("maxIter"), 1)):
            out = _irls_pass(ds.x, ds.y, ds.w, off, beta, icpt, it == 0,
                             fam, link, acc)
            # one readback of the whole pass
            out = {k: v.cpu().double().numpy() for k, v in out.items()}
            a = out["xtx"].copy()
            b = out["xty"]
            if fit_icpt:
                a = np.block([[a, out["xsum"][:, None]],
                              [out["xsum"][None, :],
                               np.array([[float(out["wsum"])]])]])
                b = np.concatenate([b, [float(out["zsum"])]])
            if reg > 0:
                # each reference IRLS step runs WLS with standardized
                # features and label: the original-space penalty is
                # reg * sum(W) * var_j under the current working weights
                ws = float(out["wsum"])
                xm = out["xsum"] / ws
                var_j = out["xsq"] / ws - xm * xm
                idx = np.arange(d)
                a[idx, idx] += reg * ws * np.clip(var_j, 0.0, None)
            try:
                sol = np.linalg.solve(a, b)
            except np.linalg.LinAlgError:
                sol = np.linalg.lstsq(a, b, rcond=None)[0]
            new_beta = sol[:d]
            new_icpt = float(sol[d]) if fit_icpt else 0.0
            old = np.concatenate([beta, [icpt]])
            new = np.concatenate([new_beta, [new_icpt]])
            # ref IRLS convergence: the largest relative coefficient change
            delta = float(np.max(np.abs(new - old)
                                 / np.maximum(np.abs(old), 1e-6)))
            beta, icpt = new_beta, new_icpt
            history.append(float(out["dev"]))
            if it > 0 and delta < tol:
                break

        model = GeneralizedLinearRegressionModel(beta, icpt, uid=self.uid)
        self._copy_values(model)
        model._set_parent(self)
        model.summary = self._summarize(model, ds, off, offset is not None,
                                        fam, link, len(history))
        model.summary.objective_history = history
        return model

    def _summarize(self, model, ds, off, has_offset: bool, fam: Family,
                   link: Link, n_iter: int) -> "GLMTrainingSummary":
        n, d = ds.n_rows, ds.n_features
        acc = ds.w.dtype
        fit_icpt = self.get("fitIntercept")
        eta_d = _predict_eta(ds.x, model._coef, model._icpt, off, acc)[:n]
        mu_d = fam.clean_mu(link.unlink(eta_d))
        g_d = link.deriv(mu_d)
        w_d = ds.w[:n].to(acc)
        wi_d = w_d / torch.clamp(g_d * g_d * fam.variance(mu_d), min=_EPS)
        xtwx = _weighted_gram(ds.x[:n], wi_d, fit_icpt, acc)
        mu = mu_d.cpu().double().numpy()
        y = np.asarray(ds.y_host()[:n], dtype=np.float64)
        w = np.asarray(ds.w_host()[:n], dtype=np.float64)
        ofs = off[:n].cpu().double().numpy() if has_offset else None
        w_sum = float(w.sum())
        dev = float(_host(fam.deviance, y, mu, w))

        if fit_icpt:
            null_dev = self._fit_null(y, w, ofs, fam, link)
        else:
            eta0 = ofs if ofs is not None else np.zeros(n)
            mu0 = _host(lambda e: fam.clean_mu(link.unlink(e)), eta0)
            null_dev = float(_host(fam.deviance, y, mu0, w))

        rank = d + (1 if fit_icpt else 0)
        dof_resid = n - rank
        if fam.name in ("gaussian", "gamma", "tweedie"):
            var = _host(fam.variance, mu)
            pearson = float((w * (y - mu) ** 2 / np.maximum(var, _EPS)).sum())
            dispersion = pearson / max(dof_resid, 1)
        else:
            dispersion = 1.0
        aic = fam.aic(y, mu, w, w_sum, dev, rank)

        # standard errors from (XᵀWX)^-1 phi at the converged weights
        try:
            cov = np.linalg.inv(xtwx) * dispersion
            se = np.sqrt(np.clip(np.diag(cov), 0, None))
        except np.linalg.LinAlgError:
            se = np.full(rank, float("nan"))
        coefs = np.concatenate([model._coef, [model._icpt]]) if fit_icpt \
            else model._coef
        tvals = coefs / np.maximum(se, _EPS)
        from scipy import stats as sps
        if fam.name in ("binomial", "poisson"):
            pvals = 2.0 * sps.norm.sf(np.abs(tvals))
        else:
            pvals = 2.0 * sps.t.sf(np.abs(tvals), max(dof_resid, 1))

        return GLMTrainingSummary(
            deviance=dev, null_deviance=null_dev, dispersion=dispersion,
            aic=aic, num_iterations=n_iter, rank=rank,
            degrees_of_freedom=n - 1 if fit_icpt else n,
            residual_degree_of_freedom=dof_resid,
            coefficient_standard_errors=se, t_values=tvals, p_values=pvals,
            prediction_mean=mu, label=y, weights=w, family_obj=fam,
            link_obj=link)

    def _fit_null(self, y, w, offset, fam: Family, link: Link) -> float:
        """Deviance of the intercept-only model (a scalar IRLS on the
        host)."""
        mu = _host(lambda a, b: fam.clean_mu(fam.initialize(a, b)), y, w)
        icpt = 0.0
        ofs = offset if offset is not None else 0.0
        eta = _host(link.link, mu)
        for _ in range(50):
            mu = _host(lambda e: fam.clean_mu(link.unlink(e)), eta)
            g = _host(link.deriv, mu)
            z = (eta - ofs) + (y - mu) * g
            wi = w / np.maximum(g * g * _host(fam.variance, mu), _EPS)
            new_icpt = float((wi * z).sum() / max(wi.sum(), _EPS))
            if abs(new_icpt - icpt) < 1e-10 * max(abs(icpt), 1.0):
                icpt = new_icpt
                break
            icpt = new_icpt
            eta = icpt + ofs
        mu = _host(lambda e: fam.clean_mu(link.unlink(e)),
                   icpt + ofs + np.zeros_like(y))
        return float(_host(fam.deviance, y, mu, w))


class GeneralizedLinearRegressionModel(PredictionModel, _GLRParams,
                                       MLWritable, MLReadable):
    def __init__(self, coefficients: Optional[np.ndarray] = None,
                 intercept: float = 0.0, uid=None):
        super().__init__(uid)
        self._declare_glr_params()
        self._coef = np.asarray(coefficients, dtype=np.float64) \
            if coefficients is not None else None
        self._icpt = float(intercept)
        self.summary: Optional[GLMTrainingSummary] = None

    @property
    def coefficients(self) -> DenseVector:
        return Vectors.dense(self._coef)

    @property
    def intercept(self) -> float:
        return self._icpt

    @property
    def num_features(self) -> int:
        return self._coef.shape[0]

    def _predict_batch(self, x: np.ndarray) -> np.ndarray:
        _, link = _family_link(self)
        return _host(link.unlink, self.predict_link(x))

    def predict_link(self, x: np.ndarray) -> np.ndarray:
        return x @ self._coef + self._icpt

    def _transform(self, frame):
        # a model trained with an offset adds it to eta at predict time
        x = frame[self.get("featuresCol")]
        if x.ndim == 1:
            x = x[:, None]
        eta = self.predict_link(x)
        ocol = self.get("offsetCol")
        if ocol:
            eta = eta + np.asarray(frame[ocol], dtype=np.float64)
        _, link = _family_link(self)
        out = frame.with_column(self.get("predictionCol"),
                                _host(link.unlink, eta))
        lcol = self.get("linkPredictionCol")
        if lcol:
            out = out.with_column(lcol, eta)
        return out

    def _save_data(self, path: str) -> None:
        save_arrays(path, coef=self._coef, icpt=np.array(self._icpt))

    def _load_data(self, path: str, meta) -> None:
        arrs = load_arrays(path)
        self._coef = arrs["coef"]
        self._icpt = float(arrs["icpt"])


class GLMTrainingSummary:
    """ref GeneralizedLinearRegressionTrainingSummary."""

    def __init__(self, **kw):
        self.deviance = kw["deviance"]
        self.null_deviance = kw["null_deviance"]
        self.dispersion = kw["dispersion"]
        self.aic = kw["aic"]
        self.num_iterations = kw["num_iterations"]
        self.rank = kw["rank"]
        self.degrees_of_freedom = kw["degrees_of_freedom"]
        self.residual_degree_of_freedom = kw["residual_degree_of_freedom"]
        self.coefficient_standard_errors = kw["coefficient_standard_errors"]
        self.t_values = kw["t_values"]
        self.p_values = kw["p_values"]
        self.objective_history = []  # the deviance after each IRLS pass
        self._mu = kw["prediction_mean"]
        self._y = kw["label"]
        self._w = kw["weights"]
        self._fam: Family = kw["family_obj"]
        self._link: Link = kw["link_obj"]
        self.family = self._fam.name
        self.link = self._link.name

    def residuals(self, residuals_type: str = "deviance") -> np.ndarray:
        y, mu, w = self._y, self._mu, self._w
        if residuals_type == "response":
            return y - mu
        if residuals_type == "working":
            return (y - mu) * _host(self._link.deriv, mu)
        if residuals_type == "pearson":
            var = _host(self._fam.variance, mu)
            return (y - mu) * np.sqrt(w) / np.sqrt(np.maximum(var, _EPS))
        if residuals_type == "deviance":
            dev_i = w * _host(self._fam.unit_deviance, y, mu)
            return np.sign(y - mu) * np.sqrt(np.clip(dev_i, 0, None))
        raise ValueError(residuals_type)
