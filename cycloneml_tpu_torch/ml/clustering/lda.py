"""Latent Dirichlet Allocation.

The port's counterpart of ``cycloneml_tpu/ml/clustering/lda.py`` (ref:
ml/clustering/LDA.scala; "online" = OnlineLDAOptimizer, mllib/clustering/
LDAOptimizer.scala:229, Hoffman et al.'s online variational Bayes with
(tau0 + t)^-kappa steps; "em" = the same variational family on the full
corpus with step 1, as the reference's batch formulation):

- the corpus is the dense count matrix (docs x vocab) of an
  ``InstanceDataset``; each iteration's E-step runs on the device over the
  documents in the mini-batch, a chunk of rows at a time (its (rows, V)
  temporaries are as large as X): ``_GAMMA_ITERS`` fixed-point iterations of
  each document's gamma, then the sufficient statistics expElogtheta^T
  (cts / phinorm), the chunks' partials added in float64 in chunk order;
- the lambda update on the host in float64, as the reference, its
  E[log beta] by the same ``_dirichlet_expectation_t`` as the E-step's, on
  host float64 tensors;
- the online mini-batch is a Bernoulli(``subsamplingRate``) mask over the
  real documents, drawn on the device by ``torch.rand`` from a
  ``torch.Generator`` seeded by a SplitMix64 mix of (seed, iteration)
  (``ml/optim/gradient_descent.mask_seed``), where the reference draws
  ``jax.random`` bits: the mini-batches differ from the reference's, a fixed
  seed replays exactly. At ``subsamplingRate=1.0`` no mask is drawn and the
  fit is the reference's. Only the kept documents are computed (the
  reference computes every row and zeroes the rest).

No hand-written kernel: the reference's E-step is jnp (no Pallas call); its
products stay ``torch`` products here, TF32 off.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
from cycloneml_tpu_torch.ml.base import Estimator, Model
from cycloneml_tpu_torch.ml.optim.gradient_descent import mask_seed
from cycloneml_tpu_torch.ml.param import ParamValidators as V
from cycloneml_tpu_torch.ml.shared import HasFeaturesCol, HasMaxIter, HasSeed
from cycloneml_tpu_torch.ml.util_io import MLReadable, MLWritable, load_arrays, save_arrays

_GAMMA_ITERS = 40  # per-doc variational fixed-point iterations (static)
CHUNK_ELEMS = 1 << 27  # elements of one (rows, V) temporary of the E-step
SCORE_ELEMS = 1 << 25  # elements of one (rows, k, V) term of the bound


class _LDAParams(HasFeaturesCol, HasMaxIter, HasSeed):
    def _declare_lda_params(self):
        self._p_features_col()
        self._p_max_iter(20)
        self._p_seed(17)
        self.k = self._param("k", "number of topics (> 1)", V.gt(1), default=10)
        self.optimizer = self._param(
            "optimizer", "online or em",
            V.in_array(["online", "em"]), default="online")
        self.docConcentration = self._param(
            "docConcentration", "alpha prior on doc-topic dist (-1 = auto 1/k)",
            default=-1.0)
        self.topicConcentration = self._param(
            "topicConcentration", "eta prior on topic-term dist (-1 = auto 1/k)",
            default=-1.0)
        self.learningOffset = self._param(
            "learningOffset", "tau0 (>0) downweights early iterations",
            V.gt(0.0), default=1024.0)
        self.learningDecay = self._param(
            "learningDecay", "kappa in (0.5, 1]", V.gt(0.0), default=0.51)
        self.subsamplingRate = self._param(
            "subsamplingRate", "minibatch fraction in (0, 1]",
            V.in_range(0.0, 1.0, lower_inclusive=False), default=0.05)
        self.topicDistributionCol = self._param(
            "topicDistributionCol", "output column for doc-topic mixture",
            default="topicDistribution")


def _dirichlet_expectation_t(a: torch.Tensor) -> torch.Tensor:
    """E[log theta] of Dirichlet rows ``a`` on the device."""
    return torch.special.digamma(a) - torch.special.digamma(
        torch.sum(a, dim=1, keepdim=True))


def infer_gamma(x: torch.Tensor, exp_elog_beta: torch.Tensor,
                alpha: float) -> torch.Tensor:
    """The documents' variational gamma (rows, k): ``_GAMMA_ITERS``
    fixed-point iterations from 1 over the count rows ``x`` (rows, V) at
    exp_elog_beta's width."""
    gamma = torch.ones((x.shape[0], exp_elog_beta.shape[0]),
                       dtype=exp_elog_beta.dtype, device=x.device)
    for _ in range(_GAMMA_ITERS):
        exp_elog_theta = torch.exp(_dirichlet_expectation_t(gamma))
        phinorm = exp_elog_theta @ exp_elog_beta + 1e-100
        gamma = alpha + exp_elog_theta * ((x / phinorm) @ exp_elog_beta.T)
    return gamma


def _chunk_rows(vocab: int, budget: int = CHUNK_ELEMS) -> int:
    return max(1, budget // max(vocab, 1))


class LDA(Estimator, _LDAParams, MLWritable, MLReadable):
    def __init__(self, uid=None, **kwargs):
        super().__init__(uid)
        self._declare_lda_params()
        for key, v in kwargs.items():
            self.set(key, v)

    def set_k(self, v):
        return self.set("k", v)

    def set_max_iter(self, v):
        return self.set("maxIter", v)

    def set_optimizer(self, v):
        return self.set("optimizer", v)

    def _alpha_eta(self) -> Tuple[float, float]:
        k = self.get("k")
        a = self.get("docConcentration")
        e = self.get("topicConcentration")
        alpha = (1.0 / k) if a is None or a <= 0 else float(a)
        eta = (1.0 / k) if e is None or e <= 0 else float(e)
        return alpha, eta

    def _fit(self, frame) -> "LDAModel":
        ds = frame.to_instance_dataset(self.get("featuresCol"), label_col=None)
        return self._fit_dataset(ds)

    def _fit_dataset(self, ds: InstanceDataset) -> "LDAModel":
        k, vocab = self.get("k"), ds.n_features
        alpha, eta = self._alpha_eta()
        online = self.get("optimizer") == "online"
        frac = self.get("subsamplingRate") if online else 1.0
        n_docs = ds.n_rows
        tau0 = self.get("learningOffset")
        kappa = self.get("learningDecay")
        dtype = ds.w.dtype  # accumulator tier: X may store bf16
        dev = ds.x.device
        chunk = _chunk_rows(vocab)
        seed = self.get("seed")

        rng = np.random.RandomState(seed)
        # lambda init ~ Gamma(100, 1/100) as in Hoffman et al. / the reference
        lam = rng.gamma(100.0, 1.0 / 100.0, (k, vocab))

        def e_step(x, y, w, lam_in, t):
            # the mini-batch: real rows (w > 0), subsampled below rate 1
            keep = w > 0
            if frac < 1.0:
                g = torch.Generator(device=w.device)
                g.manual_seed(mask_seed(seed, t))
                u = torch.rand(w.shape, generator=g, device=w.device,
                               dtype=w.dtype)
                keep = keep & (u < frac)
            rows = torch.nonzero(keep).reshape(-1)
            exp_elog_beta = torch.exp(_dirichlet_expectation_t(lam_in))
            sstats = torch.zeros((k, vocab), dtype=torch.float64,
                                 device=w.device)
            for lo in range(0, rows.shape[0], chunk):
                cts = x[rows[lo:lo + chunk]].to(lam_in.dtype)    # (b, V)
                gamma = infer_gamma(cts, exp_elog_beta, alpha)
                exp_elog_theta = torch.exp(_dirichlet_expectation_t(gamma))
                phinorm = exp_elog_theta @ exp_elog_beta + 1e-100
                # sstats[k, w] = sum_d expElogtheta_dk * cts_dw / phinorm_dw
                sstats += (exp_elog_theta.T @ (cts / phinorm)).to(torch.float64)
            return {"sstats": sstats,
                    "n_batch": torch.sum(keep.to(torch.float64))}

        step = ds.tree_aggregate_fn(e_step)
        for t in range(self.get("maxIter")):
            out = step(torch.as_tensor(lam, device=dev).to(dtype), t)
            batch_docs = float(out["n_batch"])
            if batch_docs <= 0:
                continue
            sstats = out["sstats"].cpu().numpy()
            Elogbeta = _dirichlet_expectation_t(torch.as_tensor(lam)).numpy()
            lam_new = eta + (n_docs / batch_docs) * sstats * np.exp(Elogbeta)
            rho = (tau0 + t + 1) ** (-kappa) if online else 1.0
            lam = (1.0 - rho) * lam + rho * lam_new

        model = LDAModel(lam, vocab_size=vocab, alpha=alpha, eta=eta,
                         uid=self.uid)
        self._copy_values(model)
        model._set_parent(self)
        return model


class LDAModel(Model, _LDAParams, MLWritable, MLReadable):
    def __init__(self, lam: Optional[np.ndarray] = None, vocab_size: int = 0,
                 alpha: float = 0.1, eta: float = 0.1, uid=None):
        super().__init__(uid)
        self._declare_lda_params()
        self._lam = np.asarray(lam) if lam is not None else None
        self._vocab_size = vocab_size
        self._alpha = alpha
        self._eta = eta

    @property
    def vocab_size(self) -> int:
        return self._vocab_size

    def topics_matrix(self) -> np.ndarray:
        """(vocab, k) column-normalized topic-term matrix (ref
        LDAModel.topicsMatrix layout)."""
        beta = self._lam / self._lam.sum(axis=1, keepdims=True)
        return beta.T

    def describe_topics(self, max_terms: int = 10) -> List[Tuple[np.ndarray, np.ndarray]]:
        beta = self._lam / self._lam.sum(axis=1, keepdims=True)
        out = []
        for row in beta:
            idx = np.argsort(-row)[:max_terms]
            out.append((idx, row[idx]))
        return out

    def _device(self, frame) -> torch.device:
        ctx = getattr(frame, "ctx", None)
        return ctx.device if ctx is not None else torch.device("cpu")

    def _infer_gamma(self, x: np.ndarray) -> np.ndarray:
        """The documents' gamma on the host in float64."""
        beta = torch.exp(_dirichlet_expectation_t(torch.as_tensor(self._lam)))
        return infer_gamma(torch.from_numpy(np.array(x, dtype=np.float64)),
                           beta, self._alpha).numpy()

    def _transform(self, frame):
        x = np.asarray(frame[self.get("featuresCol")], dtype=np.float64)
        if x.ndim == 1:
            x = x[:, None]
        gamma = self._infer_gamma(x)
        theta = gamma / gamma.sum(axis=1, keepdims=True)
        return frame.with_column(self.get("topicDistributionCol"), theta)

    def log_likelihood(self, frame) -> float:
        """Variational lower bound on log p(docs) (ref
        LocalLDAModel.logLikelihood — same ELBO decomposition), in float64
        on the frame's device: the documents' terms a chunk of rows at a
        time (the (rows, k, V) term of a chunk within ``SCORE_ELEMS``), the
        topics' terms once on the host."""
        from scipy.special import gammaln
        x = np.asarray(frame[self.get("featuresCol")], dtype=np.float64)
        if x.ndim == 1:
            x = x[:, None]
        k, vocab = self._lam.shape
        alpha, eta = self._alpha, self._eta
        dev = self._device(frame)
        lam = torch.as_tensor(self._lam, device=dev)
        elog_beta = _dirichlet_expectation_t(lam)
        exp_elog_beta = torch.exp(elog_beta)
        lg_alpha = float(gammaln(alpha))
        lg_alpha_k = float(gammaln(alpha * k))
        docs = torch.zeros((), dtype=torch.float64, device=dev)
        rows = _chunk_rows(k * vocab, SCORE_ELEMS)
        for lo in range(0, x.shape[0], rows):
            xc = torch.from_numpy(x[lo:lo + rows].copy()).to(dev)
            gamma = infer_gamma(xc, exp_elog_beta, alpha)
            elog_theta = _dirichlet_expectation_t(gamma)
            # E[log p(docs | theta, beta)] via the phi-optimal bound:
            # log sum_k exp(Elogtheta_dk + Elogbeta_kw), computed stably
            t = elog_theta[:, :, None] + elog_beta[None, :, :]
            tmax = t.max(dim=1).values
            lse = tmax + torch.log(torch.exp(t - tmax[:, None, :]).sum(dim=1))
            del t
            docs += torch.sum(xc * lse)
            # E[log p(theta | alpha) - log q(theta | gamma)]
            docs += torch.sum((alpha - gamma) * elog_theta)
            docs += torch.sum(torch.lgamma(gamma) - lg_alpha)
            docs += torch.sum(lg_alpha_k - torch.lgamma(gamma.sum(1)))
        score = float(docs)
        # E[log p(beta | eta) - log q(beta | lambda)]
        Elogbeta = elog_beta.cpu().numpy()
        score += float(((eta - self._lam) * Elogbeta).sum())
        score += float((gammaln(self._lam) - gammaln(eta)).sum())
        score += float((gammaln(eta * vocab)
                        - gammaln(self._lam.sum(1))).sum())
        return score

    def log_perplexity(self, frame) -> float:
        x = np.asarray(frame[self.get("featuresCol")], dtype=np.float64)
        tokens = float(x.sum())
        return -self.log_likelihood(frame) / max(tokens, 1.0)

    def _save_data(self, path: str) -> None:
        save_arrays(path, lam=self._lam,
                    meta=np.array([self._vocab_size, self._alpha, self._eta]))

    def _load_data(self, path: str, meta) -> None:
        arrs = load_arrays(path)
        self._lam = arrs["lam"]
        self._vocab_size = int(arrs["meta"][0])
        self._alpha = float(arrs["meta"][1])
        self._eta = float(arrs["meta"][2])
