"""Single-pass multivariate summary statistics.

The port's counterpart of ``cycloneml_tpu/ml/stat/summarizer.py``: one pass
over the dataset computes every weighted moment — mean, unbiased weighted
variance (the reference's formula), count, numNonzeros, max, min, normL1,
normL2, sum and weightSum. Padding rows (w=0) are neutral in every
statistic, max/min included. Sums accumulate at w's dtype (the accumulator
tier), and X is upcast a chunk of rows at a time, so a bf16 X is never
copied whole at full width. On the fp8 rung the pass sums the e4m3 codes
(torch reduces no float8 tensor, and the upcast of a code is exact) and
``_finalize`` rescales every per-column statistic by the dataset's
``x_scale`` on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cycloneml_tpu_torch.dataset.dataset import InstanceDataset

ROW_CHUNK = 1 << 16


@dataclass
class SummaryStats:
    mean: np.ndarray
    variance: np.ndarray
    count: int
    num_nonzeros: np.ndarray
    max: np.ndarray
    min: np.ndarray
    norm_l1: np.ndarray
    norm_l2: np.ndarray
    sum: np.ndarray
    weight_sum: float

    @property
    def std(self) -> np.ndarray:
        return np.sqrt(self.variance)


class Summarizer:
    """The whole moment set comes from one pass; slice what you want from
    :class:`SummaryStats`."""

    @staticmethod
    def summarize(dataset: InstanceDataset) -> SummaryStats:
        # datasets are immutable, so the moments are a property of the
        # object: a re-fit on the same dataset skips the pass
        cached = getattr(dataset, "_summary_cache", None)
        if cached is not None:
            return cached
        agg = dataset.tree_aggregate_fn(_moments, auto_psum=False)
        out = _finalize(agg(), getattr(dataset, "x_scale", None))
        dataset._summary_cache = out
        return out

    @staticmethod
    def mean_std(dataset: InstanceDataset):
        s = Summarizer.summarize(dataset)
        return s.mean, s.std


def _moments(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
             chunk_rows: int = ROW_CHUNK):
    acc = w.dtype
    d = x.shape[1]
    dev = x.device

    def zeros(*shape):
        return torch.zeros(shape, dtype=acc, device=dev)

    s1, s2, nnz, l1 = zeros(d), zeros(d), zeros(d), zeros(d)
    wsum, w2, cnt = zeros(), zeros(), zeros()
    mx = torch.full((d,), -torch.inf, dtype=acc, device=dev)
    mn = torch.full((d,), torch.inf, dtype=acc, device=dev)
    for lo in range(0, x.shape[0], chunk_rows):
        xc = x[lo:lo + chunk_rows].to(acc)
        wc = w[lo:lo + chunk_rows]
        wcol = wc[:, None]
        present = wcol > 0
        s1 += torch.sum(wcol * xc, dim=0)
        s2 += torch.sum(wcol * xc * xc, dim=0)
        wsum += torch.sum(wc)
        w2 += torch.sum(wc * wc)
        cnt += torch.sum(present.to(acc))
        nnz += torch.sum((present & (xc != 0)).to(acc), dim=0)
        mx = torch.maximum(mx, torch.where(present, xc, -torch.inf).amax(0))
        mn = torch.minimum(mn, torch.where(present, xc, torch.inf).amin(0))
        l1 += torch.sum(wcol * xc.abs(), dim=0)
    return {"s1": s1, "s2": s2, "w": wsum, "w2": w2, "cnt": cnt, "nnz": nnz,
            "mx": mx, "mn": mn, "l1": l1}


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().double().numpy()


def _finalize(out, scale=None) -> SummaryStats:
    w = float(out["w"])
    s1, s2 = _host(out["s1"]), _host(out["s2"])
    mx, mn, l1 = _host(out["mx"]), _host(out["mn"]), _host(out["l1"])
    if scale is not None:
        # fp8 rung: the pass summed codes; the moments are those of the
        # quantized values codes * scale (the tier the fit trains on). nnz
        # is exact on codes, and positive scales keep max/min in order
        s1, s2 = s1 * scale, s2 * scale * scale
        mx, mn, l1 = mx * scale, mn * scale, l1 * scale
    mean = s1 / w
    # unbiased weighted variance — the reference's formula
    # (MultivariateOnlineSummarizer.variance): (s2 - w mean^2) w/(w - w2/w)
    denom = w - float(out["w2"]) / w
    if denom > 0:
        variance = np.maximum((s2 - w * mean * mean) / denom, 0.0)
    else:
        variance = np.zeros_like(mean)
    return SummaryStats(
        mean=mean, variance=variance, count=int(round(float(out["cnt"]))),
        num_nonzeros=_host(out["nnz"]), max=mx, min=mn, norm_l1=l1,
        norm_l2=np.sqrt(s2), sum=s1, weight_sum=w)
