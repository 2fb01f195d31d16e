"""Power iteration clustering (Lin & Cohen 2010).

The port's counterpart of ``cycloneml_tpu/ml/clustering/power_iteration.py``
(ref: ml/clustering/PowerIterationClustering.scala — ``assignClusters`` over
a (src, dst, weight) affinity frame; mllib/clustering/
PowerIterationClustering.scala:41):

- the vertex ids relabelled to [0, n) by ``np.unique`` and
  ``np.searchsorted`` (the labels the reference's dict gives), the edges
  mirrored, the rows of the affinity normalized by the degrees
  (W = D^-1 A), both initial vectors ("random" from ``RandomState(seed)``,
  "degree"), as the reference;
- one power-iteration step, sum over a vertex's edges of w/deg * v[dst]
  (the reference's ``jax.ops.segment_sum``), is kernel S2
  (``ops/kernels.ell_cols``) over a one-slot ELL of the 2|E| directed
  edges (index = src, value = w/deg[src], r = v[dst], d = n vertices),
  whose column copy (:func:`kernels.ell_columns`) is built once a call:
  each vertex's edges are summed in one fixed order, with no float atomics.
  S2 reads float32 values, so the card takes it only at a float32
  accumulator width; at float64 (``cyclone.compute.dtype=float64``) the
  step is the center sums (``ops/kernels.center_sums``, one cluster a
  vertex), which read float64 and sum in one fixed order too. The route
  follows the compute dtype (:func:`step_route`); with
  ``usePallasKernels=false``, or on the CPU, the step is S2's plain
  version (``index_add_``) at the accumulator width;
- the reference's acceleration stop |delta_t - delta_{t-1}| < 1e-5/n,
  tested on the device after each step (one scalar read back a step);
- the 1-D k-means of the embedding on the host (``_kmeans_1d``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.dataset.instance import compute_dtype
from cycloneml_tpu_torch.ml.param import ParamValidators as V
from cycloneml_tpu_torch.ml.shared import HasMaxIter, HasSeed, HasWeightCol
from cycloneml_tpu_torch.ops import kernels


class Embedding(NamedTuple):
    """The power iteration's result: the vertex ids (sorted), each
    vertex's value, and the steps taken."""
    ids: np.ndarray
    values: np.ndarray
    iterations: int


class PowerIterationClustering(HasMaxIter, HasSeed, HasWeightCol):
    """Not an Estimator (matches the reference): call
    :meth:`assign_clusters` on a frame of (src, dst, weight) edges."""

    def __init__(self, uid=None, **kwargs):
        super().__init__(uid)
        self._p_max_iter(20)
        self._p_seed(17)
        self._p_weight_col()
        self.k = self._param("k", "number of clusters (> 1)", V.gt(1), default=2)
        self.initMode = self._param(
            "initMode", "random or degree",
            V.in_array(["random", "degree"]), default="random")
        self.srcCol = self._param("srcCol", "source vertex id column",
                                  default="src")
        self.dstCol = self._param("dstCol", "destination vertex id column",
                                  default="dst")
        for key, v in kwargs.items():
            self.set(key, v)

    def set_k(self, v):
        return self.set("k", v)

    def set_max_iter(self, v):
        return self.set("maxIter", v)

    def assign_clusters(self, frame: MLFrame) -> MLFrame:
        rng = np.random.RandomState(self.get("seed"))
        emb = self._embedding(frame, rng)
        labels = _kmeans_1d(emb.values, self.get("k"), rng)
        return MLFrame(frame.ctx, {
            "id": emb.ids.astype(np.float64),
            "cluster": labels.astype(np.float64),
        })

    def _embedding(self, frame: MLFrame,
                   rng: np.random.RandomState) -> Embedding:
        """The graph of the frame's edges and its power iteration; ``rng``
        draws the random initial vector (and is then the 1-D k-means')."""
        src = np.asarray(frame[self.get("srcCol")], dtype=np.int64)
        dst = np.asarray(frame[self.get("dstCol")], dtype=np.int64)
        wcol = self.get("weightCol") or None
        w = (np.asarray(frame[wcol], dtype=np.float64) if wcol
             else np.ones(len(src)))
        if np.any(w < 0):
            raise ValueError("affinity weights must be non-negative")

        # relabel arbitrary ids to [0, n): their rank among the sorted ids
        ids = np.unique(np.concatenate([src, dst]))
        si = np.searchsorted(ids, src).astype(np.int32)
        di = np.searchsorted(ids, dst).astype(np.int32)
        n = len(ids)

        # symmetrize (ref requires a symmetric affinity; tolerate one-sided
        # input by mirroring edges)
        s2 = np.concatenate([si, di])
        d2 = np.concatenate([di, si])
        w2 = np.concatenate([w, w])

        deg = np.bincount(s2, weights=w2, minlength=n)
        if np.any(deg <= 0):
            raise ValueError("every vertex needs positive degree")

        if self.get("initMode") == "degree":
            v0 = deg / deg.sum()
        else:
            v0 = rng.rand(n) / n
        v0 = v0 / np.abs(v0).sum()

        ctx = frame.ctx
        dev = ctx.device
        dtype = compute_dtype(getattr(ctx, "conf", None))
        route = step_route(kernels.kernel_mode(ctx), dev, dtype)
        # the one-slot ELL of the directed edges: row e holds column src_e
        # with value w_e / deg[src_e]
        idx = torch.as_tensor(s2, device=dev)[:, None].contiguous()
        val = torch.as_tensor(w2 / deg[s2], device=dev).to(dtype)[:, None] \
            .contiguous()
        dj = torch.as_tensor(d2.astype(np.int64), device=dev)
        columns = kernels.ell_columns(idx, val, n) if route == S2 else None

        def step(v):
            r = v[dj]
            if route == S2:
                return kernels.ell_cols(idx, val, r, n, columns=columns) \
                    .to(dtype)
            if route == SUMS:
                return kernels.center_sums(val, val[:, 0] * r, idx[:, 0], n,
                                           with_sums=False)[1]
            return kernels.ell_cols_plain(idx, val, r, n)

        values, it = power_iterate(step, torch.as_tensor(v0, device=dev)
                                   .to(dtype), self.get("maxIter"), n)
        return Embedding(ids, values.cpu().double().numpy(), it)


S2, SUMS, PLAIN = "s2", "center_sums", "plain"


def step_route(mode: str, dev: torch.device, dtype: torch.dtype) -> str:
    """The kernel a power-iteration step launches for the kernel mode
    ``mode`` (``kernels.kernel_mode``), on ``dev`` at the accumulator
    width ``dtype``: :data:`S2` at float32 on CUDA, :data:`SUMS` (the
    center sums, which read float64) at float64 on CUDA, :data:`PLAIN`
    (``index_add_``) with ``mode`` 'false' or on the CPU. No route narrows
    the compute dtype."""
    if mode == "false" or torch.device(dev).type != "cuda":
        return PLAIN
    return S2 if dtype == torch.float32 else SUMS


def power_iterate(step, v: torch.Tensor, max_iter: int, n: int):
    """The power iteration from ``v``: ``nv = step(v)`` normalized to unit
    L1 norm, until ``max_iter`` steps or the reference's acceleration stop
    |delta_t - delta_{t-1}| < 1e-5/n (mllib PowerIterationClustering.
    powerIter; running to convergence would flatten v into the stationary
    distribution and erase the cluster structure). Returns ``(v, steps)``."""
    eps = 1e-5 / n
    prev_delta = torch.full((), float("inf"), dtype=v.dtype, device=v.device)
    diff = prev_delta
    i = 0
    while i < max_iter and bool(diff >= eps):
        nv = step(v)
        nv = nv / torch.clamp(torch.sum(torch.abs(nv)), min=1e-300)
        delta = torch.sum(torch.abs(nv - v))
        diff = torch.abs(delta - prev_delta)
        v, prev_delta, i = nv, delta, i + 1
    return v, i


def _kmeans_1d(v: np.ndarray, k: int, rng: np.random.RandomState) -> np.ndarray:
    """Host-side k-means on the 1-D embedding (k scalars << data size)."""
    uniq = np.unique(v)
    if len(uniq) <= k:
        lut = {val: i for i, val in enumerate(uniq)}
        return np.fromiter((lut[x] for x in v), np.int64, len(v))
    # k-means++ seeding
    centers = [v[rng.randint(len(v))]]
    d2 = (v - centers[0]) ** 2
    for _ in range(1, k):
        p = d2 / d2.sum()
        centers.append(v[rng.choice(len(v), p=p)])
        d2 = np.minimum(d2, (v - centers[-1]) ** 2)
    c = np.asarray(centers)
    for _ in range(50):
        a = np.abs(v[:, None] - c[None, :]).argmin(1)
        newc = np.array([v[a == j].mean() if np.any(a == j) else c[j]
                         for j in range(k)])
        if np.allclose(newc, c):
            break
        c = newc
    return np.abs(v[:, None] - c[None, :]).argmin(1)
